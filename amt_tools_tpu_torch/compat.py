"""Migrate reference (cwitkowitz/amt-tools, torch) checkpoints to the port.

Counterpart of ``amt_tools_tpu/compat.py`` (``port_reference_checkpoint``,
``port_onsetsframes_state_dict``, ``port_tabcnn_state_dict``). A reference
user switching over brings trained weights; this module turns them into a
``state_dict`` of the port's modules (``model.load_state_dict(...)``).

Input is a plain torch ``state_dict`` — a flat mapping from the
reference's parameter paths (e.g. ``onset_head.0.layer1.0.weight``) to
tensors — so the reference package does NOT need to be importable:
``torch.save(model)`` pickles from the reference load fine wherever the
reference is installed, and ``model.state_dict()`` (or a saved
state_dict) is all this module needs. Tensor values may be torch tensors
or numpy arrays.

The port's modules carry the JAX package's Flax names, so the reference
layouts go through the Flax tree the JAX package builds (its own copy
here: the port imports nothing of the JAX package) and then
``weights.from_flax``; the result equals the JAX ``compat`` followed by
``weights.from_flax`` bit for bit. Layout conversions handled (reference
``amt_tools/models``):

- conv kernels OIHW -> HWIO -> the port's OIHW in the Flax image axes
  (``onsetsframes.py:383-412``);
- channel-major flatten -> feature-major flatten for the dense layers fed
  by conv stacks (torch flattens ``(C, *spatial)``; the port flattens
  ``(*spatial, C)`` as the JAX package does; ``onsetsframes.py:452-455``,
  ``tabcnn.py:174-176``);
- fused torch LSTM gates -> hoisted input projections + recurrent kernel
  (same [i, f, g, o] gate order; ``onsetsframes.py:466-503`` vs
  ``ops/lstm.py``);
- BatchNorm running statistics -> the BatchNorms' running buffers.
"""

import numpy as np

from .weights import from_flax

__all__ = ['port_reference_checkpoint', 'port_onsetsframes_state_dict',
           'port_tabcnn_state_dict']


def _np(value):
    """torch tensor / array-like -> float32 numpy array."""

    if hasattr(value, 'detach'):
        value = value.detach().cpu().numpy()

    return np.asarray(value, dtype=np.float32)


def _linear(sd, prefix):
    return {'kernel': _np(sd[f'{prefix}.weight']).T,
            'bias': _np(sd[f'{prefix}.bias'])}


def _conv(sd, prefix):
    return {'kernel': _np(sd[f'{prefix}.weight']).transpose(2, 3, 1, 0),
            'bias': _np(sd[f'{prefix}.bias'])}


def _batchnorm(sd, prefix):
    params = {'scale': _np(sd[f'{prefix}.weight']),
              'bias': _np(sd[f'{prefix}.bias'])}
    stats = {'mean': _np(sd[f'{prefix}.running_mean']),
             'var': _np(sd[f'{prefix}.running_var'])}

    return params, stats


def _channel_major_linear(sd, prefix, channels, *spatial):
    """A Linear consuming torch's channel-major conv flatten -> NHWC order."""

    weight = _np(sd[f'{prefix}.weight'])  # (out, C * prod(spatial))
    out_dim = weight.shape[0]

    weight = weight.reshape((out_dim, channels) + spatial)
    perm = tuple(range(2, 2 + len(spatial))) + (1, 0)

    return {'kernel': weight.transpose(perm).reshape(-1, out_dim),
            'bias': _np(sd[f'{prefix}.bias'])}


def _lstm_direction(sd, prefix, reverse):
    sfx = '_reverse' if reverse else ''

    w_ih = _np(sd[f'{prefix}.weight_ih_l0{sfx}'])
    w_hh = _np(sd[f'{prefix}.weight_hh_l0{sfx}'])
    b_ih = _np(sd[f'{prefix}.bias_ih_l0{sfx}'])
    b_hh = _np(sd[f'{prefix}.bias_hh_l0{sfx}'])

    return {'kernel': w_ih.T, 'bias': b_ih + b_hh}, w_hh.T


def _language_model(sd, prefix):
    proj_f, rec_f = _lstm_direction(sd, f'{prefix}.mlm', reverse=False)
    proj_b, rec_b = _lstm_direction(sd, f'{prefix}.mlm', reverse=True)

    return {'FastBiLSTM_0': {'input_proj_fwd': proj_f,
                             'input_proj_bwd': proj_b,
                             'recurrent_kernel_fwd': rec_f,
                             'recurrent_kernel_bwd': rec_b}}


def _acoustic_model(sd, prefix):
    """Reference ``AcousticModel`` subtree -> (params, batch stats)."""

    params, stats = {}, {}

    for i, layer in enumerate(('layer1', 'layer2', 'layer3')):
        params[f'Conv_{i}'] = _conv(sd, f'{prefix}.{layer}.0')
        bn_params, bn_stats = _batchnorm(sd, f'{prefix}.{layer}.1')
        params[f'BatchNorm_{i}'] = bn_params
        stats[f'BatchNorm_{i}'] = bn_stats

    channels = params['Conv_2']['kernel'].shape[-1]
    in_features = _np(sd[f'{prefix}.fc1.0.weight']).shape[1]
    params['Dense_0'] = _channel_major_linear(
        sd, f'{prefix}.fc1.0', channels, in_features // channels)

    return params, stats


def _onsetsframes_variables(state_dict):
    """Reference ``OnsetsFrames``/``OnsetsFrames2`` state_dict -> Flax tree.

    Head layout (reference ``onsetsframes.py:46-65, 218-227``):
    ``onset_head = [AM, LM, bank]``, ``pitch_head = [AM, bank]``,
    ``adjoin = [LM, bank]``, and (V2) ``offset_head = [AM, LM, bank]`` —
    detected from the keys, so both model versions port with one call.
    """

    sd = dict(state_dict)
    params, stats = {}, {}

    def add_am(name, prefix):
        p, s = _acoustic_model(sd, prefix)
        params[f'{name}_am'] = p
        stats[f'{name}_am'] = s

    add_am('onset', 'onset_head.0')
    params['onset_lm'] = _language_model(sd, 'onset_head.1')
    params['onset_out'] = {'Dense_0': _linear(sd, 'onset_head.2.output_layer')}

    add_am('pitch', 'pitch_head.0')
    params['pitch_out'] = {'Dense_0': _linear(sd, 'pitch_head.1.output_layer')}

    params['adjoin_lm'] = _language_model(sd, 'adjoin.0')
    params['adjoin_out'] = {'Dense_0': _linear(sd, 'adjoin.1.output_layer')}

    if any(key.startswith('offset_head.') for key in sd):
        add_am('offset', 'offset_head.0')
        params['offset_lm'] = _language_model(sd, 'offset_head.1')
        params['offset_out'] = {'Dense_0': _linear(sd,
                                                   'offset_head.2.output_layer')}

    return {'params': params, 'batch_stats': stats}


def _tabcnn_variables(state_dict, dim_in, frame_width=9):
    """Reference ``TabCNN`` state_dict -> Flax tree.

    ``conv = [Conv, ReLU, Conv, ReLU, Conv, ReLU, pool, drop]``,
    ``dense = [Linear, ReLU, drop, SoftmaxGroups]`` (reference
    ``tabcnn.py:100-131``). ``dim_in``/``frame_width`` identify the conv
    output geometry the dense layer's channel-major flatten was built on
    (``tabcnn.py:66-69``).
    """

    sd = dict(state_dict)

    params = {f'conv{i + 1}': _conv(sd, f'conv.{j}')
              for i, j in enumerate((0, 2, 4))}

    channels = params['conv3']['kernel'].shape[-1]
    height = (dim_in - 6) // 2
    width = (frame_width - 6) // 2

    params['dense1'] = _channel_major_linear(sd, 'dense.0', channels,
                                             height, width)
    params['tablature_out'] = {'Dense_0': _linear(sd,
                                                  'dense.3.output_layer')}

    return {'params': params}


def port_onsetsframes_state_dict(state_dict):
    """Reference ``OnsetsFrames``/``OnsetsFrames2`` state_dict -> the port
    model's ``state_dict`` (the reference's heads detected from its keys,
    so both model versions port with one call)."""

    return from_flax(_onsetsframes_variables(state_dict))


def port_tabcnn_state_dict(state_dict, dim_in, frame_width=9):
    """Reference ``TabCNN`` state_dict -> the port model's ``state_dict``;
    ``dim_in``/``frame_width`` identify the conv output geometry of the
    dense layer's channel-major flatten."""

    return from_flax(_tabcnn_variables(state_dict, dim_in, frame_width))


def port_reference_checkpoint(model, source):
    """Port a reference checkpoint for ``model`` (the migration one-liner).

    Parameters
    ----------
    model : TranscriptionModel
        The port's target model (``OnsetsFrames``, ``OnsetsFrames2`` or
        ``TabCNN``) whose architecture hyperparameters match the source's.
    source : str | mapping | torch.nn.Module
        A path to a torch checkpoint (``torch.save`` of either the whole
        reference model or its state_dict), an in-memory state_dict, or a
        live torch module.

    Returns
    -------
    dict
        The port model's ``state_dict`` (float32 CPU tensors) for
        ``model.load_state_dict``.
    """

    from .models import OnsetsFrames, TabCNN
    from .models.onsetsframes import OnsetsFramesOnline

    if isinstance(source, str):
        import torch

        source = torch.load(source, map_location='cpu', weights_only=False)

    if hasattr(source, 'state_dict'):
        source = source.state_dict()

    if isinstance(model, TabCNN):
        return port_tabcnn_state_dict(source, dim_in=model.dim_in,
                                      frame_width=model.frame_width)

    if isinstance(model, OnsetsFrames):
        # Fail HERE with a reason, not later inside load_state_dict with an
        # opaque missing-key error: these configs change the target
        # parameter tree away from anything the reference can provide.
        if isinstance(model, OnsetsFramesOnline):
            raise ValueError(
                'reference checkpoints hold bidirectional language models; '
                'OnsetsFramesOnline uses unidirectional streaming LSTMs, so '
                'there is nothing to port the backward direction into. Port '
                'into the offline model and retrain/finetune the online one.')
        if getattr(model, 'fused_heads', False):
            raise ValueError(
                'port into a fused_heads=False model, then convert with '
                'models.fuse_acoustic_variables (the reference stores '
                'per-head acoustic stacks).')
        if getattr(model, 'estimate_velocity', False):
            raise ValueError(
                'the reference has no velocity stack (its TODO at '
                'onsetsframes.py:13); port into estimate_velocity=False or '
                'initialize the velocity head separately and merge.')
        if getattr(model, 'fused_lms', False):
            raise ValueError(
                'port into a fused_lms=False model, then convert with '
                'models.fuse_lm_variables (the reference stores per-head '
                'language models).')

        return port_onsetsframes_state_dict(source)

    raise TypeError(f'no reference checkpoint porting for '
                    f'{type(model).__name__}')
