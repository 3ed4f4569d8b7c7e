"""Flax variables -> the port's ``state_dict``.

The port's modules carry the Flax tree's names (``pitch_am.Conv_0``,
``onset_lm.FastBiLSTM_0.input_proj_fwd``, ``adjoin_out.Dense_0``,
``conv1``, ``tablature_out.Dense_0``, ...), so the conversion walks the tree
and changes only leaf names and layouts:

- ``params/.../kernel`` of a conv, (kh, kw, Cin, Cout) HWIO -> ``weight``
  (Cout, Cin, kh, kw) OIHW, with the port's image axes in the Flax order
  (O&F: H = time, W = frequency; TabCNN: H = frequency, W = time);
- ``params/.../kernel`` of a dense, (in, out) -> ``weight`` (out, in);
- ``params/.../scale`` of a batch norm -> ``weight``; ``bias`` stays;
- ``batch_stats/.../mean`` and ``var`` -> ``running_mean``, ``running_var``;
- ``quant_stats/.../act_amax`` (the calibrated scales of static int8
  layers) -> the layer's ``act_amax`` buffer, a scalar;
- ``recurrent_kernel_{fwd,bwd}`` keep their (H, 4H) layout (gate order
  i, f, g, o), which is what the LSTM kernel reads.

The fused layouts' trees convert by the same rules: a grouped conv kernel
(kh, kw, Cin/G, Cout) becomes (Cout, Cin/G, kh, kw), the layout of
``nn.Conv2d(groups=G)``; the grouped stack's ``head_kernels`` (H, K, D)
and ``head_bias`` and the grouped BiLSTM's stacked leaves
(``input_proj_{fwd,bwd}_kernel`` (S, E, 4H), ``..._bias``,
``recurrent_kernel_{fwd,bwd}`` (S, H, 4H)) keep JAX's layout, which the
port's modules store.

The AcousticModel's flatten ahead of ``Dense_0`` and TabCNN's ahead of
``dense1`` are feature-major in both packages (the port permutes its NCHW
activations back to (B, T, F', C) before the reshape), so the dense rows
need no permutation.
"""

import numpy as np
import torch

__all__ = ['from_flax']

_STAT_NAMES = {'mean': 'running_mean', 'var': 'running_var'}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, 'items'):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _param(name, value):
    if name == 'kernel':
        if value.ndim == 4:
            return 'weight', value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return 'weight', value.T
        raise ValueError(f'unexpected kernel rank {value.ndim}')
    if name == 'scale':
        return 'weight', value

    return name, value


def from_flax(variables):
    """Convert ``{'params': ..., 'batch_stats': ..., 'quant_stats': ...}``
    nested dicts of arrays into a ``state_dict`` of float32 CPU tensors for
    the port's model."""

    state = {}
    for collection, tree in variables.items():
        if collection not in ('params', 'batch_stats', 'quant_stats'):
            raise ValueError(f'unsupported variable collection {collection!r}')

        for path, value in _leaves(tree):
            value = np.array(value, dtype=np.float32)
            *modules, name = path

            if collection == 'params':
                name, value = _param(name, value)
            elif collection == 'batch_stats':
                name = _STAT_NAMES[name]

            key = '.'.join(modules + [name])
            # ascontiguousarray makes a 0-d scale 1-d; keep its shape
            state[key] = torch.from_numpy(
                np.ascontiguousarray(value).reshape(value.shape))

    return state
