"""Pipeline-parallel execution of the Onsets & Frames flagship models.

Counterpart of ``amt_tools_tpu/parallel/pp_flagship.py``: the O&F (V1,
V2, V2 with velocity) forward as a :func:`parallel.pp.pipeline_apply`
schedule, one stage per rank of a ``pipe`` dimension, head stages first
(``model.head_names``), the refinement (``'adjoin'``) last, since it reads
the heads.

JAX needs every SPMD stage to carry one structure, so its stages dispatch
by index (``lax.switch``) over zero-padded weight embeddings. Here each
rank builds its own stage from the model's own submodules: the head's
``AcousticModel``, its ``LanguageModel`` (``FastBiLSTM``: kernel B in the
forward, E and F when autograd records) where it has one, and its output
dense; the refinement's language model and dense. Nothing is padded, so
the logits are the sequential forward's.

The pipeline payload is a ``(microbatch, T, W)`` buffer laid out as
``[features | pitch | onsets | offsets | (velocity) | refined]``; each
stage fills its slice and hands the buffer to the next rank. The
refinement reads the heads' slices with the model's ``detach_heads``
stop-gradients (pitch never detached), in the sequential model's joint
order (onsets, offsets, pitch).
"""

import torch
import torch.nn as nn
from torch.func import functional_call

from .. import tools
from .mesh import _axis
from .pp import pipeline_apply

__all__ = ['flagship_stage_names', 'flagship_pipeline_params',
           'flagship_stage_fn', 'pack_pipeline_inputs',
           'unpack_pipeline_outputs', 'flagship_pipeline_forward']


def flagship_stage_names(model):
    """Pipeline stage order for an Onsets & Frames model.

    Head stages first (model.head_names), refinement ('adjoin') last.
    """

    return tuple(model.head_names) + ('adjoin',)


def _payload_layout(model, num_feats):
    """(column offsets per slice, total width) of the pipeline payload."""

    offsets = {'feats': 0}
    cursor = num_feats
    for name in flagship_stage_names(model):
        offsets[name] = cursor
        cursor += model.dim_out

    return offsets, cursor


class _Stage(nn.Module):
    """One stage over the model's own submodules: ``am``, ``lm`` and
    ``out`` of a head (the pitch head has no ``lm``), ``lm`` and ``out`` of
    the refinement."""

    def __init__(self, model, name):
        super().__init__()
        if getattr(model, 'fused_heads', False) or getattr(model, 'fused_lms',
                                                           False):
            raise ValueError('the pipeline stages are the per-head modules; '
                             'convert a fused model with models.'
                             'unfuse_acoustic_variables / '
                             'unfuse_lm_variables into a per-head one')
        self.name = name
        self.stage_names = flagship_stage_names(model)
        self.detach_heads = model.detach_heads
        self.dim_out = model.dim_out
        self.feats_shape = (model.dim_in, model.in_channels)
        self.offsets, _ = _payload_layout(model,
                                          model.dim_in * model.in_channels)

        if name != 'adjoin':
            self.am = getattr(model, f'{name}_am')
        if hasattr(model, f'{name}_lm'):
            self.lm = getattr(model, f'{name}_lm')
        self.out = getattr(model, f'{name}_out')

    def _slice(self, payload, name):
        start = self.offsets[name]

        return payload[..., start:start + self.dim_out]

    def _write(self, payload, value):
        start = self.offsets[self.name]

        return torch.cat([payload[..., :start], value.to(payload.dtype),
                          payload[..., start + self.dim_out:]], dim=-1)

    def forward(self, payload):
        if self.name == 'adjoin':
            def grab(name):
                x = self._slice(payload, name)
                return x.detach() if self.detach_heads and name != 'pitch' \
                    else x

            parts = [grab(n) for n in self.stage_names[:-1]
                     if n != 'velocity']
            # The sequential joint order: onsets(, offsets), pitch last
            h = self.lm(torch.cat(parts[1:] + parts[:1], dim=-1))
        else:
            width = self.feats_shape[0] * self.feats_shape[1]
            feats = payload[..., :width].reshape(payload.shape[:-1] +
                                                 self.feats_shape)
            h = self.am(feats)
            if hasattr(self, 'lm'):
                h = self.lm(h)

        return self._write(payload, self.out(h))


def flagship_pipeline_params(model):
    """Each stage's parameters, in stage order: ``{name: tensor}`` over the
    model's own submodules (``am.Conv_0.weight``, ``lm.FastBiLSTM_0.
    input_proj_fwd.weight``, ``out.Dense_0.bias``, ...), the tensors
    themselves, not copies."""

    return [dict(_Stage(model, name).named_parameters())
            for name in flagship_stage_names(model)]


def flagship_stage_fn(model, feats_shape, stage):
    """The stage function of stage index ``stage`` for ``pipeline_apply``:
    ``fn(params, payload) -> payload`` with ``params`` that stage's
    :func:`flagship_pipeline_params`.

    ``feats_shape``: the per-clip feature shape (T, F, C) the payload's
    feature slice unflattens to, the model's (F, C).
    """

    if tuple(feats_shape[1:]) != (model.dim_in, model.in_channels):
        raise ValueError(f'features of shape (T, F, C) = {tuple(feats_shape)} '
                         f'do not fit the model\'s F = {model.dim_in}, '
                         f'C = {model.in_channels}')

    module = _Stage(model, flagship_stage_names(model)[stage])

    def stage_fn(params, payload):
        return functional_call(module, params, (payload,))

    return stage_fn


def pack_pipeline_inputs(model, feats, num_micro):
    """(B, T, F, C) features -> (M, mb, T, W) zero-extended payload."""

    batch, frames = feats.shape[:2]
    if batch % num_micro:
        raise ValueError(f'batch {batch} not divisible into {num_micro} '
                         'microbatches')

    flat = feats.reshape(batch, frames, -1)
    _, width = _payload_layout(model, flat.shape[-1])
    pad = torch.zeros((batch, frames, width - flat.shape[-1]),
                      dtype=flat.dtype, device=flat.device)
    payload = torch.cat([flat, pad], dim=-1)

    return payload.reshape((num_micro, batch // num_micro) +
                           tuple(payload.shape[1:]))


def unpack_pipeline_outputs(model, payload, num_feats):
    """(M, mb, T, W) final payload -> the model's logits dict."""

    offsets, _ = _payload_layout(model, num_feats)
    dim_out = model.dim_out
    flat = payload.reshape((-1,) + tuple(payload.shape[2:]))

    def grab(name):
        return flat[..., offsets[name]:offsets[name] + dim_out]

    output = {tools.KEY_ONSETS: grab('onset'),
              tools.KEY_MULTIPITCH: grab('adjoin')}
    if 'offset' in offsets:
        output[tools.KEY_OFFSETS] = grab('offset')
    if 'velocity' in offsets:
        output[tools.KEY_VELOCITY] = grab('velocity')

    return output


def flagship_pipeline_forward(model, feats, mesh, num_micro, axis='pipe',
                              batch_axis=None):
    """Full pipelined forward: (B, T, F, C) features -> the model's logits
    dict, on every pipe rank.

    The sequential eval forward ``model(feats)`` (the model is put in eval
    mode), computed one stage per rank over the ``axis`` dimension, which
    must have one rank per stage, with ``num_micro`` GPipe microbatches.
    Differentiable end to end (the ``detach_heads`` stop-gradients of the
    refinement included). With ``batch_axis`` the features are this
    rank's rows of a batch sharded over that dimension, and so are the
    logits.
    """

    names = flagship_stage_names(model)
    _, size, stage = _axis(mesh, axis)
    if size != len(names):
        raise ValueError(f'{type(model).__name__} runs {len(names)} stages '
                         f'{names}, but mesh axis "{axis}" has {size} '
                         f'devices — one stage per device is required.')

    model.eval()
    params = flagship_pipeline_params(model)[stage]
    stage_fn = flagship_stage_fn(model, feats.shape[1:], stage)

    payload = pack_pipeline_inputs(model, feats, num_micro)
    payload = pipeline_apply(params, payload, stage_fn, mesh, axis=axis,
                             batch_axis=batch_axis)

    return unpack_pipeline_outputs(model, payload,
                                   feats.shape[2] * feats.shape[3])
