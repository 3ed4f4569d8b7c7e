"""Bidirectional GRU layers with hoisted input projections.

:class:`BiGRU` holds ``torch.nn.GRU(batch_first=True, bidirectional=True)``'s
parameters under its names (``weight_ih_l{k}``, ``weight_hh_l{k}``,
``bias_ih_l{k}``, ``bias_hh_l{k}`` and their ``_reverse`` twins; gate rows
r, z, n), drawn as its default does, and computes its forward: each layer's
output is [forward | backward] over (B, T, 2H).

:func:`bigru_layers` runs several BiGRUs of one depth and width side by
side, layer by layer: each layer of all S of them is one grouped recurrence
of 2S sequences (the forward directions first, then the backward ones,
reversed) through ``ops.gru_kernel``. A layer's input projections are one
GEMM a direction, written into the grouped launch's slab of ``xw``; they
hold ``b_ih`` and the hidden biases of the r and z gates, which add to the
input's before any product reads them (``b_hn`` stays apart: the reset gate
multiplies it). In eval on CUDA, where autograd does not record, the
recurrence is one launch of kernel G, which raises for a width it does not
take (``gru_kernel.gru_supported``); on the CPU it is the op's plain
version, and where autograd records it is the plain version itself, which
is differentiable. Each grouped layer opens the span
``amt.gru`` (``profiling.span``).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import profiling
from .gru_kernel import gru_scan_grouped, gru_scan_plain
from .layers import records

__all__ = ['BiGRU', 'bigru_layers']

_SUFFIXES = ('', '_reverse')


class BiGRU(nn.Module):
    """A ``num_layers`` bidirectional GRU of ``hidden_size`` units a
    direction over (B, T, ``input_size``) -> (B, T, 2 ``hidden_size``),
    computing in ``dtype`` (default: the input's) with float32 parameters.
    ``generator`` draws the initial values, uniform over ±1/sqrt(H), as
    ``torch.nn.GRU`` draws them."""

    def __init__(self, input_size, hidden_size, num_layers=1, dtype=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        bound = 1.0 / math.sqrt(hidden_size)
        three_h = 3 * hidden_size
        for layer in range(num_layers):
            dim_in = input_size if layer == 0 else 2 * hidden_size
            for suffix in _SUFFIXES:
                for name, shape in (('weight_ih', (three_h, dim_in)),
                                    ('weight_hh', (three_h, hidden_size)),
                                    ('bias_ih', (three_h,)),
                                    ('bias_hh', (three_h,))):
                    value = torch.empty(shape)
                    with torch.no_grad():
                        value.uniform_(-bound, bound, generator=generator)
                    setattr(self, f'{name}_l{layer}{suffix}',
                            nn.Parameter(value))

    def layer_parameters(self, layer, suffix):
        """(weight_ih, weight_hh, bias_ih, bias_hh) of one direction."""

        return tuple(getattr(self, f'{name}_l{layer}{suffix}')
                     for name in ('weight_ih', 'weight_hh', 'bias_ih',
                                  'bias_hh'))

    def forward(self, inputs):
        return bigru_layers([self], [inputs])[0]


def _projection_bias(bias_ih, bias_hh, hidden):
    """``b_ih`` plus the hidden biases of the r and z gates (float32)."""

    return torch.cat([bias_ih[:2 * hidden] + bias_hh[:2 * hidden],
                      bias_ih[2 * hidden:]])


def _layer(grus, layer, inputs, dtype):
    """Layer ``layer`` of every BiGRU of ``grus`` over its (B, T, E) input,
    as one grouped recurrence -> their (B, T, 2H) outputs."""

    streams = len(grus)
    hidden = grus[0].hidden_size
    batch, frames, _ = inputs[0].shape
    recorded = records(*inputs, *(p for gru in grus
                                  for p in gru.parameters()))
    directions = [(gru, x, gru.layer_parameters(layer, suffix))
                  for suffix in _SUFFIXES for gru, x in zip(grus, inputs)]

    if recorded:
        xw = torch.stack([
            F.linear(x.to(dtype), w_ih.to(dtype),
                     _projection_bias(b_ih, b_hh, hidden).to(dtype))
            for _, x, (w_ih, _, b_ih, b_hh) in directions])
    else:
        # One GEMM a direction, into its slab of the grouped launch
        xw = torch.empty((2 * streams, batch, frames, 3 * hidden), dtype=dtype,
                         device=inputs[0].device)
        for slab, (_, x, (w_ih, _, b_ih, b_hh)) in zip(xw, directions):
            torch.addmm(_projection_bias(b_ih, b_hh, hidden).to(dtype),
                        x.reshape(-1, x.shape[-1]).to(dtype),
                        w_ih.t().to(dtype),
                        out=slab.view(batch * frames, 3 * hidden))
    w_h = torch.stack([w_hh.t().to(dtype)
                       for _, _, (_, w_hh, _, _) in directions]).contiguous()
    b_hn = torch.stack([b_hh[2 * hidden:].float()
                        for _, _, (_, _, _, b_hh) in directions]).contiguous()

    if recorded:
        out = gru_scan_plain(xw, w_h, b_hn, streams)
    else:
        out = gru_scan_grouped(xw, w_h, b_hn, streams)

    return [torch.cat([out[s], out[streams + s]], dim=-1)
            for s in range(streams)]


def bigru_layers(grus, inputs):
    """S :class:`BiGRU` modules of one depth and width over their (B, T,
    E_s) inputs (one batch and length) -> their (B, T, 2H) outputs; each
    layer of all S runs as one grouped recurrence inside ``amt.gru``. The
    compute dtype is the first module's (default: its input's): bf16
    projections run kernel G in bf16, anything else in float32."""

    if len({(gru.hidden_size, gru.num_layers) for gru in grus}) != 1:
        raise ValueError('bigru_layers takes BiGRUs of one width and depth')
    dtype = grus[0].dtype or inputs[0].dtype
    dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32

    outputs = list(inputs)
    for layer in range(grus[0].num_layers):
        with profiling.span('amt.gru'):
            outputs = _layer(grus, layer, outputs, dtype)

    return outputs
