"""LSTM layers with hoisted input projections.

Counterparts of ``amt_tools_tpu/ops/lstm.py`` ``FastLSTM`` (``:208``) and
``FastBiLSTM`` (``:260``) on their whole-sequence path (no mask, zero
carry): the input projection for every step is one ``nn.Linear`` over
(B, T, E), and the recurrence runs in the Hopper kernels on CUDA tensors:
:func:`ops.lstm_kernel.lstm_scan` (kernel B) when nothing differentiates
it, :func:`ops.lstm_kernel.lstm_scan_grad` (kernels E and F) when autograd
records, as ``lstm_scan_pallas_grad`` forwards to ``lstm_scan_pallas``
outside ``jax.grad``. Parameter names match the Flax tree
(``input_proj[_fwd|_bwd]``, ``recurrent_kernel[_fwd|_bwd]`` in the (H, 4H)
layout, gate order i, f, g, o).
"""

import torch
import torch.nn as nn

from .layers import lecun_normal_, linear, orthogonal_
from .lstm_kernel import lstm_scan, lstm_scan_grad

__all__ = ['FastLSTM', 'FastBiLSTM']


def _reset_projection(layer, generator):
    lecun_normal_(layer.weight, layer.in_features, generator)
    nn.init.zeros_(layer.bias)


def _recurrence(xw, w_h, reverse=False):
    # The Pallas path's compute dtype: bf16 projections keep a bf16 W_h,
    # anything else runs in float32
    dtype = torch.bfloat16 if xw.dtype == torch.bfloat16 else torch.float32
    xw = xw.to(dtype).contiguous()

    if torch.is_grad_enabled() and (xw.requires_grad or w_h.requires_grad):
        # W_h goes in uncast: the Function casts it, so dW_h reaches the
        # float32 parameter unrounded
        return lstm_scan_grad(xw, w_h, reverse)

    return lstm_scan(xw, w_h.to(dtype).contiguous(), reverse=reverse)


class FastLSTM(nn.Module):
    """Unidirectional LSTM: (B, T, E) -> (B, T, H)."""

    def __init__(self, input_size, features, dtype=None, generator=None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.input_proj = nn.Linear(input_size, 4 * features)
        self.recurrent_kernel = nn.Parameter(torch.empty(features, 4 * features))

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        _reset_projection(self.input_proj, generator)
        orthogonal_(self.recurrent_kernel, generator)

    def forward(self, inputs):
        xw = linear(inputs, self.input_proj, self.dtype)

        return _recurrence(xw, self.recurrent_kernel)


class FastBiLSTM(nn.Module):
    """Bidirectional LSTM: (B, T, E) -> (B, T, 2H), [forward | backward]."""

    def __init__(self, input_size, features, dtype=None, generator=None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.input_proj_fwd = nn.Linear(input_size, 4 * features)
        self.input_proj_bwd = nn.Linear(input_size, 4 * features)
        self.recurrent_kernel_fwd = nn.Parameter(
            torch.empty(features, 4 * features))
        self.recurrent_kernel_bwd = nn.Parameter(
            torch.empty(features, 4 * features))

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        _reset_projection(self.input_proj_fwd, generator)
        _reset_projection(self.input_proj_bwd, generator)
        orthogonal_(self.recurrent_kernel_fwd, generator)
        orthogonal_(self.recurrent_kernel_bwd, generator)

    def forward(self, inputs):
        xw_f = linear(inputs, self.input_proj_fwd, self.dtype)
        xw_b = linear(inputs, self.input_proj_bwd, self.dtype)

        out_f = _recurrence(xw_f, self.recurrent_kernel_fwd)
        out_b = _recurrence(xw_b, self.recurrent_kernel_bwd, reverse=True)

        return torch.cat([out_f, out_b], dim=-1)
