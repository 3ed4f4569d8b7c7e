"""Flax layer semantics the port's modules share: dtype promotion and init.

The JAX models compute in ``dtype`` (e.g. bf16) while their parameters stay
float32: Flax's ``Dense`` and ``Conv`` cast inputs, kernel and bias to
``dtype`` before the product, and ``BatchNorm`` normalizes in float32 and
casts its result. These helpers give ``nn.Linear``/``nn.Conv2d`` weights the
same treatment, and initialize parameters like Flax's defaults from an
explicit ``torch.Generator``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ['linear', 'conv2d_same', 'BatchNorm', 'lecun_normal_', 'orthogonal_']


def _compute_dtype(x, dtype):
    return x.dtype if dtype is None else dtype


def linear(x, layer, dtype=None):
    """``layer`` (an ``nn.Linear``) applied in ``dtype`` (default: x's)."""

    dtype = _compute_dtype(x, dtype)

    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def conv2d_same(x, layer, dtype=None):
    """``layer`` (an odd-kernel ``nn.Conv2d``) with SAME padding in ``dtype``."""

    dtype = _compute_dtype(x, dtype)
    padding = tuple(k // 2 for k in layer.kernel_size)

    return F.conv2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype),
                    padding=padding)


class BatchNorm(nn.Module):
    """Inference-mode batch norm over channel dim 1, Flax's arithmetic.

    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast to
    ``dtype`` (default: x's). Parameter names follow ``nn.BatchNorm2d``.
    """

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x, dtype=None):
        dtype = _compute_dtype(x, dtype)
        shape = (1, -1) + (1,) * (x.dim() - 2)

        mul = torch.rsqrt(self.running_var + self.eps) * self.weight

        # One float32 buffer updated in place: at serving shapes the
        # activation is ~10 GB in float32
        y = x.to(torch.float32, copy=True)
        y.sub_(self.running_mean.view(shape)).mul_(mul.view(shape))
        y.add_(self.bias.view(shape))

        return y.to(dtype)


def lecun_normal_(tensor, fan_in, generator):
    """Flax's default kernel init: truncated normal, variance 1 / fan_in."""

    # Flax divides by the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def orthogonal_(tensor, generator):
    """Flax's recurrent-kernel init: a matrix with orthonormal rows."""

    with torch.no_grad():
        return nn.init.orthogonal_(tensor, generator=generator)
