"""Eval epilogue of a conv block: conv bias, BatchNorm with running
statistics, ReLU and an optional (1, 2) max- or average pool, as one Hopper
kernel.

No TPU kernel stands behind it: the JAX package leaves this chain to XLA,
which fuses it. The port ran it eagerly, as eight passes over the
activation (``ops.layers.BatchNorm`` makes a float32 copy, updates it in
place three times and casts it back), which made it the largest share of
the O&F acoustic stacks' eval forward. ``ops.layers.conv_block`` runs the
conv without its bias and hands its output here; the High-resolution Piano
Transcription model's convs have no bias (``conv_bias`` None), and its
blocks average-pool (``avg``).

:func:`conv_epilogue` launches ``csrc/conv_epilogue.cu`` for CUDA tensors
and runs :func:`conv_epilogue_plain`, the eager ops, for CPU tensors; on
the card the kernel gives the plain version's bits. Both go through the
custom op
``torch.ops.amt_tools_tpu_torch.conv_epilogue`` (:data:`conv_epilogue_op`);
:func:`cost` is its byte count.
"""

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ['conv_epilogue', 'conv_epilogue_op', 'conv_epilogue_plain',
           'batch_norm_eval', 'cost']

_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 +
             [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p])
_ENTRIES = {torch.float32: 'conv_epilogue_f32',
            torch.bfloat16: 'conv_epilogue_bf16'}
_SIGNATURES = {entry: _ARGTYPES for entry in _ENTRIES.values()}

# (device, dtype, channels) -> the -0.0 conv bias of a bias-free conv
_NO_BIAS = {}


def batch_norm_eval(x, running_mean, mul, bias, dtype):
    """Eval BatchNorm's arithmetic over channel dim 1, as Flax takes it:
    ``(x - running_mean) * mul + bias`` in float32, ``mul = rsqrt(running_var
    + eps) * scale``, cast to ``dtype``. One float32 copy updated in place:
    at the serving shapes the activation is ~10 GB in float32."""

    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = x.to(torch.float32, copy=True)
    y.sub_(running_mean.view(shape)).mul_(mul.view(shape))
    y.add_(bias.view(shape))

    return y.to(dtype)


def conv_epilogue_plain(x, conv_bias, running_mean, mul, bias, pool,
                        avg=False):
    """(B, C, T, F) conv output without its bias -> ReLU of the eval
    BatchNorm of ``x + conv_bias`` (of x where ``conv_bias`` is None),
    pooled over (1, 2) pairs of F with ``pool``, by their maximum, or by
    their mean with ``avg``: the eager ops, in x's dtype."""

    if conv_bias is not None:
        x = x + conv_bias.view(1, -1, 1, 1)
    y = F.relu(batch_norm_eval(x, running_mean, mul, bias, x.dtype))
    if not pool:
        return y

    return (F.avg_pool2d(y, (1, 2), stride=(1, 2)) if avg else
            F.max_pool2d(y, (1, 2), stride=(1, 2)))


def _check_inputs(x, conv_bias, running_mean, mul, bias, pool):
    tensors = {'x': x, 'conv_bias': conv_bias, 'running_mean': running_mean,
               'mul': mul, 'bias': bias}
    cuda_build.require_plain('conv_epilogue', **tensors)
    if x.dim() != 4:
        raise ValueError(f'x must be (B, C, T, F), got shape '
                         f'{tuple(x.shape)}')
    if x.dtype not in _ENTRIES or (conv_bias is not None and
                                   conv_bias.dtype != x.dtype):
        raise TypeError(f'conv_epilogue takes a float32 or bf16 x and a '
                        f'conv bias of its dtype, got {x.dtype} and '
                        f'{getattr(conv_bias, "dtype", None)}')
    channels = x.shape[1]
    for name, t in tensors.items():
        if name == 'x' or t is None:
            continue
        if t.shape != (channels,):
            raise ValueError(f'{name} must be ({channels},), got '
                             f'{tuple(t.shape)}')
        if name != 'conv_bias' and t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if t.device != x.device:
            raise ValueError(f'x on {x.device} but {name} on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'conv_epilogue takes a contiguous {name}')
    if not (x.is_contiguous() or
            x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError('conv_epilogue takes an x contiguous as NCHW or '
                         'as channels-last')
    if pool and x.shape[-1] < 2:
        raise ValueError(f'a (1, 2) pool needs a width of 2 or more, got '
                         f'{x.shape[-1]}')


def cost(shape, dtype, pool, conv_bias=True):
    """``(flops, bytes)`` of one launch on a (B, C, T, F) input: x read and
    the output written once each, and the per-channel vectors (three
    without a conv bias). No FLOPs: ``FlopCounterMode`` counts none for the
    eager elementwise ops this replaces, and the models' FLOP counts leave
    them out. An average pool reads and writes what a max-pool does, so
    ``pool`` counts either."""

    batch, channels, frames, width = shape
    size = dtype.itemsize
    rows = batch * channels * frames
    values = rows * (width + (width // 2 if pool else width))

    return 0.0, float(size * values +
                      ((size if conv_bias else 0) + 12) * channels)


def _channels_last(x):
    """Whether x lies in memory as (B, T, F, C). A tensor that is both
    (C = 1, or T = F = 1) counts as NCHW: the two orders are then one."""

    return (not x.is_contiguous() and
            x.is_contiguous(memory_format=torch.channels_last))


def _empty_out(x, pool):
    """The output, in x's dtype and memory layout."""

    batch, channels, frames, width = x.shape
    layout = (torch.channels_last if _channels_last(x) else
              torch.contiguous_format)

    return torch.empty((batch, channels, frames,
                        width // 2 if pool else width), dtype=x.dtype,
                       device=x.device, memory_format=layout)


def _launch(x, conv_bias, running_mean, mul, bias, pool, avg):
    """The kernel on CUDA tensors; counts the launch."""

    if x.device.type != 'cuda':
        raise ValueError(f'conv_epilogue runs on CUDA or CPU tensors, not '
                         f'{x.device}')

    batch, channels, frames, width = x.shape
    out = _empty_out(x, pool)
    if out.numel() == 0:
        return out

    if conv_bias is None:
        # Adding -0.0 leaves every value as it is, signed zeros included
        conv_bias = cuda_build.cached(
            _NO_BIAS, (x.device, x.dtype, channels),
            lambda: torch.full((channels,), -0.0, dtype=x.dtype,
                               device=x.device))
    lib = cuda_build.library('conv_epilogue', _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        # The kernel's pool: 0 none, 1 max, 2 average
        status = getattr(lib, _ENTRIES[x.dtype])(
            int(pool) * (2 if avg else 1), int(_channels_last(x)),
            x.data_ptr(), conv_bias.data_ptr(),
            running_mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
            out.data_ptr(), batch, channels, frames, width, stream)
    cuda_build.check(status, 'conv_epilogue')
    cuda_build.count(conv_epilogue, 'launches')

    return out


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::conv_epilogue',
                         mutates_args=())
def conv_epilogue_op(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                     running_mean: torch.Tensor, mul: torch.Tensor,
                     bias: torch.Tensor, pool: bool,
                     avg: bool = False) -> torch.Tensor:
    """The epilogue as an op: the launch on CUDA tensors, the plain version
    on CPU tensors (inputs as :func:`conv_epilogue` checks them)."""

    if x.device.type == 'cpu':
        return conv_epilogue_plain(x, conv_bias, running_mean, mul, bias,
                                   pool, avg)

    return _launch(x, conv_bias, running_mean, mul, bias, pool, avg)


@conv_epilogue_op.register_fake
def _(x, conv_bias, running_mean, mul, bias, pool, avg=False):
    return _empty_out(x, pool)


cuda_build.register_cost(
    conv_epilogue_op,
    lambda x, conv_bias, running_mean, mul, bias, pool, avg=False: cost(
        x.shape, x.dtype, pool, conv_bias is not None))


def conv_epilogue(x, conv_bias, running_mean, mul, bias, pool, avg=False):
    """(B, C, T, F) float32 or bf16 conv output without its bias ->
    ``relu(norm(x + conv_bias))``, pooled over (1, 2) pairs of F (an odd F
    drops its last column) with ``pool``, by their maximum or, with
    ``avg``, by their mean, in x's dtype and memory layout (NCHW, as cuDNN
    gives the serving pipelines' convs, or channels-last, as it gives convs
    whose input arrives as (B, T, F, C)).

    ``conv_bias`` (C,) is in x's dtype, or None for a conv without a bias;
    ``running_mean``, ``mul`` (eval
    BatchNorm's ``rsqrt(running_var + eps) * weight``) and ``bias`` (C,)
    are float32. CUDA tensors go through the Hopper kernel (or raise), which
    repeats :func:`conv_epilogue_plain`'s arithmetic bit for bit; CPU
    tensors through the plain version; both through
    :data:`conv_epilogue_op`. ``conv_epilogue.launches`` counts the
    kernel's launches. Not differentiable: ``ops.layers.conv_block`` calls it
    only where autograd does not record.
    """

    _check_inputs(x, conv_bias, running_mean, mul, bias, pool)

    return conv_epilogue_op(x, conv_bias, running_mean, mul, bias, pool,
                            bool(avg))


conv_epilogue.launches = 0
