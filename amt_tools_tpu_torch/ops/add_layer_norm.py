"""Residual add and LayerNorm of a post-LN transformer sublayer,
``LayerNorm(residual + y)`` over the last dim, as one Hopper kernel.

No TPU kernel stands behind it: the JAX package has no transformer. The
post-LN layers of hFT-Transformer (``ops.attention``) end every sublayer
with the LayerNorm of its residual sum. Eagerly that is two passes over the
rows, an add that writes the sum and PyTorch's LayerNorm kernel that reads
it back. The bound is bytes, so the kernel makes one pass: y and the
residual are read once and the output written once, with the row's
statistics taken in registers.

:func:`add_layer_norm` launches ``csrc/add_layer_norm.cu`` for CUDA tensors
and runs :func:`add_layer_norm_plain`, the eager ops, for CPU tensors; both
through the custom op ``torch.ops.amt_tools_tpu_torch.add_layer_norm``
(:data:`add_layer_norm_op`); :func:`cost` is its byte count. On the card
the kernel keeps the sum's bits and takes the statistics in float32, as
``F.layer_norm`` does; only the order of the float32 sums differs, so an
output lies within one rounding of the plain version's.

Counters: ``add_layer_norm.fused``, the kernel's launches;
``add_layer_norm.plain``, the plain version's calls on the layers' route
(``ops.attention``'s ``_PostLN``).
"""

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ['add_layer_norm', 'add_layer_norm_op', 'add_layer_norm_plain',
           'cost', 'MAX_WIDTH']

_ARGTYPES = ([ctypes.c_void_p] * 5 +
             [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_float, ctypes.c_void_p])
_ENTRIES = {torch.float32: 'add_layer_norm_f32',
            torch.bfloat16: 'add_layer_norm_bf16'}
_SIGNATURES = {entry: _ARGTYPES for entry in _ENTRIES.values()}

# A row is whole 16-byte vectors of bf16, and a lane holds at most 8 of
# them (16 in float32)
WIDTH_MULTIPLE = 8
MAX_WIDTH = 2048


def add_layer_norm_plain(y, residual, weight, bias, eps):
    """``F.layer_norm(residual + y)`` over the last dim, the eager ops as
    the post-LN layers ran them: the sum in the inputs' dtype, a residual of
    fewer dims broadcast over y's leading ones."""

    return F.layer_norm(residual + y, weight.shape, weight, bias, eps)


def _rows(t):
    return t.numel() // t.shape[-1] if t.shape[-1] else 0


def _check_inputs(y, residual, weight, bias):
    tensors = {'y': y, 'residual': residual, 'weight': weight, 'bias': bias}
    cuda_build.require_plain('add_layer_norm', **tensors)
    if y.dtype not in _ENTRIES:
        raise TypeError(f'add_layer_norm takes float32 or bf16 tensors, got '
                        f'{y.dtype}')
    width = y.shape[-1] if y.dim() else 0
    if width < WIDTH_MULTIPLE or width % WIDTH_MULTIPLE or width > MAX_WIDTH:
        raise ValueError(f'add_layer_norm takes rows of a multiple of '
                         f'{WIDTH_MULTIPLE} values up to {MAX_WIDTH}, got y '
                         f'of shape {tuple(y.shape)}')
    if not (1 <= residual.dim() <= y.dim() and
            residual.shape == y.shape[y.dim() - residual.dim():]):
        raise ValueError(f'residual must have y\'s shape or its trailing '
                         f'dims, got {tuple(residual.shape)} for y '
                         f'{tuple(y.shape)}')
    for name in ('weight', 'bias'):
        if tensors[name].shape != (width,):
            raise ValueError(f'{name} must be ({width},), got '
                             f'{tuple(tensors[name].shape)}')
    for name, t in tensors.items():
        if t.dtype != y.dtype:
            raise TypeError(f'{name} is {t.dtype}, y {y.dtype}: '
                            f'add_layer_norm takes one dtype')
        if t.device != y.device:
            raise ValueError(f'y on {y.device} but {name} on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'add_layer_norm takes a contiguous {name}')


def cost(rows, residual_rows, width, dtype):
    """``(flops, bytes)`` of one launch over ``rows`` rows of ``width``
    values and a residual of ``residual_rows`` rows: y and the residual read
    once, the output written once, and the weight and bias. No FLOPs:
    ``FlopCounterMode`` counts none for the add and LayerNorm this
    replaces, and the models' FLOP counts leave them out."""

    return 0.0, float(dtype.itemsize * width *
                      (2 * rows + residual_rows + 2))


def _launch(y, residual, weight, bias, eps):
    """The kernel on CUDA tensors; counts the launch."""

    if y.device.type != 'cuda':
        raise ValueError(f'add_layer_norm runs on CUDA or CPU tensors, not '
                         f'{y.device}')

    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    for name, t in (('y', y), ('residual', residual), ('weight', weight),
                    ('bias', bias)):
        if t.data_ptr() % 16:
            raise ValueError(f'add_layer_norm reads 16-byte vectors: {name} '
                             f'must start 16-byte aligned')

    width = y.shape[-1]
    lib = cuda_build.library('add_layer_norm', _SIGNATURES)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, _ENTRIES[y.dtype])(
            y.data_ptr(), residual.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), _rows(y), _rows(residual),
            width, eps, stream)
    cuda_build.check(status, 'add_layer_norm')
    cuda_build.count(add_layer_norm, 'fused')

    return out


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::add_layer_norm',
                         mutates_args=())
def add_layer_norm_op(y: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """The add and norm as an op: the launch on CUDA tensors, the plain
    version on CPU tensors (inputs as :func:`add_layer_norm` checks
    them)."""

    if y.device.type == 'cpu':
        return add_layer_norm_plain(y, residual, weight, bias, eps)

    return _launch(y, residual, weight, bias, eps)


@add_layer_norm_op.register_fake
def _(y, residual, weight, bias, eps):
    return torch.empty_like(y, memory_format=torch.contiguous_format)


cuda_build.register_cost(
    add_layer_norm_op,
    lambda y, residual, weight, bias, eps: cost(
        _rows(y), _rows(residual), y.shape[-1], y.dtype))


def add_layer_norm(y, residual, weight, bias, eps):
    """``LayerNorm(residual + y)`` over the last dim, in y's dtype, float32
    or bf16: ``y`` (..., H) is a sublayer's output, ``residual`` y's shape
    or its trailing dims (row r of y adds residual row r % R), ``weight``
    and ``bias`` (H,); all of one dtype, contiguous, H a multiple of 8 up to
    2048. CUDA tensors go through the Hopper kernel (or raise), CPU tensors
    through :func:`add_layer_norm_plain`; both through
    :data:`add_layer_norm_op`. ``add_layer_norm.fused`` counts the kernel's
    launches. Not differentiable: the layers call it only where autograd
    does not record."""

    _check_inputs(y, residual, weight, bias)

    return add_layer_norm_op(y, residual, weight, bias, float(eps))


add_layer_norm.fused = 0
add_layer_norm.plain = 0
