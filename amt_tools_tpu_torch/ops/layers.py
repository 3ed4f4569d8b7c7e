"""Flax layer semantics the port's modules share: dtype promotion and init.

The JAX models compute in ``dtype`` (e.g. bf16) while their parameters stay
float32: Flax's ``Dense`` and ``Conv`` cast inputs, kernel and bias to
``dtype`` before the product, and ``BatchNorm`` normalizes in float32 and
casts its result. These helpers give ``nn.Linear``/``nn.Conv2d`` weights the
same treatment, initialize parameters like Flax's defaults from an explicit
``torch.Generator``, and draw Flax's dropout from one. An int8 layer of
``ops.qconv`` (``quantized = True``) passed to ``linear``, ``conv2d_same``
or ``conv2d_valid`` runs its own forward: it quantizes its input, carries
its padding and casts to its own dtype, so a model calls the same helper
whichever layer it built. :func:`checkpoint` recomputes a function in the
backward pass (the models' ``remat``) with the same dropout noise and
without a second update of BatchNorm's running statistics. :func:`conv_block`
is one conv of an acoustic stack (conv, BatchNorm, ReLU, the optional
(1, 2) max- or average pool: O&F's blocks, and the two convs of a
High-resolution Piano Transcription ConvBlock, whose convs have no bias);
its eval forward on CUDA runs the conv without its bias and the rest as
one hand-written kernel (``ops.conv_epilogue``), and :func:`stack_layout`
puts an O&F stack whose every block does so in channels-last.

Data parallelism (``parallel/``): a train-mode :class:`BatchNorm` whose
``process_group`` is set takes its statistics over the global batch, and
:func:`dropout` given a :class:`BatchShardGenerator` draws the global
batch's mask and keeps the rank's rows, so a step split over ranks equals
the one-process step. A layer with a ``tp_group`` (set by
``parallel.shard_params_tp``) holds its columns of a column-parallel
kernel, and :func:`linear` (:func:`head_linear` for stacked per-head
kernels) gathers the columns of its output.
"""

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel.collectives import all_reduce, gather_columns, reduce_grad
from . import cuda_build
from .conv_epilogue import batch_norm_eval, conv_epilogue

__all__ = ['linear', 'head_linear', 'conv2d_same', 'conv2d_valid',
           'conv_block', 'stack_layout', 'dense_block', 'conv3x3',
           'BatchNorm', 'dropout', 'BatchShardGenerator', 'lecun_normal_',
           'torch_default_', 'orthogonal_', 'checkpoint', 'records']

# Running-average decay of every Flax BatchNorm the JAX models build
# (amt_tools_tpu/models/onsetsframes.py:99)
_MOMENTUM = 0.9

def checkpoint(fn, *args, module=None, generator=None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward, with the same results, where a literal translation of
    ``jax.checkpoint`` would not give them:

    - dropout draws from the explicit ``generator``, whose state
      checkpointing does not restore (it restores the default generators'
      only, which nothing here draws from), so the recomputation starts
      from the state the forward started from and leaves the generator as
      it found it: the same masks;
    - a train-mode :class:`BatchNorm` would update its running statistics
      a second time; those of ``module`` (the module whose layers ``fn``
      runs) take the same batch statistics in the recomputation and leave
      the buffers alone.
    """

    saved = None if generator is None else generator.get_state()
    norms = [] if module is None else [m for m in module.modules()
                                       if isinstance(m, BatchNorm)]

    @contextlib.contextmanager
    def recompute():
        after = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(saved)
        for norm in norms:
            norm.recomputing = True
        try:
            yield
        finally:
            for norm in norms:
                norm.recomputing = False
            if generator is not None:
                generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), recompute()))


def _compute_dtype(x, dtype):
    return x.dtype if dtype is None else dtype


def linear(x, layer, dtype=None):
    """``layer`` (an ``nn.Linear``) applied in ``dtype`` (default: x's).

    A layer with a ``tp_group`` holds its rank's rows of the weight and the
    bias (output columns): each rank computes its columns and the output
    gathers them, in rank order; the input's gradient is summed over the
    group."""

    if getattr(layer, 'quantized', False):
        return layer(x)

    dtype = _compute_dtype(x, dtype)
    group = getattr(layer, 'tp_group', None)
    if group is not None:
        x = reduce_grad(x, group)

    y = F.linear(x.to(dtype), layer.weight.to(dtype), _bias(layer, dtype))

    return y if group is None else gather_columns(y, group)


def head_linear(x, module, dtype=None):
    """Per-head projections, one batched contraction: (..., H, K) inputs,
    ``module.head_kernels`` (H, K, D) and ``module.head_bias`` (H, D) ->
    (..., H, D) in ``dtype`` (default: x's).

    A module with a ``tp_group`` holds its rank's columns of the head
    kernels and computes those; as in :func:`linear`, the output gathers
    them and the input's gradient is summed over the group."""

    dtype = _compute_dtype(x, dtype)
    group = getattr(module, 'tp_group', None)
    if group is not None:
        x = reduce_grad(x, group)

    y = torch.einsum('...hk,hkd->...hd', x.to(dtype),
                     module.head_kernels.to(dtype))
    if group is not None:
        y = gather_columns(y, group)

    return y + module.head_bias.to(dtype)


def conv2d_same(x, layer, dtype=None):
    """``layer`` (an odd-kernel ``nn.Conv2d``, grouped or not) with SAME
    padding in ``dtype``."""

    if getattr(layer, 'quantized', False):
        return layer(x)

    dtype = _compute_dtype(x, dtype)

    return F.conv2d(x.to(dtype), layer.weight.to(dtype), _bias(layer, dtype),
                    padding=_same_padding(layer), groups=layer.groups)


def _bias(layer, dtype):
    """``layer``'s bias in ``dtype``, or None for a layer without one."""

    return None if layer.bias is None else layer.bias.to(dtype)


def _same_padding(layer):
    return tuple(k // 2 for k in layer.kernel_size)


def conv2d_valid(x, layer, dtype=None):
    """``layer`` (an ``nn.Conv2d``) with VALID (no) padding in ``dtype``."""

    if getattr(layer, 'quantized', False):
        return layer(x)

    dtype = _compute_dtype(x, dtype)

    return F.conv2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def conv_block(x, conv, norm, pool, dtype=None, avg=False):
    """One block of an O&F acoustic stack on (B, C, T, F): ``conv`` (with
    or without a bias) with SAME padding in ``dtype`` (default: x's, as
    :func:`conv2d_same`), the :class:`BatchNorm` ``norm``, ReLU and, with
    ``pool``, a (1, 2) max-pool over F, or with ``avg`` an average pool.

    In eval on CUDA, with autograd not recording and a float conv, the conv
    runs without its bias and the bias, the norm, the ReLU and the pool are
    one pass of ``ops.conv_epilogue``, bit for bit the eager ops. Everything
    else runs the eager ops: a train-mode norm, a forward autograd records,
    an int8 conv (``quantized``), a float16 conv, the CPU."""

    if _eager_block(x, conv, norm, _compute_dtype(x, dtype)):
        x = F.relu(norm(conv2d_same(x, conv, dtype), dtype))
        if not pool:
            return x
        return (F.avg_pool2d(x, (1, 2), stride=(1, 2)) if avg else
                F.max_pool2d(x, (1, 2), stride=(1, 2)))

    dtype = _compute_dtype(x, dtype)
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None,
                 padding=_same_padding(conv), groups=conv.groups)

    args = (y, _bias(conv, dtype), norm.running_mean.to(torch.float32),
            norm.eval_scale().to(torch.float32), norm.bias.to(torch.float32),
            pool)

    return conv_epilogue(*args, avg=avg)


def dense_block(x, layer, norm, dtype=None, weight=None):
    """``relu(norm(layer(x)))`` over the last axis of (..., K): the
    ``nn.Linear`` ``layer`` (with or without a bias; ``weight``, when given,
    in place of its weight) in ``dtype`` (default: x's), then the
    :class:`BatchNorm` ``norm`` over its N outputs, which it takes as
    channels, and ReLU.

    The eval forward on CUDA that autograd does not record runs the product
    without a bias and the rest as one pass of ``ops.conv_epilogue``, on the
    (rows, N, 1, 1) view of the product, as :func:`conv_block` does."""

    dtype = _compute_dtype(x, dtype)
    lead = x.shape[:-1]
    weight = layer.weight if weight is None else weight
    if _eager_block(x, layer, norm, dtype):
        y = F.linear(x.to(dtype), weight.to(dtype), _bias(layer, dtype))
        y = F.relu(norm(y.reshape(-1, y.shape[-1]), dtype))
        return y.reshape(lead + (-1,))

    y = F.linear(x.to(dtype), weight.to(dtype))
    y = conv_epilogue(y.reshape(-1, y.shape[-1], 1, 1), _bias(layer, dtype),
                      norm.running_mean.to(torch.float32),
                      norm.eval_scale().to(torch.float32),
                      norm.bias.to(torch.float32), False)

    return y.reshape(lead + (-1,))


def records(*tensors):
    """Whether autograd records an operation on any of ``tensors``: grad
    mode is on and one of them (None and non-tensors aside) requires
    grad."""

    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


def _eager_block(x, conv, norm, dtype):
    """Whether :func:`conv_block` runs the eager ops rather than the
    epilogue kernel, which takes float32 and bf16."""

    if (x.device.type != 'cuda' or norm.training or
            getattr(conv, 'quantized', False) or
            dtype not in (torch.float32, torch.bfloat16)):
        return True

    return records(x, conv.weight, conv.bias, norm.weight, norm.bias)


def stack_layout(x, module, blocks, dtype=None):
    """The (B, C, T, F) input of an O&F acoustic stack ``module``, whose
    ``blocks`` are its (conv, norm, ...) :func:`conv_block` arguments, in
    the memory layout the stack runs in.

    Where every block takes the epilogue kernel (a CUDA x, an eval-mode
    stack, a float conv, autograd not recording), x goes channels-last:
    cuDNN's bf16 kernels work in NHWC, so an NCHW stack has each conv's
    input and output converted, while a channels-last input keeps every conv
    output, the epilogue's and the flatten before the dense layer in that
    layout. ``stack_layout.channels_last`` counts those forwards (at trace
    time under ``torch.export``). Every other forward keeps x as it is."""

    dtype = _compute_dtype(x, dtype)
    if (module.training or records(x, *module.parameters()) or
            any(_eager_block(x, conv, norm, dtype)
                for conv, norm, *_ in blocks)):
        return x

    cuda_build.count(stack_layout, 'channels_last')

    return x.to(memory_format=torch.channels_last)


stack_layout.channels_last = 0


class BatchNorm(nn.Module):
    """Batch norm over channel dim 1 with Flax's arithmetic.

    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast to
    ``dtype`` (default: x's). Parameter names follow ``nn.BatchNorm2d``.
    In eval mode the statistics are the running ones
    (``ops.conv_epilogue.batch_norm_eval``); in the O&F acoustic stacks'
    eval forward on CUDA that arithmetic runs inside the epilogue kernel
    instead, through :func:`conv_block`. In train mode they
    are the batch's, as Flax 0.12 takes them
    (``flax/linen/normalization.py:60-145``): the float32 mean over every
    axis but the channel's, and the fast variance ``max(0, E[x^2] -
    E[x]^2)``; gradients flow through both. Each train-mode forward then
    updates the running buffers once, ``0.9 * ra + 0.1 * stat`` with the
    biased variance (``:402-404``). ``F.batch_norm`` would update
    ``running_var`` with the unbiased variance, so the arithmetic is
    written out. A forward recomputed by :func:`checkpoint`
    (``recomputing``) does not update them again.

    With ``process_group`` set (the ``data`` dimension of a data-parallel
    train step) the statistics are the global batch's, as Flax takes them
    under a jitted data-parallel step: the float32 per-channel sums of x
    and x^2 and their count are summed over the group
    (``parallel.collectives.all_reduce``, gradients flowing through the
    sum), and every rank updates its buffers from the same statistics. The
    count is exact below 2^24 values a channel. Without a group the same
    arithmetic runs on the local sums, so a group of one rank gives the
    same bits.
    """

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.recomputing = False
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x, dtype=None):
        dtype = _compute_dtype(x, dtype)

        if self.training:
            return self._forward_train(x, dtype)

        return batch_norm_eval(x, self.running_mean, self.eval_scale(),
                               self.bias, dtype)

    def eval_scale(self):
        """``rsqrt(running_var + eps) * weight``: eval mode's multiplier."""

        return torch.rsqrt(self.running_var + self.eps) * self.weight

    def _forward_train(self, x, dtype):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        axes = (0,) + tuple(range(2, x.dim()))
        channels = x.shape[1]
        xf = x.float()
        count = torch.full((1,), xf.numel() // channels, dtype=torch.float32,
                           device=xf.device)
        stats = torch.cat([xf.sum(axes), (xf * xf).sum(axes), count])
        if self.process_group is not None:
            stats = all_reduce(stats, self.process_group)

        mean = stats[:channels] / stats[-1]
        var = torch.clamp(stats[channels:-1] / stats[-1] - mean * mean,
                          min=0.0)

        if not self.recomputing:
            with torch.no_grad():
                self.running_mean.mul_(_MOMENTUM).add_((1 - _MOMENTUM) * mean)
                self.running_var.mul_(_MOMENTUM).add_((1 - _MOMENTUM) * var)

        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

        return y.to(dtype)


class BatchShardGenerator:
    """A dropout generator for shard ``index`` of ``count`` equal shards of
    a global batch along dim 0: :func:`dropout` draws the global batch's
    mask from ``generator`` and keeps this shard's rows. Every rank of a
    data-parallel step holds one, over the same generator state, so the
    masks are those of the one-process step on the global batch bit for
    bit (JAX draws them for the global logical array from one key)."""

    def __init__(self, generator, index, count):
        self.generator = generator
        self.index = index
        self.count = count

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state):
        self.generator.set_state(state)


def dropout(x, rate, generator):
    """Flax's ``nn.Dropout`` in train mode: keep each value with probability
    ``1 - rate`` (a uniform draw below it) and scale it by ``1 / (1 -
    rate)``. The noise comes from ``generator``, a ``torch.Generator`` on
    x's device (``torch.nn.functional.dropout`` takes none) or a
    :class:`BatchShardGenerator` over one."""

    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError('dropout in train mode needs an explicit '
                         'torch.Generator (Flax needs a dropout rng)')

    keep_prob = 1.0 - rate
    if isinstance(generator, BatchShardGenerator):
        rows = x.shape[0]
        noise = torch.rand((rows * generator.count,) + tuple(x.shape[1:]),
                           generator=generator.generator, device=x.device)
        noise = noise[generator.index * rows:(generator.index + 1) * rows]
    else:
        noise = torch.rand(x.shape, generator=generator, device=x.device)
    keep = noise < keep_prob

    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def lecun_normal_(tensor, fan_in, generator):
    """Flax's default kernel init: truncated normal, variance 1 / fan_in."""

    # Flax divides by the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def torch_default_(layer, fan_in, generator):
    """``torch.nn``'s default init of a Linear or conv ``layer``, its
    weight and bias uniform over +-1 / sqrt(``fan_in``), from
    ``generator``; returns the layer."""

    bound = fan_in ** -0.5
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)

    return layer


def conv3x3(in_channels, out_channels, generator, groups=1):
    """An ``nn.Conv2d`` 3x3 layer initialized as Flax's ``nn.Conv``:
    LeCun-normal kernel (fan-in 9 * in_channels / groups), zero bias.
    ``groups`` splits the channels as Flax's ``feature_group_count``."""

    conv = nn.Conv2d(in_channels, out_channels, (3, 3), groups=groups)
    lecun_normal_(conv.weight, 9 * in_channels // groups, generator)
    nn.init.zeros_(conv.bias)

    return conv


def orthogonal_(tensor, generator):
    """Flax's recurrent-kernel init: a matrix with orthonormal rows."""

    with torch.no_grad():
        return nn.init.orthogonal_(tensor, generator=generator)
