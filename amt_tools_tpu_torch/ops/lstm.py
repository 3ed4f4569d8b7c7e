"""LSTM layers with hoisted input projections.

Counterparts of ``amt_tools_tpu/ops/lstm.py`` ``FastLSTM`` (``:208``) and
``FastBiLSTM`` (``:260``) from a zero carry, whole or masked by per-row
``lengths`` (bucketed evaluation, ``lengths_to_mask`` ``:202``): the input
projection for every step is one ``nn.Linear`` over
(B, T, E), and the recurrence runs in the Hopper kernels on CUDA tensors:
:func:`ops.lstm_kernel.lstm_scan` (kernel B) when nothing differentiates
it, :func:`ops.lstm_kernel.lstm_scan_grad` (kernels E and F) when autograd
records, as ``lstm_scan_pallas_grad`` forwards to ``lstm_scan_pallas``
outside ``jax.grad``. A CUDA width the kernels do not take
(:func:`ops.lstm_kernel.scan_supported` is false, e.g. H = 24) runs them
zero-padded to the next multiple of 16 (:func:`kernel_width`,
:func:`padded_recurrence`), where the JAX layers fall back to their XLA
scan (``ops/lstm.py:235-240``); above ``MAX_HIDDEN`` (1024, wider than
any model of the repo) the kernels raise. Parameter names match the Flax tree
(``input_proj[_fwd|_bwd]``, ``recurrent_kernel[_fwd|_bwd]`` in the (H, 4H)
layout, gate order i, f, g, o). ``quant`` (``False``, ``True`` or
``'static'``) makes the hoisted projections ``ops.qconv.Int8Dense`` layers
under the same names, as JAX's ``_input_proj`` (``:34-50``); the recurrence
stays float.

With ``lengths`` each row keeps its carry and outputs 0 past its length
(the masked launch on CUDA, the masked plain version on the CPU), so its
valid frames equal an unpadded run's bit for bit. ``FastLSTM`` takes
``initial_carry=(c, h)`` and ``return_carry=True`` for streaming (JAX
``:208-257``): the recurrence starts from the carry and returns the final
one, float32 in both dtypes (JAX's XLA scan keeps it in the projections'
dtype), so chunks that thread it equal one whole call bit for bit. Both
train, as JAX's scan does under ``jax.grad`` (``_masked_step_outputs``
``:98-108``): kernels E and F take the lengths and the carry, so a masked
step's gradient passes the row's carries through and the initial carry
gets its gradient from the returned one's (``lstm_kernel.lstm_scan_grad``);
a masked or carried CUDA tensor under autograd runs E and F or raises.

``GroupedBiLSTM`` (JAX ``:328-402``) runs S independent BiLSTMs, (S, B,
T, E) -> (S, B, T, 2H), as the opt-in ``fused_lms`` layout of the O&F
models: the 2S directions' projections are one batched contraction, and
their recurrences one grouped launch of kernel B (E and F when autograd
records; ``ops.lstm_kernel.lstm_scan_grouped``), the card's counterpart of
JAX's one grouped scan (``_grouped_lstm_scan``, ``:151-199``). The
backward directions run reversed in the launch (the groups from S on) where
JAX scans time-flipped copies; the arithmetic a step is the same.

Kernels B, E and F read W_h whole through a raw pointer, so a layer whose
``recurrent_kernel`` is sharded gathers it before the launch: one
``parallel.shard_params_tp`` left with a column shard and a ``tp_group``
(:func:`parallel.collectives.gather_columns`, whose gradient keeps the
rank's columns), or a DTensor (``full_tensor()``), as XLA gathers an
operand around a Pallas call it cannot partition.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from ..parallel.collectives import gather_columns
from .layers import lecun_normal_, linear, orthogonal_
from .lstm_kernel import (lstm_scan, lstm_scan_grad, lstm_scan_grouped,
                          lstm_scan_grouped_grad, scan_supported)
from .qconv import Int8Dense

__all__ = ['FastLSTM', 'FastBiLSTM', 'GroupedBiLSTM', 'kernel_width',
           'padded_recurrence', 'lengths_to_mask']


def _input_proj(input_size, features, dtype, quant, generator):
    """The hoisted (B*T, E) @ (E, 4H) projection: an ``nn.Linear`` (LeCun
    normal, zero bias) or its int8 drop-in, drawing the same numbers."""

    if quant:
        return Int8Dense(input_size, features, dtype=dtype,
                         static_scale=quant == 'static', generator=generator)

    layer = nn.Linear(input_size, features)
    lecun_normal_(layer.weight, input_size, generator)
    nn.init.zeros_(layer.bias)

    return layer


def _pad_units(x, hidden, padded):
    """(..., 4H) in gate blocks i, f, g, o -> (..., 4 * padded), each block
    zero-padded from ``hidden`` to ``padded`` units."""

    lead = x.shape[:-1]
    x = F.pad(x.reshape(lead + (4, hidden)), (0, padded - hidden))

    return x.reshape(lead + (4 * padded,))


def lengths_to_mask(lengths, num_frames):
    """(B,) valid lengths -> (B, T) boolean validity mask."""

    lengths = torch.as_tensor(lengths)

    return (torch.arange(num_frames, device=lengths.device)[None, :] <
            lengths[:, None])


def _records(*tensors):
    """Whether autograd records an operation on any of ``tensors``."""

    return torch.is_grad_enabled() and any(
        torch.is_tensor(x) and x.requires_grad for x in tensors)


def _scan(xw, w_h, reverse, lengths, carry=None, reverse_from=None):
    """The recurrence; from ``carry`` (a pair ``(c, h)``) it returns
    ``(out, (c, h))``. With ``reverse_from`` it is grouped: (G, B, T, 4H)
    ``xw`` and (G, H, 4H) ``w_h`` in one launch, the groups from
    ``reverse_from`` on reversed. Kernel B when nothing is differentiated,
    kernels E and F (masked, carried or grouped alike) when autograd
    records."""

    if _records(xw, w_h, *(carry or ())):
        # W_h goes in uncast: the Function casts it, so dW_h reaches the
        # float32 parameter unrounded
        if reverse_from is not None:
            return lstm_scan_grouped_grad(xw, w_h, reverse_from, lengths)
        if carry is None:
            return lstm_scan_grad(xw, w_h, reverse, lengths)
        return lstm_scan_grad(xw, w_h, reverse, lengths,
                              initial_carry=carry, return_carry=True)

    if reverse_from is not None:
        return lstm_scan_grouped(xw, w_h.to(xw.dtype).contiguous(),
                                 reverse_from, lengths)
    if carry is None:
        return lstm_scan(xw, w_h.to(xw.dtype).contiguous(), reverse=reverse,
                         lengths=lengths)

    return lstm_scan(xw, w_h.to(xw.dtype).contiguous(), reverse=reverse,
                     lengths=lengths, initial_carry=carry, return_carry=True)


def kernel_width(hidden, dtype):
    """The width the layers run kernels B, E and F at for ``hidden`` units
    a direction on the card: ``hidden`` where they take it, else the next
    multiple of 16 where they take that. Above ``MAX_HIDDEN`` it is
    ``hidden`` itself, and the kernels raise."""

    if scan_supported(hidden, dtype):
        return hidden
    padded = -(-hidden // 16) * 16

    return padded if scan_supported(padded, dtype) else hidden


def padded_recurrence(xw, w_h, reverse, padded, lengths=None, carry=None,
                      reverse_from=None):
    """The recurrence at ``padded`` units, cut back to H: zero xw columns
    and zero W_h rows and columns for the added units keep their gates at
    (0.5, 0.5, 0, 0.5), so c = h = 0 for them at every step (a ``carry`` is
    zero-padded alike); they add nothing to any sum of the real units, and
    the slice drops their gradients (the padded carry's too: its gradient
    comes back sliced to H). With ``carry`` it returns ``(out, (c, h))``
    cut back to H. With ``reverse_from``, grouped as :func:`_scan`."""

    hidden = w_h.shape[-2]
    w_h = F.pad(_pad_units(w_h, hidden, padded), (0, 0, 0, padded - hidden))
    if carry is not None:
        carry = tuple(F.pad(torch.as_tensor(x), (0, padded - hidden))
                      for x in carry)
    result = _scan(_pad_units(xw, hidden, padded).contiguous(), w_h, reverse,
                   lengths, carry, reverse_from)
    if carry is None:
        return result[..., :hidden]

    out, (c, h) = result

    return out[..., :hidden], (c[..., :hidden], h[..., :hidden])


def _recurrence(xw, w_h, reverse=False, lengths=None, carry=None,
                reverse_from=None):
    # The Pallas path's compute dtype: bf16 projections keep a bf16 W_h,
    # anything else runs in float32
    dtype = torch.bfloat16 if xw.dtype == torch.bfloat16 else torch.float32
    xw = xw.to(dtype).contiguous()

    # Decided from the shape, before any launch
    hidden = w_h.shape[-2]
    if lengths is not None:
        lengths = torch.as_tensor(lengths).reshape(-1).to(xw.device)
    if xw.device.type == 'cuda' and kernel_width(hidden, dtype) != hidden:
        return padded_recurrence(xw, w_h, reverse,
                                 kernel_width(hidden, dtype), lengths, carry,
                                 reverse_from)

    return _scan(xw, w_h, reverse, lengths, carry, reverse_from)


def _whole(module, w_h):
    """``w_h`` (H, 4H), or (S, H, 4H) stacked, as the kernels read it: the
    columns of a tensor-parallel shard gathered over the module's
    ``tp_group``, a DTensor made whole."""

    if isinstance(w_h, DTensor):
        return w_h.full_tensor()
    group = getattr(module, 'tp_group', None)
    if group is not None and w_h.shape[-1] != 4 * module.features:
        return gather_columns(w_h, group, dim=-1)

    return w_h


class FastLSTM(nn.Module):
    """Unidirectional LSTM: (B, T, E) -> (B, T, H); ``lengths`` (B,) masks
    each row's padded tail. Pass ``initial_carry=(c, h)`` and
    ``return_carry=True`` for streaming: the result is then ``((c, h),
    out)``, as JAX's, with a float32 carry. Either trains: the gradient
    reaches the initial carry and flows back from the returned one."""

    def __init__(self, input_size, features, dtype=None, generator=None,
                 quant=False):
        super().__init__()
        self.features = features
        self.dtype = dtype

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.input_proj = _input_proj(input_size, 4 * features, dtype, quant,
                                      generator)
        self.recurrent_kernel = nn.Parameter(torch.empty(features, 4 * features))
        orthogonal_(self.recurrent_kernel, generator)

    def forward(self, inputs, lengths=None, initial_carry=None,
                return_carry=False):
        xw = linear(inputs, self.input_proj, self.dtype)

        w_h = _whole(self, self.recurrent_kernel)
        if initial_carry is None and not return_carry:
            return _recurrence(xw, w_h, lengths=lengths)

        if initial_carry is None:
            zeros = torch.zeros((xw.shape[0], self.features),
                                device=xw.device)
            initial_carry = (zeros, zeros)
        out, carry = _recurrence(xw, w_h, lengths=lengths,
                                 carry=initial_carry)

        return (carry, out) if return_carry else out


class FastBiLSTM(nn.Module):
    """Bidirectional LSTM: (B, T, E) -> (B, T, 2H), [forward | backward];
    ``lengths`` (B,) masks each row's padded tail, so the backward
    direction starts at each row's true end."""

    def __init__(self, input_size, features, dtype=None, generator=None,
                 quant=False):
        super().__init__()
        self.features = features
        self.dtype = dtype

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.input_proj_fwd = _input_proj(input_size, 4 * features, dtype,
                                          quant, generator)
        self.input_proj_bwd = _input_proj(input_size, 4 * features, dtype,
                                          quant, generator)
        self.recurrent_kernel_fwd = nn.Parameter(
            torch.empty(features, 4 * features))
        self.recurrent_kernel_bwd = nn.Parameter(
            torch.empty(features, 4 * features))
        orthogonal_(self.recurrent_kernel_fwd, generator)
        orthogonal_(self.recurrent_kernel_bwd, generator)

    def forward(self, inputs, lengths=None):
        xw_f = linear(inputs, self.input_proj_fwd, self.dtype)
        xw_b = linear(inputs, self.input_proj_bwd, self.dtype)

        out_f = _recurrence(xw_f, _whole(self, self.recurrent_kernel_fwd),
                            lengths=lengths)
        out_b = _recurrence(xw_b, _whole(self, self.recurrent_kernel_bwd),
                            reverse=True, lengths=lengths)

        return torch.cat([out_f, out_b], dim=-1)


class GroupedBiLSTM(nn.Module):
    """S independent BiLSTMs in one recurrence: (S, B, T, E) -> (S, B, T,
    2H), each stream's [forward | backward] (JAX ``ops/lstm.py:328-402``).

    Parameters are the per-stream stacks of :class:`FastBiLSTM`'s under
    JAX's names: ``input_proj_{fwd,bwd}_kernel`` (S, E, 4H),
    ``input_proj_{fwd,bwd}_bias`` (S, 4H) and ``recurrent_kernel_{fwd,bwd}``
    (S, H, 4H), initialized as JAX's (LeCun normal over E, zero bias, one
    orthogonal matrix a stream) from ``generator``; ``models.
    fuse_lm_variables`` / ``unfuse_lm_variables`` convert a ``state_dict``
    to and from the per-stream layout. The 2S directions' projections are
    one batched contraction in ``dtype`` (default: the input's), and their
    recurrences one grouped launch: the forward groups [0, S) and the
    backward groups [S, 2S), reversed, with ``lengths`` (B,) shared by every
    group, as :class:`FastBiLSTM`'s."""

    def __init__(self, input_size, features, streams=2, dtype=None,
                 generator=None):
        super().__init__()
        self.features = features
        self.streams = streams
        self.dtype = dtype

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        four_h = 4 * features
        for direction in ('fwd', 'bwd'):
            kernel = nn.Parameter(torch.empty(streams, input_size, four_h))
            lecun_normal_(kernel, input_size, generator)
            setattr(self, f'input_proj_{direction}_kernel', kernel)
            setattr(self, f'input_proj_{direction}_bias',
                    nn.Parameter(torch.zeros(streams, four_h)))
        for direction in ('fwd', 'bwd'):
            recurrent = nn.Parameter(torch.empty(streams, features, four_h))
            for stream in range(streams):
                orthogonal_(recurrent[stream], generator)
            setattr(self, f'recurrent_kernel_{direction}', recurrent)

    def forward(self, inputs, lengths=None):
        streams, batch, frames, dim_in = inputs.shape
        if streams != self.streams:
            raise ValueError(f'expected {self.streams} streams, '
                             f'got input shape {tuple(inputs.shape)}')
        dtype = self.dtype if self.dtype is not None else inputs.dtype

        # Both directions of every stream, (2S, B T, 4H) -> (2S, B, T, 4H):
        # one batched contraction. The input is repeated for the backward
        # groups rather than broadcast: a broadcast (2, S, ...) product
        # traced on the card (torch.export) has strides whose flatten
        # guards the batch to its example's size
        kernels = torch.cat([self.input_proj_fwd_kernel,
                             self.input_proj_bwd_kernel]).to(dtype)
        biases = torch.cat([self.input_proj_fwd_bias,
                            self.input_proj_bwd_bias]).to(dtype)
        x = inputs.to(dtype).reshape(streams, batch * frames, dim_in)
        xw = torch.bmm(x.repeat(2, 1, 1), kernels) + biases[:, None, :]
        xw = xw.reshape(2 * streams, batch, frames, -1)

        w_h = torch.cat([_whole(self, self.recurrent_kernel_fwd),
                         _whole(self, self.recurrent_kernel_bwd)])
        out = _recurrence(xw, w_h, lengths=lengths, reverse_from=streams)

        return torch.cat([out[:streams], out[streams:]], dim=-1)
