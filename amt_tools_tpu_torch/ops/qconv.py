"""Int8 convolution and dense layers for serving.

Counterpart of ``amt_tools_tpu/ops/qconv.py``: :func:`quantize_symmetric`
(``:61``), :func:`validate_quant_stats` (``:86``), the static activation
quant (``:115``), :class:`Int8Conv` (``:138``) and :class:`Int8Dense`
(``:189``).

- **Weights**: per-output-channel symmetric int8, quantized from the
  float32 parameters in every forward. The modules keep ``weight``/``bias``
  under the float layer's names, so float checkpoints load unchanged.
- **Activations**, two modes. *Dynamic*: one runtime scale per sample for
  a conv (``max|x| / 127`` over each batch element) and per row for a
  dense. *Static* (``static_scale=True``): one calibrated scalar per
  layer, the ``act_amax`` buffer (the ``'quant_stats'`` collection of the
  JAX package), zero at construction. With ``calibrating`` set, a forward
  first folds ``max|x|`` into ``act_amax`` and then quantizes with the
  updated value, as the JAX module does when the collection is mutable
  (``:129-133``); ``serving.calibrate_quant_stats`` drives it.
- **Accumulation**: int8 x int8 -> int32 by ``torch._int_mm`` (cuBLASLt on
  the card), fed by an im2col of the quantized activations for a conv.
  Then ``acc * (s_x * s_w) + bias`` in float32 and a cast to ``dtype``.

The arithmetic is the JAX package's, in its order: ``scale = max(amax /
127, tiny)`` and ``round(x / scale)`` (true divisions on every device,
round half to even),
clip to +-127, int32 sums (exact in any order), the product of the scales
taken before it multiplies the accumulator. On the CPU the outputs equal
Flax's bit for bit.

On the card ``torch._int_mm`` takes M > 16 rows, K and N multiples of 8
(read from the installed version's errors on an H100).
:func:`int8_matmul` pads with zeros to meet them, which changes no sum:
TabCNN's first conv has K = 9. The im2col and the product go in chunks of
whole samples (``CHUNK_BYTES`` of im2col each), so a conv over the piano
batch (23.8 GB of im2col) holds one chunk at a time.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import lecun_normal_

__all__ = ['QUANT_STATS', 'Int8Conv', 'Int8Dense', 'int8_layers',
           'int8_matmul', 'quantize_symmetric', 'validate_quant_stats']

# The JAX package's variable collection of calibrated activation abs-maxima;
# the port keeps each as a layer's ``act_amax`` buffer
QUANT_STATS = 'quant_stats'

_TINY = torch.finfo(torch.float32).tiny
# torch._int_mm on the card: more than 16 rows, K and N multiples of 8
_MIN_ROWS = 17
_MULTIPLE = 8
# im2col bytes a chunk of a conv (whole samples; at least one)
CHUNK_BYTES = 1 << 30


def _amax_scale(amax):
    """``max(amax / 127, tiny)``. The divisor is a tensor on amax's device:
    CUDA divides by a Python scalar as a multiply by its rounded
    reciprocal, which is off by an ulp from the division for some amax."""

    return torch.clamp_min(amax / amax.new_full((), 127.0), _TINY)


def _round_clip(xf, scale):
    """``clip(round(xf / scale), -127, 127)`` as int8."""

    return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)


def quantize_symmetric(x, axis=None):
    """Symmetric int8 quantization of ``x``.

    Returns ``(q, scale)`` with ``q = round(x / scale)`` clipped to
    [-127, 127] as int8, where ``scale = max|x| / 127`` reduced over all
    axes except ``axis`` (None = per-tensor), in float32.
    """

    xf = x.float()

    if axis is None:
        scale = _amax_scale(xf.abs().amax())
        return _round_clip(xf, scale), scale

    axis = axis % x.dim()
    axes = tuple(i for i in range(x.dim()) if i != axis)
    scale = _amax_scale(xf.abs().amax(dim=axes, keepdim=True))

    return _round_clip(xf, scale), scale.reshape(x.shape[axis])


def int8_matmul(a, b):
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32 by ``torch._int_mm``.

    Zero rows of ``a``, zero columns of both and zero rows of ``b`` pad the
    operands to what the card takes (M > 16, K and N multiples of 8); the
    padding adds nothing to any sum. Padded on every device, so the CPU
    runs the same operands.
    """

    m, k = a.shape
    n = b.shape[0]
    pad_k = -k % _MULTIPLE
    if pad_k:
        a = F.pad(a, (0, pad_k))
        b = F.pad(b, (0, pad_k))
    if n % _MULTIPLE:
        b = F.pad(b, (0, 0, 0, -n % _MULTIPLE))
    if m < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - m))

    return torch._int_mm(a, b.t())[:m, :n]


def _abs_max(x):
    """``max|x|`` over the whole tensor, as a float32 scalar (exact in x's
    dtype: no copy of |x| is made)."""

    low, high = torch.aminmax(x)

    return torch.maximum(-low, high).float()


class _Int8Layer(nn.Module):
    """Weight, bias and the static activation scale shared by the layers."""

    # The float helpers of ops.layers hand such a layer its input as it is
    quantized = True

    def __init__(self, weight_shape, fan_in, dtype, static_scale, generator):
        super().__init__()
        self.dtype = dtype
        self.static_scale = static_scale
        self.calibrating = False
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(weight_shape[0]))
        if static_scale:
            self.register_buffer('act_amax', torch.zeros(()))

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        lecun_normal_(self.weight, fan_in, generator)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        # A float checkpoint carries no scale: load it, leaving act_amax as
        # it is (zero until calibrated; the pipelines refuse zero)
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)
        if prefix + 'act_amax' in missing_keys:
            missing_keys.remove(prefix + 'act_amax')

    def _static_scale(self, x):
        """The calibrated scalar scale, first folding ``max|x|`` into
        ``act_amax`` when calibrating."""

        if self.calibrating:
            with torch.no_grad():
                self.act_amax.copy_(torch.maximum(self.act_amax, _abs_max(x)))

        return _amax_scale(self.act_amax)

    def _out_dtype(self):
        return torch.float32 if self.dtype is None else self.dtype

    def chunk_rows(self, x):
        """Leading rows of ``x`` that one chunk of the forward takes: whole
        samples of a conv's input, rows of a dense's (after flattening to
        (rows, K)), ``CHUNK_BYTES`` of the product's int8 operand (a conv's
        im2col) or of the float32 copy of a dense's rows; at least one."""

        return max(1, CHUNK_BYTES // max(1, self._row_bytes(x)))

    def quantize(self, x):
        """``x`` -> ``(x8, scale)`` as a serving forward quantizes it (the
        calibrated scale, never updating it; or the dynamic scales)."""

        s_x = _amax_scale(self.act_amax) if self.static_scale else None

        return self._quantize(x.float(), s_x)

    def accumulate(self, x8):
        """The int32 accumulator of the int8 product of ``x8`` (what
        :meth:`quantize` gives) with the quantized weights, as (rows, out)."""

        return int8_matmul(self.operand(x8), self.quantized_weights()[0])

    def rescale(self, acc, rows, scale, s_w):
        """``acc * (scale * s_w) + bias`` in float32, as (rows, positions,
        out): ``rows`` leading rows of the chunk ``scale`` belongs to."""

        y = acc.float().view(rows, -1, acc.shape[-1])

        return y.mul_(scale * s_w).add_(self.bias)

    def _forward(self, x, batch, positions):
        """Quantize ``x`` (``batch`` leading rows of ``positions`` outputs
        each), accumulate and rescale in chunks of :meth:`chunk_rows` ->
        (batch, positions, out) in the output dtype."""

        w8, s_w = self.quantized_weights()
        s_x = self._static_scale(x) if self.static_scale else None

        out = torch.empty((batch, positions, w8.shape[0]),
                          dtype=self._out_dtype(), device=x.device)
        step = self.chunk_rows(x)
        for start in range(0, batch, step):
            x8, scale = self._quantize(x[start:start + step].float(), s_x)
            out[start:start + step] = self.rescale(
                int8_matmul(self.operand(x8), w8), x8.shape[0], scale, s_w)

        return out


class Int8Conv(_Int8Layer):
    """``nn.Conv2d`` replacement computing the contraction in int8, stride 1.

    (B, C, H, W) -> (B, O, H', W') in ``dtype`` (float32 when None, as the
    JAX module). ``weight`` (O, C, kh, kw) and ``bias`` (O,) are initialized
    as ``ops.layers.conv3x3`` does, drawing the same numbers from
    ``generator``. ``padding`` is ``'SAME'`` (odd kernels) or ``'VALID'``.
    The output is NCHW in shape and channels-last in memory.
    """

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3),
                 padding='SAME', dtype=None, static_scale=False,
                 generator=None):
        kh, kw = kernel_size
        super().__init__((out_channels, in_channels, kh, kw),
                         kh * kw * in_channels, dtype, static_scale, generator)
        if padding not in ('SAME', 'VALID'):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                             f"{padding!r}")
        self.kernel_size = (kh, kw)
        self.padding = padding

    def quantized_weights(self):
        """(O, kh * kw * C) int8 in the im2col's tap-major order, padded to
        a multiple of 8 columns, and the (O,) float32 scales."""

        w8, s_w = quantize_symmetric(self.weight.permute(0, 2, 3, 1), axis=0)
        w8 = w8.reshape(w8.shape[0], -1)

        return F.pad(w8, (0, -w8.shape[1] % _MULTIPLE)), s_w

    def _quantize(self, xf, s_x):
        if self.static_scale:
            return _round_clip(xf, s_x), s_x

        # Per-sample dynamic scales
        x8, scale = quantize_symmetric(xf, axis=0)

        return x8, scale.reshape(-1, 1, 1)

    def _geometry(self, height, width):
        kh, kw = self.kernel_size
        pad_h, pad_w = (kh // 2, kw // 2) if self.padding == 'SAME' else (0, 0)

        return pad_h, pad_w, height + 2 * pad_h - kh + 1, width + 2 * pad_w - kw + 1

    def _row_bytes(self, x):
        _, _, out_h, out_w = self._geometry(*x.shape[2:])
        k = self.weight[0].numel()

        return out_h * out_w * (k + -k % _MULTIPLE)

    def operand(self, x8):
        """The im2col: (b, C, H, W) int8 -> (b * H' * W', K) int8 rows, each
        the (kh, kw, C) patch of one output position, zero-padded to K a
        multiple of 8."""

        kh, kw = self.kernel_size
        b, c, h, w = x8.shape
        pad_h, pad_w, out_h, out_w = self._geometry(h, w)
        padded = x8.new_zeros((b, h + 2 * pad_h, w + 2 * pad_w, c))
        padded[:, pad_h:pad_h + h, pad_w:pad_w + w] = x8.permute(0, 2, 3, 1)

        k = kh * kw * c
        cols = x8.new_empty((b, out_h, out_w, k + (-k % _MULTIPLE)))
        cols[..., k:] = 0
        taps = cols[..., :k].view(b, out_h, out_w, kh * kw, c)
        for i in range(kh):
            for j in range(kw):
                taps[:, :, :, i * kw + j] = padded[:, i:i + out_h, j:j + out_w]

        return cols.view(b * out_h * out_w, -1)

    def forward(self, x):
        batch, _, height, width = x.shape
        _, _, out_h, out_w = self._geometry(height, width)
        out = self._forward(x, batch, out_h * out_w)

        return out.view(batch, out_h, out_w, -1).permute(0, 3, 1, 2)


class Int8Dense(_Int8Layer):
    """``nn.Linear`` replacement computing the matmul in int8: (..., K) ->
    (..., N) in ``dtype`` (float32 when None).

    ``weight`` (N, K) and ``bias`` (N,) are initialized as the port's float
    dense layers are (LeCun normal from ``generator``, zero bias). Dynamic
    mode takes one scale per row: a dense contracts over the feature axis
    only, so a loud frame never coarsens another frame's grid.
    """

    def __init__(self, in_features, out_features, dtype=None,
                 static_scale=False, generator=None):
        super().__init__((out_features, in_features), in_features, dtype,
                         static_scale, generator)
        self.in_features = in_features
        self.out_features = out_features

    def quantized_weights(self):
        """(N, K) int8 and the (N,) float32 scales."""

        return quantize_symmetric(self.weight, axis=0)

    def _row_bytes(self, x):
        # A row counted by its float32 copy
        return 4 * x.shape[-1]

    def _quantize(self, xf, s_x):
        if self.static_scale:
            return _round_clip(xf, s_x), s_x

        # Per-row dynamic scales, (rows, 1, 1) against (rows, 1, out)
        scale = _amax_scale(xf.abs().amax(dim=-1, keepdim=True))

        return _round_clip(xf, scale), scale.unsqueeze(-1)

    def operand(self, x8):
        """(rows, K) int8 as it is."""

        return x8.reshape(-1, x8.shape[-1])

    def forward(self, x):
        lead, k = x.shape[:-1], x.shape[-1]
        x = x.reshape(-1, k)
        out = self._forward(x, x.shape[0], 1)

        return out.view(lead + (self.out_features,))


def int8_layers(model):
    """``(name, layer)`` of every int8 layer of ``model``."""

    return [(name, module) for name, module in model.named_modules()
            if isinstance(module, _Int8Layer)]


def validate_quant_stats(model, context='static int8 serving'):
    """Raise if static-scale serving would run on uncalibrated stats.

    A static model whose scales were never calibrated (a float checkpoint,
    or a fresh model) holds ``act_amax = 0``; serving with that saturates
    every activation to +-127 and rescales to about 0, so the pipeline
    would decode garbage. The pipelines call this at construction.
    """

    stats = [(name, layer.act_amax) for name, layer in int8_layers(model)
             if layer.static_scale]
    if not stats:
        raise ValueError(
            f'{context}: the model carries no "{QUANT_STATS}" (no static '
            f'int8 layer) — run serving.calibrate_quant_stats on '
            f'representative audio first.')

    for name, amax in stats:
        if float(amax) <= 0.0:
            raise ValueError(
                f'{context}: calibrated activation scale {name}.act_amax is '
                f'zero (never calibrated on real audio) — run '
                f'serving.calibrate_quant_stats on representative audio '
                f'first.')
