"""GRU recurrence: the Hopper kernel G and its plain PyTorch version.

The JAX package has no GRU, so no TPU kernel stands behind this one. It
serves the bidirectional GRUs of the High-resolution Piano Transcription
model (``models/hpt.py`` through ``ops/gru.py``): G independent sequences in
one launch, each with its own recurrent weights, the groups from
``reverse_from`` on walking back to front, as kernel B does
(``ops/lstm_kernel.py`` ``lstm_scan_grouped``).

Over hoisted input projections ``xw`` (G, B, T, 3H) that already hold
``b_ih`` and the hidden biases of the r and z gates, recurrent weights
``w_h`` (G, H, 3H) (``torch.nn.GRU``'s ``weight_hh`` transposed, gate
columns r, z, n) and the n gate's hidden bias ``b_hn`` (G, H), from a zero
carry::

    hp = h @ w_h
    r = sigmoid(xw_r + hp_r);  z = sigmoid(xw_z + hp_z)
    n = tanh(xw_n + r * (hp_n + b_hn))
    h = n + z * (h - n)

``torch.nn.GRU``'s step, with its order of operations in the last line. h
is float32 across the steps; with bf16 projections W_h is bf16, the
recurrent product reads h rounded to bf16 with float32 accumulation, and
the output is h rounded to bf16.

:func:`gru_scan_grouped` checks its inputs and calls the custom op
``torch.ops.amt_tools_tpu_torch.gru_scan_grouped``
(:data:`gru_scan_grouped_op`), which launches ``csrc/gru_scan.cu`` on CUDA
tensors (and counts the launch in ``gru_scan_grouped.launches``) and runs
:func:`gru_scan_plain`, a loop over T, on CPU tensors. :func:`gru_scan_cost`
is the op's FLOP formula and byte count. :func:`gru_supported` says which
widths the kernel takes: H a multiple of 16 whose W_h slice fits in shared
memory (up to H = 512 in bf16, 352 in float32).
"""

import ctypes

import torch

from . import cuda_build

__all__ = ['gru_scan_grouped', 'gru_scan_grouped_op', 'gru_scan_plain',
           'gru_scan_cost', 'gru_geometry', 'gru_supported',
           'gru_launch_plan']

CLUSTER = 8        # CTAs a cluster, each owning H / 8 hidden units
MAX_ROWS = 32      # batch rows a cluster (four mma n-tiles)
MAX_THREADS = 512  # threads a CTA
MAX_SHARED_BYTES = 232448  # 227 KB, the most a block may use on Hopper

_POINTER, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'gru_scan_grouped': [_POINTER] * 4 + [_INT] * 7 + [_POINTER],
    'gru_scan_max_active_clusters': [_INT] * 3 + [ctypes.POINTER(_INT)],
    'gru_scan_smem': [_INT] * 3,
}

_active_clusters = {}


def _round16(num_bytes):
    return -(-num_bytes // 16) * 16


def gru_geometry(hidden, dtype, rows):
    """One CTA of kernel G, as ``csrc/gru_scan.cu`` ``gru_geometry`` lays it
    out: units owned, threads, and the shared-memory bytes of the W_h slice
    (H x 3H/8), the two h buffers, the two xw buffers and the staged h."""

    size = torch.finfo(dtype).bits // 8
    units = hidden // CLUSTER
    units_pad = -(-units // 8) * 8
    row_pad = -(-rows // 8) * 8
    parts = {'w': _round16(hidden * (3 * units_pad + 16 // size) * size),
             'h': _round16(2 * row_pad * (hidden + 16 // size) * size),
             'xw': _round16(2 * rows * 3 * units * size),
             'stage': _round16(rows * units * size)}

    return {'units': units, 'threads': 4 * units_pad, 'parts': parts,
            'bytes': sum(parts.values())}


def _fits(hidden, dtype, rows):
    geometry = gru_geometry(hidden, dtype, rows)

    return (geometry['bytes'] <= MAX_SHARED_BYTES and
            geometry['threads'] <= MAX_THREADS)


def gru_supported(hidden, dtype):
    """Whether kernel G takes ``hidden`` units a direction in ``dtype``
    (float32 or bf16): H a multiple of 16 (8 CTAs of whole bf16 pairs) and
    one row's buffers within a block's shared memory."""

    return (hidden > 0 and hidden % 16 == 0 and
            dtype in (torch.float32, torch.bfloat16) and
            _fits(hidden, dtype, 1))


def _max_rows(hidden, dtype):
    rows = MAX_ROWS
    while rows > 1 and not _fits(hidden, dtype, rows):
        rows -= 1

    return rows


def cluster_plan(batch, hidden, dtype, active_clusters, groups=1):
    """Rows a cluster and clusters for a launch of ``groups`` sequences of
    ``batch`` rows, given how many clusters the card holds at once
    (:func:`cuda_build.cluster_rows`)."""

    max_rows = _max_rows(hidden, dtype)
    rows = cuda_build.cluster_rows(batch, groups, max_rows, active_clusters)
    clusters = groups * -(-batch // rows)

    return {'rows': rows, 'clusters': clusters, 'ctas': CLUSTER * clusters,
            'groups': groups, 'max_rows': max_rows,
            'active_clusters': active_clusters,
            'waves': -(-clusters // active_clusters),
            'smem_bytes': gru_geometry(hidden, dtype, rows)['bytes'],
            'threads': gru_geometry(hidden, dtype, rows)['threads']}


def gru_launch_plan(batch, hidden, dtype, device, groups=1):
    """:func:`cluster_plan` for a launch on ``device``, with the card's
    answer to ``cudaOccupancyMaxActiveClusters`` at the most rows the
    buffers fit (cached per device and configuration)."""

    max_rows = _max_rows(hidden, dtype)
    bf16 = int(dtype == torch.bfloat16)

    def query_card():
        lib = cuda_build.library('gru_scan', _SIGNATURES)
        count = _INT(0)
        with torch.cuda.device(device):
            status = lib.gru_scan_max_active_clusters(hidden, bf16, max_rows,
                                                      ctypes.byref(count))
        cuda_build.check(status, 'gru_scan occupancy query')
        if count.value < 1:
            raise RuntimeError(f'the card holds no cluster of the gru_scan '
                               f'kernel at hidden={hidden}, {dtype}')
        return count.value

    active = cuda_build.cached(_active_clusters, (device, hidden, bf16),
                               query_card)

    return cluster_plan(batch, hidden, dtype, active, groups)


def _scan_plain(xw, w_h, b_hn, reverse):
    """One sequence: (B, T, 3H), (H, 3H), (H,) -> (B, T, H), step by step,
    with the kernel's arithmetic (the module docstring)."""

    batch, frames, three_h = xw.shape
    hidden = three_h // 3
    # bf16 operands are exact in float32, so this is the kernel's product
    # with float32 accumulation
    w = w_h.to(xw.dtype).float()
    b_hn = b_hn.float()
    h = xw.new_zeros((batch, hidden), dtype=torch.float32)
    out = [None] * frames
    for t in (range(frames - 1, -1, -1) if reverse else range(frames)):
        hp = h.to(xw.dtype).float() @ w
        x = xw[:, t].float()
        r = torch.sigmoid(x[:, :hidden] + hp[:, :hidden])
        z = torch.sigmoid(x[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
        n = torch.tanh(x[:, 2 * hidden:] + r * (hp[:, 2 * hidden:] + b_hn))
        h = n + z * (h - n)
        out[t] = h.to(xw.dtype)

    if not frames:
        return xw.new_empty((batch, 0, hidden))

    return torch.stack(out, dim=1)


def gru_scan_plain(xw, w_h, b_hn, reverse_from):
    """(G, B, T, 3H) projections, (G, H, 3H) weights, (G, H) n-gate hidden
    biases -> (G, B, T, H): a loop over T a group, the groups from
    ``reverse_from`` on reversed. Differentiable (plain torch ops)."""

    return torch.stack([_scan_plain(xw[g], w_h[g], b_hn[g],
                                    g >= reverse_from)
                        for g in range(xw.shape[0])])


def _check_inputs(xw, w_h, b_hn, reverse_from):
    cuda_build.require_plain('gru_scan', xw=xw, w_h=w_h, b_hn=b_hn)
    if xw.dim() != 4 or xw.shape[-1] % 3:
        raise ValueError(f'xw must be (G, B, T, 3H), got shape '
                         f'{tuple(xw.shape)}')
    groups, hidden = xw.shape[0], xw.shape[-1] // 3
    if tuple(w_h.shape) != (groups, hidden, 3 * hidden):
        raise ValueError(f'w_h must be {(groups, hidden, 3 * hidden)}, got '
                         f'{tuple(w_h.shape)}')
    if tuple(b_hn.shape) != (groups, hidden):
        raise ValueError(f'b_hn must be {(groups, hidden)}, got '
                         f'{tuple(b_hn.shape)}')
    if xw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'gru_scan takes float32 or bf16 xw, got {xw.dtype}')
    if w_h.dtype != xw.dtype:
        raise TypeError(f'w_h ({w_h.dtype}) must match xw ({xw.dtype})')
    if b_hn.dtype != torch.float32:
        raise TypeError(f'b_hn must be float32, got {b_hn.dtype}')
    for name, t in (('w_h', w_h), ('b_hn', b_hn)):
        if t.device != xw.device:
            raise ValueError(f'xw on {xw.device} but {name} on {t.device}')
    if not (xw.is_contiguous() and w_h.is_contiguous() and
            b_hn.is_contiguous()):
        raise ValueError('gru_scan takes contiguous xw, w_h and b_hn')
    if not 0 <= reverse_from <= groups:
        raise ValueError(f'reverse_from must lie in [0, {groups}], got '
                         f'{reverse_from}')


def gru_scan_cost(batch, frames, hidden, dtype, groups=1):
    """``(flops, bytes)`` of one launch of kernel G over ``groups``
    sequences: the recurrent product, 2 H 3H operations a row and step; xw
    and W_h read and h written once in ``dtype``, b_hn read in float32."""

    size = torch.finfo(dtype).bits // 8
    rows = batch * frames
    flops = 2.0 * rows * hidden * 3 * hidden
    num_bytes = size * (rows * 3 * hidden + hidden * 3 * hidden +
                        rows * hidden) + 4 * hidden

    return groups * flops, float(groups * num_bytes)


def _aligned(x):
    """``x``, or a copy of it where its data does not start on 16 bytes."""

    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(xw, w_h, b_hn, reverse_from):
    """Kernel G on CUDA tensors; counts the launch."""

    if xw.device.type != 'cuda':
        raise ValueError(f'gru_scan runs on CUDA or CPU tensors, not '
                         f'{xw.device}')
    groups, batch, frames, three_h = xw.shape
    hidden = three_h // 3
    if not gru_supported(hidden, xw.dtype):
        raise ValueError(f'the gru_scan kernel takes hidden a multiple of 16 '
                         f'whose weights fit in shared memory, got {hidden} '
                         f'in {xw.dtype}')

    out = torch.empty((groups, batch, frames, hidden), dtype=xw.dtype,
                      device=xw.device)
    if out.numel() == 0:
        return out

    plan = gru_launch_plan(batch, hidden, xw.dtype, xw.device, groups)
    xw, w_h = _aligned(xw), _aligned(w_h)
    lib = cuda_build.library('gru_scan', _SIGNATURES)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.gru_scan_grouped(
            xw.data_ptr(), w_h.data_ptr(), b_hn.data_ptr(), out.data_ptr(),
            groups, reverse_from, batch, frames, hidden,
            int(xw.dtype == torch.bfloat16), plan['rows'], stream)
    cuda_build.check(status, 'gru_scan_grouped')
    cuda_build.count(gru_scan_grouped, 'launches')

    return out


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::gru_scan_grouped',
                         mutates_args=())
def gru_scan_grouped_op(xw: torch.Tensor, w_h: torch.Tensor,
                        b_hn: torch.Tensor, reverse_from: int) -> torch.Tensor:
    """Kernel G as an op: the launch on CUDA tensors, the plain version on
    CPU tensors (inputs as :func:`gru_scan_grouped` checks them)."""

    if xw.device.type == 'cpu':
        return gru_scan_plain(xw, w_h, b_hn, reverse_from)

    return _launch(xw, w_h, b_hn, reverse_from)


@gru_scan_grouped_op.register_fake
def _(xw, w_h, b_hn, reverse_from):
    return xw.new_empty(xw.shape[:-1] + (xw.shape[-1] // 3,))


def _op_cost(xw, w_h, b_hn, reverse_from):
    groups, batch, frames, three_h = xw.shape

    return gru_scan_cost(batch, frames, three_h // 3, xw.dtype, groups)


cuda_build.register_cost(gru_scan_grouped_op, _op_cost)


def gru_scan_grouped(xw, w_h, b_hn, reverse_from):
    """G whole-sequence GRUs in one launch: (G, B, T, 3H) projections,
    (G, H, 3H) recurrent kernels in the projections' dtype (float32 or
    bf16) and (G, H) float32 n-gate hidden biases -> (G, B, T, H), the
    groups from ``reverse_from`` on walking back to front.

    CUDA tensors go through kernel G, one launch (or raise); CPU tensors
    through :func:`gru_scan_plain`; both through
    :data:`gru_scan_grouped_op`. ``gru_scan_grouped.launches`` counts the
    kernel's launches. Not differentiable: ``ops/gru.py`` takes the plain
    version where autograd records."""

    _check_inputs(xw, w_h, b_hn, reverse_from)

    return gru_scan_grouped_op(xw, w_h, b_hn, int(reverse_from))


gru_scan_grouped.launches = 0
