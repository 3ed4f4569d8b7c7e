"""LSTM recurrence: the Hopper kernels and their plain PyTorch versions.

Port of the fused Pallas kernels of ``amt_tools_tpu/ops/pallas_lstm.py``:

- :func:`lstm_scan` (kernel B, ``_lstm_kernel`` through
  ``lstm_scan_pallas``): the whole-sequence recurrence from a zero carry
  over hoisted input projections, forward only;
- :func:`lstm_scan_residuals` (kernel E, ``_lstm_fwd_res_kernel`` through
  ``_lstm_fwd_res``): the same recurrence, which also returns the float32
  gate activations and cell states;
- :func:`lstm_bptt` (kernel F, ``_lstm_bwd_kernel`` through
  ``_lstm_grad_bwd``): backpropagation through time from those residuals;
- :func:`lstm_scan_grad`: the custom VJP ``lstm_scan_pallas_grad``
  (``:369-440``) as a ``torch.autograd.Function`` over E and F.

B and E launch ``csrc/lstm_scan.cu`` and F ``csrc/lstm_bptt.cu`` for CUDA
tensors; CPU tensors run the ``*_plain`` versions, Python loops over T that
repeat the kernels' arithmetic. All three run as thread-block clusters of 8
CTAs, each CTA owning H/8 hidden units and holding their slice of W_h (B,
E: H x 4H/8) or of W_h^T (F: 4H x H/8) on chip; B and E exchange h, F
exchanges da. What sets a launch (rows a cluster, clusters, a resident or
streamed slice, shared memory) is computed here, by :func:`scan_geometry`
or :func:`bptt_geometry` and :func:`cluster_plan`, from the card's answer
to ``cudaOccupancyMaxActiveClusters``.

Numerics follow the Pallas kernels (``pallas_lstm.py:71-109``, ``:260-288``):
the carries are float32; with bf16 projections the recurrent product reads
bf16 ``h`` and ``W_h`` with float32 accumulation, the gates round to bf16,
the sigmoid takes the tanh form ``0.5 * tanh(0.5 x) + 0.5``, and the BPTT
product reads ``da`` rounded to bf16 and a bf16 ``W_h^T``. The JAX XLA scan
instead rounds the carry to bf16; the port follows the kernels.
"""

import ctypes

import torch

from . import cuda_build

__all__ = ['lstm_scan', 'lstm_scan_plain', 'lstm_scan_residuals',
           'lstm_scan_residuals_plain', 'lstm_bptt', 'lstm_bptt_plain',
           'lstm_scan_grad', 'LSTMScanGrad', 'scan_geometry',
           'scan_resident', 'scan_max_rows', 'bptt_geometry',
           'bptt_resident', 'bptt_max_rows', 'cluster_plan',
           'scan_launch_plan', 'bptt_launch_plan']

MAX_HIDDEN = 1024  # 16 warps a CTA
CLUSTER = 8        # CTAs a cluster, each owning H / 8 hidden units
MAX_ROWS = 16      # batch rows a cluster (two mma n-tiles)
MAX_THREADS = 512  # threads a CTA
MAX_SHARED_BYTES = 232448  # 227 KB, the most a block may use on Hopper

_POINTER, _INT = ctypes.c_void_p, ctypes.c_int

_SCAN_SIGNATURES = {
    'lstm_scan': [_POINTER] * 3 + [_INT] * 7 + [_POINTER],
    'lstm_scan_residuals': [_POINTER] * 5 + [_INT] * 7 + [_POINTER],
    'lstm_scan_max_active_clusters': [_INT] * 5 + [ctypes.POINTER(_INT)],
    'lstm_scan_smem': [_INT] * 4,
}
_BPTT_SIGNATURES = {
    'lstm_bptt': [_POINTER] * 5 + [_INT] * 7 + [_POINTER],
    'lstm_bptt_max_active_clusters': [_INT] * 4 + [ctypes.POINTER(_INT)],
    'lstm_bptt_smem': [_INT] * 4,
}

_active_clusters = {}


def scan_geometry(hidden, dtype, rows, resident):
    """One CTA of kernels B and E, as ``csrc/lstm_scan.cu``
    ``scan_geometry`` lays it out: units owned, the groups of warps k is
    split over, threads, the rows of W_h a chunk (all H when resident) and
    the shared-memory bytes of the W_h slice (resident, or two streamed
    chunks), the two h buffers, the two xw buffers, the staged h and the
    partial sums of a split k."""

    size = torch.finfo(dtype).bits // 8
    units = hidden // CLUSTER
    units_pad = -(-units // 8) * 8
    # float32 resident: k split over up to 4 groups of warps (512 threads)
    slices = 1
    if size == 4 and resident:
        while (slices < 4 and 8 * units_pad * slices <= MAX_THREADS and
               hidden % (8 * slices) == 0):
            slices *= 2
    chunk = min(hidden, hidden if resident else (32 if size == 2 else 16))
    w_stride = 4 * units_pad + 16 // size
    h_stride = hidden + 16 // size
    row_pad = 8 if rows <= 8 else 16
    w_rows = hidden if resident else 2 * chunk
    parts = {'w': w_rows * w_stride * size,
             'h': 2 * row_pad * h_stride * size,
             'xw': 2 * rows * 4 * units * size,
             'stage': -(-rows * units * size // 16) * 16,
             'partial_sums': ((slices - 1) * 4 * units_pad * 4 *
                              (2 if rows <= 8 else 4) * 4)}

    return {'units': units, 'slices': slices,
            'threads': 4 * units_pad * slices, 'chunk': chunk,
            'parts': parts, 'bytes': sum(parts.values())}


def bptt_geometry(hidden, dtype, rows, resident):
    """One CTA of kernel F, as ``csrc/lstm_bptt.cu`` ``bptt_geometry`` lays
    it out: units owned (padded to an mma tile of 16), the groups of warps
    the k steps are dealt over, threads, the rows of W_h^T a chunk (all 4H
    when resident) and the shared-memory bytes of the W_h^T slice
    (resident, or two streamed chunks), the two da buffers, the two
    residual buffers, the float32 and exchanged da of the step, the
    partial sums of dh_carry and the dc carry."""

    size = torch.finfo(dtype).bits // 8
    four_h = 4 * hidden
    units = hidden // CLUSTER
    units_pad = -(-units // 16) * 16
    chunk = min(four_h, four_h if resident else (128 if size == 2 else 64))
    slices = 1
    if size == 2:  # warps: m-tiles of 16 units x slices of whole k steps
        m_tiles = units_pad // 16
        while (2 * slices * m_tiles <= MAX_THREADS // 32 and
               (chunk // 16) % (2 * slices) == 0):
            slices *= 2
        threads = 32 * m_tiles * slices
    else:  # one thread a (unit, slice)
        while (2 * slices * units_pad <= MAX_THREADS and
               chunk % (8 * slices) == 0):
            slices *= 2
        threads = units_pad * slices
    row_pad = (8 if rows <= 8 else 16) if size == 2 else rows

    def round16(num_bytes):
        return -(-num_bytes // 16) * 16

    gates = round16(rows * 4 * units * 4)
    carry = round16(rows * units * 4)
    parts = {'w': ((four_h if resident else 2 * chunk) *
                   (units_pad + 16 // size) * size),
             'da': 2 * row_pad * (four_h + 16 // size) * size,
             'residuals': 2 * (gates + 2 * carry +
                               round16(rows * units * size)),
             'stage': gates,
             'exchange_stage': round16(rows * 4 * units * 2) if size == 2
             else 0,
             'partial_sums': slices * row_pad * units_pad * 4,
             'dc': carry}

    return {'units': units, 'slices': slices, 'threads': threads,
            'chunk': chunk, 'parts': parts, 'bytes': sum(parts.values())}


def _fits(geometry, hidden, dtype, rows, resident):
    return geometry(hidden, dtype, rows, resident)['bytes'] <= MAX_SHARED_BYTES


def scan_resident(hidden, dtype):
    """Whether kernels B and E keep the CTA's W_h slice (H x 4H/8) in shared
    memory, which they do where it fits beside 8 rows' buffers: float32 up
    to H = 256, bf16 up to H = 448. Above that they stream it each step."""

    return _fits(scan_geometry, hidden, dtype, 8, True)


def bptt_resident(hidden, dtype):
    """Whether kernel F keeps the CTA's W_h^T slice (4H x H/8) in shared
    memory, which it does where it fits beside 4 rows' buffers (its da
    buffers hold 4H values a row, four times B's h): float32 up to H = 256,
    bf16 up to H = 352. Above that it streams the slice each step."""

    return _fits(bptt_geometry, hidden, dtype, 4, True)


def _max_rows(geometry, hidden, dtype, resident):
    rows = MAX_ROWS
    while rows > 1 and not _fits(geometry, hidden, dtype, rows, resident):
        rows -= 1

    return rows


def scan_max_rows(hidden, dtype, resident):
    """The most batch rows (up to ``MAX_ROWS``) a cluster's buffers fit."""

    return _max_rows(scan_geometry, hidden, dtype, resident)


def bptt_max_rows(hidden, dtype, resident):
    """The most batch rows (up to ``MAX_ROWS``) kernel F's buffers fit."""

    return _max_rows(bptt_geometry, hidden, dtype, resident)


# kernel -> (its geometry, its residency rule, its library and occupancy
# query)
_CLUSTER_KERNELS = {
    'scan': (scan_geometry, scan_resident, 'lstm_scan',
             'lstm_scan_max_active_clusters'),
    'bptt': (bptt_geometry, bptt_resident, 'lstm_bptt',
             'lstm_bptt_max_active_clusters'),
}


def cluster_plan(batch, hidden, dtype, active_clusters, kernel='scan'):
    """Rows a cluster and clusters for a batch, given how many clusters the
    card holds at once: the fewest rows that put every cluster in one wave
    (at B = 128 and 16 active clusters, 8 rows and 16 clusters; at B = 8,
    one row and 8 clusters), within what the buffers fit. ``waves`` is 1
    unless the batch needs more rows than fit. ``kernel`` is ``'scan'`` (B,
    E) or ``'bptt'`` (F)."""

    geometry, resident_rule = _CLUSTER_KERNELS[kernel][:2]
    resident = resident_rule(hidden, dtype)
    max_rows = _max_rows(geometry, hidden, dtype, resident)
    rows = min(max_rows, max(1, -(-batch // active_clusters)))
    clusters = -(-batch // rows)

    return {'rows': rows, 'clusters': clusters, 'ctas': CLUSTER * clusters,
            'resident': resident, 'max_rows': max_rows,
            'active_clusters': active_clusters,
            'waves': -(-clusters // active_clusters),
            'smem_bytes': geometry(hidden, dtype, rows, resident)['bytes'],
            'threads': geometry(hidden, dtype, rows, resident)['threads']}


def _launch_plan(kernel, batch, hidden, dtype, device, residuals=False):
    """:func:`cluster_plan` for a launch on ``device``, with the card's
    answer to ``cudaOccupancyMaxActiveClusters`` at the largest rows the
    buffers fit (cached per device and configuration)."""

    geometry, resident_rule, library, query = _CLUSTER_KERNELS[kernel]
    resident = resident_rule(hidden, dtype)
    max_rows = _max_rows(geometry, hidden, dtype, resident)
    bf16 = int(dtype == torch.bfloat16)
    key = (kernel, device, hidden, bf16, residuals)
    if key not in _active_clusters:
        signatures = _SCAN_SIGNATURES if kernel == 'scan' else _BPTT_SIGNATURES
        lib = cuda_build.library(library, signatures)
        count = _INT(0)
        flags = (int(residuals),) if kernel == 'scan' else ()
        with torch.cuda.device(device):
            status = getattr(lib, query)(hidden, bf16, *flags, max_rows,
                                         int(resident), ctypes.byref(count))
        cuda_build.check(status, f'{library} occupancy query')
        if count.value < 1:
            raise RuntimeError(f'the card holds no cluster of the {library} '
                               f'kernel at hidden={hidden}, {dtype}')
        _active_clusters[key] = count.value

    return cluster_plan(batch, hidden, dtype, _active_clusters[key], kernel)


def scan_launch_plan(batch, hidden, dtype, device, residuals=False):
    """The launch of kernel B (E with ``residuals``) on ``device``."""

    return _launch_plan('scan', batch, hidden, dtype, device, residuals)


def bptt_launch_plan(batch, hidden, dtype, device):
    """The launch of kernel F on ``device``."""

    return _launch_plan('bptt', batch, hidden, dtype, device)


def _sigmoid_tanh_form(x):
    return 0.5 * torch.tanh(0.5 * x) + 0.5


def _scan_plain(xw, w_h, reverse, residuals):
    """The recurrence of kernels B and E, step by step."""

    batch, frames, four_h = xw.shape
    hidden = four_h // 4
    bf16 = xw.dtype == torch.bfloat16

    # bf16 operands are exact in float32, so this is the kernel's product
    # with float32 accumulation
    w = w_h.to(xw.dtype).float()
    h = torch.zeros((batch, hidden), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    out = torch.empty((batch, frames, hidden), dtype=xw.dtype,
                      device=xw.device)
    if residuals:
        gates_seq = torch.empty((batch, frames, four_h), dtype=torch.float32,
                                device=xw.device)
        c_seq = torch.empty((batch, frames, hidden), dtype=torch.float32,
                            device=xw.device)

    steps = range(frames - 1, -1, -1) if reverse else range(frames)
    for t in steps:
        gates = xw[:, t].float() + h.to(xw.dtype).float() @ w
        if bf16:
            gates = gates.to(torch.bfloat16)
            i_g = _sigmoid_tanh_form(gates[:, 0 * hidden: 1 * hidden])
            f_g = _sigmoid_tanh_form(gates[:, 1 * hidden: 2 * hidden])
            g_g = torch.tanh(gates[:, 2 * hidden: 3 * hidden])
            o_g = _sigmoid_tanh_form(gates[:, 3 * hidden: 4 * hidden])
            c = f_g.float() * c + (i_g * g_g).float()
            h = o_g.float() * torch.tanh(c)
        else:
            i_g = torch.sigmoid(gates[:, 0 * hidden: 1 * hidden])
            f_g = torch.sigmoid(gates[:, 1 * hidden: 2 * hidden])
            g_g = torch.tanh(gates[:, 2 * hidden: 3 * hidden])
            o_g = torch.sigmoid(gates[:, 3 * hidden: 4 * hidden])
            c = f_g * c + i_g * g_g
            h = o_g * torch.tanh(c)
        out[:, t] = h.to(xw.dtype)
        if residuals:
            gates_seq[:, t] = torch.cat([i_g, f_g, g_g, o_g], dim=-1).float()
            c_seq[:, t] = c

    return (out, gates_seq, c_seq) if residuals else out


def lstm_scan_plain(xw, w_h, reverse=False):
    """(B, T, 4H) projections, (H, 4H) weights -> (B, T, H): a loop over T."""

    return _scan_plain(xw, w_h, reverse, residuals=False)


def lstm_scan_residuals_plain(xw, w_h, reverse=False):
    """:func:`lstm_scan_plain` that also returns the float32 gate
    activations (B, T, 4H) and cell states (B, T, H)."""

    return _scan_plain(xw, w_h, reverse, residuals=True)


def lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse=False):
    """BPTT from the residuals -> da (B, T, 4H) float32: a loop over T,
    opposite to the forward's direction ``reverse``.

    ``dout`` (B, T, H) and ``w_h_t`` (4H, H) are in the forward's compute
    dtype; the carry product reads ``da`` rounded to that dtype.
    """

    batch, frames, four_h = gates.shape
    hidden = four_h // 4
    w = w_h_t.float()

    dh_carry = torch.zeros((batch, hidden), dtype=torch.float32,
                           device=gates.device)
    dc_carry = torch.zeros_like(dh_carry)
    zero = torch.zeros_like(dh_carry)
    da = torch.empty((batch, frames, four_h), dtype=torch.float32,
                     device=gates.device)

    steps = range(frames) if reverse else range(frames - 1, -1, -1)
    for t in steps:
        t_prev = t + 1 if reverse else t - 1
        c_prev = c_seq[:, t_prev] if 0 <= t_prev < frames else zero

        i_g, f_g, g_g, o_g = gates[:, t].split(hidden, dim=-1)
        c_t = c_seq[:, t]
        tanh_c = torch.tanh(c_t)

        dh = dout[:, t].float() + dh_carry
        da_o = dh * tanh_c * o_g * (1.0 - o_g)
        dc = dc_carry + dh * o_g * (1.0 - tanh_c * tanh_c)
        da_i = dc * g_g * i_g * (1.0 - i_g)
        da_g = dc * i_g * (1.0 - g_g * g_g)
        da_f = dc * c_prev * f_g * (1.0 - f_g)
        dc_carry = dc * f_g

        step = torch.cat([da_i, da_f, da_g, da_o], dim=-1)
        da[:, t] = step
        dh_carry = step.to(w_h_t.dtype).float() @ w

    return da


def _check_inputs(xw, w_h):
    if xw.dim() != 3 or xw.shape[-1] % 4:
        raise ValueError(f'xw must be (B, T, 4H), got shape {tuple(xw.shape)}')
    hidden = xw.shape[-1] // 4
    if tuple(w_h.shape) != (hidden, 4 * hidden):
        raise ValueError(f'w_h must be ({hidden}, {4 * hidden}), got '
                         f'{tuple(w_h.shape)}')
    if xw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'lstm_scan takes float32 or bf16 xw, got {xw.dtype}')
    if w_h.dtype != xw.dtype:
        raise TypeError(f'w_h ({w_h.dtype}) must match xw ({xw.dtype})')
    if xw.device != w_h.device:
        raise ValueError(f'xw on {xw.device} but w_h on {w_h.device}')
    if not (xw.is_contiguous() and w_h.is_contiguous()):
        raise ValueError('lstm_scan takes contiguous xw and w_h')


def _check_cuda(x, name, hidden):
    if x.device.type != 'cuda':
        raise ValueError(f'{name} runs on CUDA or CPU tensors, not '
                         f'{x.device}')
    if hidden > MAX_HIDDEN:
        raise ValueError(f'{name} kernel supports hidden <= {MAX_HIDDEN}, '
                         f'got {hidden}')


def _aligned(x):
    """``x``, or a copy of it where its data does not start on 16 bytes."""

    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_scan(xw, w_h, reverse, residuals):
    """Kernel B, or E with ``residuals``, on CUDA tensors."""

    batch, frames, four_h = xw.shape
    hidden = four_h // 4
    name = 'lstm_scan_residuals' if residuals else 'lstm_scan'
    _check_cuda(xw, name, hidden)
    if hidden % 16:
        raise ValueError(f'{name} kernel supports hidden a multiple of 16 '
                         f'(8 CTAs of whole bf16 pairs), got {hidden}')

    out = torch.empty((batch, frames, hidden), dtype=xw.dtype,
                      device=xw.device)
    outputs = [out]
    if residuals:
        outputs += [torch.empty((batch, frames, four_h), dtype=torch.float32,
                                device=xw.device),
                    torch.empty((batch, frames, hidden), dtype=torch.float32,
                                device=xw.device)]
    if batch == 0 or frames == 0:
        return tuple(outputs) if residuals else out

    plan = scan_launch_plan(batch, hidden, xw.dtype, xw.device, residuals)
    xw, w_h = _aligned(xw), _aligned(w_h)
    lib = cuda_build.library('lstm_scan', _SCAN_SIGNATURES)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, name)(
            xw.data_ptr(), w_h.data_ptr(), *(t.data_ptr() for t in outputs),
            batch, frames, hidden, int(reverse),
            int(xw.dtype == torch.bfloat16), plan['rows'],
            int(plan['resident']), stream)
    cuda_build.check(status, name)

    return tuple(outputs) if residuals else out


def lstm_scan(xw, w_h, reverse=False):
    """Whole-sequence LSTM from a zero carry: (B, T, 4H) -> (B, T, H).

    ``xw`` holds the hoisted input projections including the bias, ``w_h``
    the (H, 4H) recurrent kernel in the same dtype (float32 or bf16; gate
    order i, f, g, o). ``reverse`` walks back to front and writes outputs in
    natural order. CUDA tensors go through the Hopper kernel (or raise); CPU
    tensors through :func:`lstm_scan_plain`.
    """

    _check_inputs(xw, w_h)

    if xw.device.type == 'cpu':
        return lstm_scan_plain(xw, w_h, reverse)

    out = _launch_scan(xw, w_h, reverse, residuals=False)
    lstm_scan.launches += 1

    return out


lstm_scan.launches = 0


def lstm_scan_residuals(xw, w_h, reverse=False):
    """:func:`lstm_scan` that also returns the residuals of the backward:
    ``(out, gates, c)`` with float32 gate activations (B, T, 4H) in order
    i, f, g, o and float32 cell states (B, T, H). CUDA tensors go through
    kernel E (or raise); CPU tensors through
    :func:`lstm_scan_residuals_plain`."""

    _check_inputs(xw, w_h)

    if xw.device.type == 'cpu':
        return lstm_scan_residuals_plain(xw, w_h, reverse)

    outputs = _launch_scan(xw, w_h, reverse, residuals=True)
    lstm_scan_residuals.launches += 1

    return outputs


lstm_scan_residuals.launches = 0


def _check_bptt_inputs(gates, c_seq, dout, w_h_t):
    if gates.dim() != 3 or gates.shape[-1] % 4:
        raise ValueError(f'gates must be (B, T, 4H), got shape '
                         f'{tuple(gates.shape)}')
    batch, frames, four_h = gates.shape
    hidden = four_h // 4
    shapes = {'c_seq': (c_seq, (batch, frames, hidden)),
              'dout': (dout, (batch, frames, hidden)),
              'w_h_t': (w_h_t, (four_h, hidden))}
    for name, (tensor, shape) in shapes.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f'{name} must be {shape}, got '
                             f'{tuple(tensor.shape)}')
    if gates.dtype != torch.float32 or c_seq.dtype != torch.float32:
        raise TypeError('lstm_bptt takes float32 gates and c_seq')
    if dout.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'lstm_bptt takes float32 or bf16 dout, got '
                        f'{dout.dtype}')
    if w_h_t.dtype != dout.dtype:
        raise TypeError(f'w_h_t ({w_h_t.dtype}) must match dout '
                        f'({dout.dtype})')
    tensors = (gates, c_seq, dout, w_h_t)
    if any(t.device != gates.device for t in tensors):
        raise ValueError('lstm_bptt takes its tensors on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('lstm_bptt takes contiguous tensors')


def lstm_bptt(gates, c_seq, dout, w_h_t, reverse=False):
    """BPTT over the residuals of :func:`lstm_scan_residuals` -> d(xw) as
    float32 (B, T, 4H).

    ``gates`` (B, T, 4H) and ``c_seq`` (B, T, H) are float32; ``dout``
    (B, T, H) and the transposed recurrent kernel ``w_h_t`` (4H, H) are in
    the forward's compute dtype (float32 or bf16). ``reverse`` names the
    forward's direction. CUDA tensors go through kernel F (or raise); CPU
    tensors through :func:`lstm_bptt_plain`.
    """

    _check_bptt_inputs(gates, c_seq, dout, w_h_t)

    if gates.device.type == 'cpu':
        return lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse)

    batch, frames, four_h = gates.shape
    hidden = four_h // 4
    _check_cuda(gates, 'lstm_bptt', hidden)
    if hidden % 16:
        raise ValueError(f'lstm_bptt kernel supports hidden a multiple of 16 '
                         f'(8 CTAs of whole bf16 pairs), got {hidden}')

    da = torch.empty((batch, frames, four_h), dtype=torch.float32,
                     device=gates.device)
    if batch == 0 or frames == 0:
        return da

    plan = bptt_launch_plan(batch, hidden, dout.dtype, gates.device)
    gates, c_seq, dout, w_h_t = (_aligned(t) for t in (gates, c_seq, dout,
                                                       w_h_t))
    lib = cuda_build.library('lstm_bptt', _BPTT_SIGNATURES)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.lstm_bptt(gates.data_ptr(), c_seq.data_ptr(),
                               dout.data_ptr(), w_h_t.data_ptr(),
                               da.data_ptr(), batch, frames, hidden,
                               int(reverse),
                               int(dout.dtype == torch.bfloat16),
                               plan['rows'], int(plan['resident']), stream)
    cuda_build.check(status, 'lstm_bptt')
    lstm_bptt.launches += 1

    return da


lstm_bptt.launches = 0


def _shift_prev(x, reverse):
    """The previous step's value at each t (zero at the sequence's start):
    t - 1 for a forward scan, t + 1 for a reverse one."""

    zero = torch.zeros_like(x[:, :1])
    if reverse:
        return torch.cat([x[:, 1:], zero], dim=1)

    return torch.cat([zero, x[:, :-1]], dim=1)


class LSTMScanGrad(torch.autograd.Function):
    """The differentiable recurrence: kernel E forward, kernel F backward.

    Takes ``w_h`` in its parameter dtype and casts it to the compute dtype
    inside (bf16 when ``xw`` is bf16, else float32), so ``dW_h`` comes back
    in the parameter's own dtype, as ``_lstm_grad_bwd`` returns it
    (``pallas_lstm.py:406-437``).
    """

    @staticmethod
    def forward(ctx, xw, w_h, reverse):
        out, gates, c_seq = lstm_scan_residuals(
            xw.contiguous(), w_h.to(xw.dtype).contiguous(), reverse)
        ctx.reverse = reverse
        ctx.w_dtype = w_h.dtype
        ctx.save_for_backward(w_h, out, gates, c_seq)

        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        w_h, out, gates, c_seq = ctx.saved_tensors
        hidden = out.shape[-1]

        w_h_t = w_h.t().to(out.dtype).contiguous()
        da = lstm_bptt(gates, c_seq, dout.to(out.dtype).contiguous(), w_h_t,
                       ctx.reverse)

        # dW_h = sum_t h_prev^T da: one float32 matmul outside the kernel
        h_prev = _shift_prev(out, ctx.reverse).float()
        dw_h = h_prev.reshape(-1, hidden).t() @ da.reshape(-1, 4 * hidden)

        return da.to(out.dtype), dw_h.to(ctx.w_dtype), None


def lstm_scan_grad(xw, w_h, reverse=False):
    """Differentiable :func:`lstm_scan`: (B, T, 4H) float32 or bf16 ``xw``,
    (H, 4H) ``w_h`` in any float dtype -> (B, T, H) in xw's dtype.

    The same outputs as :func:`lstm_scan` (kernel E is kernel B's body);
    under autograd the backward runs kernel F and returns ``d(xw)`` in xw's
    dtype and ``dW_h`` in w_h's.
    """

    return LSTMScanGrad.apply(xw, w_h, reverse)
