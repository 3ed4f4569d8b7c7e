"""LSTM recurrence: the Hopper kernels and their plain PyTorch versions.

Port of the fused Pallas kernels of ``amt_tools_tpu/ops/pallas_lstm.py``:

- :func:`lstm_scan` (kernel B, ``_lstm_kernel`` through
  ``lstm_scan_pallas``): the whole-sequence recurrence from a zero carry
  over hoisted input projections, forward only; with per-row ``lengths``
  (bucketed evaluation) a row keeps its carry and writes 0 past its
  length, the JAX masked scan's step (``ops/lstm.py:98-108``) with the
  kernel's float32 carry, so its valid frames equal an unpadded run's bit
  for bit (``lstm_scan.masked_launches`` counts these launches); from a
  given float32 carry ``(c, h)`` in place of zeros, returning the final
  one (streaming, JAX ``FastLSTM(initial_carry, return_carry)``,
  ``ops/lstm.py:208-257``), so chunks that thread the carry equal one
  whole call bit for bit (``lstm_scan.carried_launches``);
- :func:`lstm_scan_residuals` (kernel E, ``_lstm_fwd_res_kernel`` through
  ``_lstm_fwd_res``): the same recurrence, which also returns the float32
  gate activations and cell states, with lengths and from a carry as B
  (``lstm_scan_residuals.masked_launches``, ``.carried_launches``);
- :func:`lstm_bptt` (kernel F, ``_lstm_bwd_kernel`` through
  ``_lstm_grad_bwd``): backpropagation through time from those residuals;
  with lengths a masked step has da = 0 and passes its carries' gradients
  through, and from the gradient of a final carry it returns the initial
  carry's (``lstm_bptt.masked_launches``, ``.carried_launches``);
- :func:`lstm_scan_grad`: the custom VJP ``lstm_scan_pallas_grad``
  (``:369-440``) as a ``torch.autograd.Function`` over E and F
  (:class:`LSTMScanGrad`, masked or not; :class:`LSTMScanCarriedGrad`
  from a carry, returning the final one). The Pallas kernels take neither
  lengths nor a carry, and JAX differentiates those cases through its XLA
  scan (``ops/lstm.py:98-148``); these are its semantics, with the
  kernels' float32 carry;
- :func:`lstm_scan_grouped`, :func:`lstm_scan_residuals_grouped`,
  :func:`lstm_bptt_grouped` and :func:`lstm_scan_grouped_grad`: B, E, F
  and the Function over G independent sequences in one launch each (the
  group on ``blockIdx.y``, the groups from ``reverse_from`` on reversed),
  the card's counterpart of the one grouped scan behind JAX's
  ``GroupedBiLSTM`` (``ops/lstm.py:151-199``); a group's arithmetic is its
  ungrouped launch's, so the results are the per-stream launches' bit for
  bit.

B and E launch ``csrc/lstm_scan.cu`` and F ``csrc/lstm_bptt.cu`` for CUDA
tensors; CPU tensors run the ``*_plain`` versions, Python loops over T that
repeat the kernels' arithmetic. Each wrapper checks its inputs and calls a
custom op of ``torch.ops.amt_tools_tpu_torch``: ``lstm_scan`` (B, with
optional lengths), ``lstm_scan_carried`` (B from the carry ``c0``, ``h0``,
with optional lengths, returning ``(out, c, h)``), ``lstm_scan_residuals``
(E, optional lengths), ``lstm_scan_residuals_carried`` (E from a carry,
returning ``(out, gates, c_seq, c, h)``), ``lstm_bptt`` (F, optional
lengths) and ``lstm_bptt_carried`` (F from ``c0`` and the final carry's
gradient ``dc_last``, ``dh_last``, returning ``(da, dc0, dh0)``). An op's
real implementation launches the kernel and counts the launch on CUDA
tensors and runs the plain version on CPU tensors; :func:`scan_cost` and
:func:`bptt_cost` are their FLOP formulas and byte counts (over the valid
row-steps of a masked launch). The Functions stay
``torch.autograd.Function`` classes over the E and F ops; dW_h = sum
h_prev^T da is one float32 matmul outside the kernel, whose h_prev is h0
at a row's first step when a carry is given (for a reverse row with
lengths, t = lengths - 1). All three kernels run as thread-block clusters
of 8 CTAs, each CTA owning H/8 hidden units and holding their slice of W_h
(B, E: H x 4H/8) or of W_h^T (F: 4H x H/8) on chip; B and E exchange h, F
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
import functools
from typing import Optional

import torch

from . import cuda_build

__all__ = ['lstm_scan', 'lstm_scan_plain', 'lstm_scan_residuals',
           'lstm_scan_residuals_plain', 'lstm_bptt', 'lstm_bptt_plain',
           'lstm_scan_grad', 'LSTMScanGrad', 'scan_geometry',
           'scan_resident', 'scan_max_rows', 'bptt_geometry',
           'bptt_resident', 'bptt_max_rows', 'cluster_plan',
           'scan_launch_plan', 'bptt_launch_plan', 'scan_supported',
           'scan_cost', 'bptt_cost', 'lstm_scan_op', 'lstm_scan_carried_op',
           'lstm_scan_residuals_op', 'lstm_bptt_op', 'lstm_scan_grouped',
           'lstm_scan_grouped_plain', 'lstm_scan_residuals_grouped',
           'lstm_scan_residuals_grouped_plain', 'lstm_bptt_grouped',
           'lstm_bptt_grouped_plain', 'lstm_scan_grouped_grad',
           'LSTMScanGroupedGrad', 'lstm_scan_grouped_op',
           'lstm_scan_residuals_grouped_op', 'lstm_bptt_grouped_op',
           'LSTMScanCarriedGrad', 'lstm_scan_residuals_carried_op',
           'lstm_bptt_carried_op']

MAX_HIDDEN = 1024  # 16 warps a CTA
CLUSTER = 8        # CTAs a cluster, each owning H / 8 hidden units
MAX_ROWS = 16      # batch rows a cluster (two mma n-tiles)
MAX_THREADS = 512  # threads a CTA
MAX_SHARED_BYTES = 232448  # 227 KB, the most a block may use on Hopper

_POINTER, _INT = ctypes.c_void_p, ctypes.c_int

_SCAN_SIGNATURES = {
    'lstm_scan': [_POINTER] * 4 + [_INT] * 7 + [_POINTER],
    'lstm_scan_carried': [_POINTER] * 8 + [_INT] * 7 + [_POINTER],
    'lstm_scan_residuals': [_POINTER] * 6 + [_INT] * 7 + [_POINTER],
    'lstm_scan_residuals_carried': [_POINTER] * 10 + [_INT] * 7 + [_POINTER],
    'lstm_scan_grouped': [_POINTER] * 4 + [_INT] * 8 + [_POINTER],
    'lstm_scan_residuals_grouped': [_POINTER] * 6 + [_INT] * 8 + [_POINTER],
    'lstm_scan_max_active_clusters': [_INT] * 5 + [ctypes.POINTER(_INT)],
    'lstm_scan_smem': [_INT] * 4,
}
_BPTT_SIGNATURES = {
    'lstm_bptt': [_POINTER] * 6 + [_INT] * 7 + [_POINTER],
    'lstm_bptt_carried': [_POINTER] * 11 + [_INT] * 7 + [_POINTER],
    'lstm_bptt_grouped': [_POINTER] * 6 + [_INT] * 8 + [_POINTER],
    'lstm_bptt_max_active_clusters': [_INT] * 5 + [ctypes.POINTER(_INT)],
    'lstm_bptt_smem': [_INT] * 5,
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


def bptt_geometry(hidden, dtype, rows, resident, hold=False):
    """One CTA of kernel F, as ``csrc/lstm_bptt.cu`` ``bptt_geometry`` lays
    it out: units owned (padded to an mma tile of 16), the groups of warps
    the k steps are dealt over, threads, the rows of W_h^T a chunk (all 4H
    when resident) and the shared-memory bytes of the W_h^T slice
    (resident, or two streamed chunks), the two da buffers, the two
    residual buffers, the float32 and exchanged da of the step, the
    partial sums of dh_carry and the dc carry; with ``hold`` (the masked
    and carried launches) also the dh carry a masked step passes on or the
    walk starts from."""

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
    if hold:
        parts['dh'] = carry

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


def cluster_plan(batch, hidden, dtype, active_clusters, kernel='scan',
                 groups=1, hold=False):
    """Rows a cluster and clusters for a batch, given how many clusters the
    card holds at once: the fewest rows that put every cluster in one wave
    (at B = 128 and 16 active clusters, 8 rows and 16 clusters; at B = 8,
    one row and 8 clusters), within what the buffers fit. ``waves`` is 1
    unless the batch needs more rows than fit. ``kernel`` is ``'scan'`` (B,
    E) or ``'bptt'`` (F).

    A grouped launch of ``groups`` sequences gives each group its own
    clusters (a cluster holds one group's W_h), ``groups * ceil(batch /
    rows)`` of them: the fewest rows that still fit one wave (G = 4, B = 8:
    2 rows, 16 clusters; G = 6, B = 8: 4 rows, 12 clusters), and the most
    rows the buffers fit where none does (G = 4, B = 128: 16 rows, 32
    clusters, 2 waves). ``groups=1`` is the ungrouped plan. ``hold`` sizes
    kernel F's masked or carried launch, whose dh buffer may fit fewer
    rows; it keeps the unmasked launch's residency."""

    geometry, resident_rule = _CLUSTER_KERNELS[kernel][:2]
    resident = resident_rule(hidden, dtype)
    if hold:
        geometry = functools.partial(geometry, hold=True)
    max_rows = _max_rows(geometry, hidden, dtype, resident)
    rows = next((r for r in range(1, max_rows + 1)
                 if groups * -(-batch // r) <= active_clusters), max_rows)
    clusters = groups * -(-batch // rows)

    return {'rows': rows, 'clusters': clusters, 'ctas': CLUSTER * clusters,
            'groups': groups, 'resident': resident, 'max_rows': max_rows,
            'active_clusters': active_clusters,
            'waves': -(-clusters // active_clusters),
            'smem_bytes': geometry(hidden, dtype, rows, resident)['bytes'],
            'threads': geometry(hidden, dtype, rows, resident)['threads']}


def _launch_plan(kernel, batch, hidden, dtype, device, residuals=False,
                 groups=1, hold=False):
    """:func:`cluster_plan` for a launch on ``device``, with the card's
    answer to ``cudaOccupancyMaxActiveClusters`` at the largest rows the
    buffers fit (cached per device and configuration)."""

    geometry, resident_rule, library, query = _CLUSTER_KERNELS[kernel]
    resident = resident_rule(hidden, dtype)
    if hold:
        geometry = functools.partial(geometry, hold=True)
    max_rows = _max_rows(geometry, hidden, dtype, resident)
    bf16 = int(dtype == torch.bfloat16)

    def query_card():
        signatures = _SCAN_SIGNATURES if kernel == 'scan' else _BPTT_SIGNATURES
        lib = cuda_build.library(library, signatures)
        count = _INT(0)
        flags = (int(residuals),) if kernel == 'scan' else (int(hold),)
        with torch.cuda.device(device):
            status = getattr(lib, query)(hidden, bf16, *flags, max_rows,
                                         int(resident), ctypes.byref(count))
        cuda_build.check(status, f'{library} occupancy query')
        if count.value < 1:
            raise RuntimeError(f'the card holds no cluster of the {library} '
                               f'kernel at hidden={hidden}, {dtype}')
        return count.value

    active = cuda_build.cached(_active_clusters,
                               (kernel, device, hidden, bf16, residuals,
                                hold), query_card)
    return cluster_plan(batch, hidden, dtype, active, kernel, groups, hold)


def scan_launch_plan(batch, hidden, dtype, device, residuals=False,
                     groups=1):
    """The launch of kernel B (E with ``residuals``) on ``device``, over
    ``groups`` sequences."""

    return _launch_plan('scan', batch, hidden, dtype, device, residuals,
                        groups)


def bptt_launch_plan(batch, hidden, dtype, device, groups=1, hold=False):
    """The launch of kernel F on ``device``, over ``groups`` sequences
    (``hold``: masked or carried)."""

    return _launch_plan('bptt', batch, hidden, dtype, device, groups=groups,
                        hold=hold)


def scan_supported(hidden, dtype):
    """Whether kernels B, E and F take ``hidden`` units a direction in
    ``dtype`` (float32 or bf16) on the card, from the shape alone: H a
    multiple of 16 (8 CTAs of whole bf16 pairs), at most ``MAX_HIDDEN``,
    and one row's buffers of each kernel within a block's shared memory,
    so that :func:`cluster_plan` can place a cluster. The counterpart of
    ``pallas_lstm_supported`` (``pallas_lstm.py:45-57``); the layers run
    other widths up to ``MAX_HIDDEN`` zero-padded to a multiple of 16
    (``ops/lstm.py``)."""

    if hidden <= 0 or hidden % 16 or hidden > MAX_HIDDEN:
        return False

    return all(_fits(geometry, hidden, dtype, 1, resident(hidden, dtype))
               for geometry, resident, _, _ in _CLUSTER_KERNELS.values())


def _sigmoid_tanh_form(x):
    return 0.5 * torch.tanh(0.5 * x) + 0.5


def _scan_plain(xw, w_h, reverse, residuals, lengths=None,
                initial_carry=None):
    """The recurrence of kernels B and E, step by step -> ``(out,
    residuals, (c, h))``: ``residuals`` the float32 gate activations and
    cell states of E (None for B), ``(c, h)`` the final float32 carry, h as
    the next step would read it (rounded to bf16 in bf16 mode).

    With ``lengths``, a row keeps its carry and outputs 0 at every step
    ``t >= lengths[row]``; there E's cell state is the kept c (what kernel F
    reads as the next valid step's ``c_prev``) and its gates are the ones
    the step computed, which F does not read. ``initial_carry`` is a
    ``(c, h)`` to start from in place of zeros, in float32."""

    batch, frames, four_h = xw.shape
    hidden = four_h // 4
    bf16 = xw.dtype == torch.bfloat16

    # bf16 operands are exact in float32, so this is the kernel's product
    # with float32 accumulation
    w = w_h.to(xw.dtype).float()
    if initial_carry is None:
        h = torch.zeros((batch, hidden), dtype=torch.float32,
                        device=xw.device)
        c = torch.zeros_like(h)
    else:
        c, h = (x.to(device=xw.device, dtype=torch.float32)
                for x in initial_carry)
    out = torch.empty((batch, frames, hidden), dtype=xw.dtype,
                      device=xw.device)
    if residuals:
        gates_seq = torch.empty((batch, frames, four_h), dtype=torch.float32,
                                device=xw.device)
        c_seq = torch.empty((batch, frames, hidden), dtype=torch.float32,
                            device=xw.device)

    steps = range(frames - 1, -1, -1) if reverse else range(frames)
    for t in steps:
        h_prev, c_prev = h, c
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
        if lengths is not None:
            valid = (t < lengths)[:, None]
            c = torch.where(valid, c, c_prev)
            out[:, t] = torch.where(valid, h, 0.0).to(xw.dtype)
            h = torch.where(valid, h, h_prev)
        else:
            out[:, t] = h.to(xw.dtype)
        if residuals:
            gates_seq[:, t] = torch.cat([i_g, f_g, g_g, o_g], dim=-1).float()
            c_seq[:, t] = c

    return (out, (gates_seq, c_seq) if residuals else None,
            (c, h.to(xw.dtype).float()))


def lstm_scan_plain(xw, w_h, reverse=False, lengths=None, initial_carry=None,
                    return_carry=False):
    """(B, T, 4H) projections, (H, 4H) weights -> (B, T, H): a loop over T.

    With ``lengths`` (B,), row b keeps its carry and outputs 0 at every step
    ``t >= lengths[b]``, the JAX masked scan step (``ops/lstm.py:98-108``),
    so a reverse scan starts at the row's true end. ``initial_carry``
    ``(c, h)``, each (B, H), starts the recurrence in place of zeros (in
    float32); with ``return_carry`` the result is ``(out, (c, h))``, the
    float32 state the next step would read (h rounded to bf16 in bf16 mode).
    """

    if lengths is not None:
        lengths = lengths.to(device=xw.device, dtype=torch.int64)

    out, _, carry = _scan_plain(xw, w_h, reverse, residuals=False,
                                lengths=lengths, initial_carry=initial_carry)

    return (out, carry) if return_carry else out


def lstm_scan_residuals_plain(xw, w_h, reverse=False, lengths=None,
                              initial_carry=None, return_carry=False):
    """:func:`lstm_scan_plain` that also returns the float32 gate
    activations (B, T, 4H) and cell states (B, T, H): ``(out, gates, c)``,
    or ``(out, gates, c, (c_last, h_last))`` with ``return_carry``. At a
    masked step the cell state is the kept one."""

    if lengths is not None:
        lengths = lengths.to(device=xw.device, dtype=torch.int64)

    out, (gates, c_seq), carry = _scan_plain(
        xw, w_h, reverse, residuals=True, lengths=lengths,
        initial_carry=initial_carry)

    return (out, gates, c_seq, carry) if return_carry else (out, gates, c_seq)


def lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse=False, lengths=None,
                    carry=None):
    """BPTT from the residuals -> da (B, T, 4H) float32: a loop over T,
    opposite to the forward's direction ``reverse``.

    ``dout`` (B, T, H) and ``w_h_t`` (4H, H) are in the forward's compute
    dtype; the carry product reads ``da`` rounded to that dtype. With
    ``lengths`` (B,), at every step ``t >= lengths[b]`` row b has da = 0,
    ignores ``dout`` and passes its dh and dc carries through unchanged,
    the gradient of a step that kept its carry. ``carry`` ``(c0, dc_last,
    dh_last)``, each float32 (B, H), is the forward's initial cell state
    (the first step's ``c_prev`` in place of zero) and the gradient of its
    returned final carry (the carries the walk starts from in place of
    zeros); the result is then ``(da, dc0, dh0)``, the gradient of the
    initial carry: ``dh0 = round(da) @ W_h^T`` of the row's first valid
    step and ``dc0`` its ``dc * f``, or ``(dh_last, dc_last)`` passed
    through a row of length 0.
    """

    batch, frames, four_h = gates.shape
    hidden = four_h // 4
    w = w_h_t.float()

    zero = torch.zeros((batch, hidden), dtype=torch.float32,
                       device=gates.device)
    if carry is None:
        c0, dc_carry, dh_carry = zero, zero, zero
    else:
        c0, dc_carry, dh_carry = (x.to(device=gates.device,
                                       dtype=torch.float32) for x in carry)
    if lengths is not None:
        lengths = lengths.to(device=gates.device, dtype=torch.int64)
    da = torch.empty((batch, frames, four_h), dtype=torch.float32,
                     device=gates.device)

    steps = range(frames) if reverse else range(frames - 1, -1, -1)
    for t in steps:
        t_prev = t + 1 if reverse else t - 1
        c_prev = c_seq[:, t_prev] if 0 <= t_prev < frames else c0

        i_g, f_g, g_g, o_g = gates[:, t].split(hidden, dim=-1)
        c_t = c_seq[:, t]
        tanh_c = torch.tanh(c_t)

        dh = dout[:, t].float() + dh_carry
        da_o = dh * tanh_c * o_g * (1.0 - o_g)
        dc = dc_carry + dh * o_g * (1.0 - tanh_c * tanh_c)
        da_i = dc * g_g * i_g * (1.0 - i_g)
        da_g = dc * i_g * (1.0 - g_g * g_g)
        da_f = dc * c_prev * f_g * (1.0 - f_g)

        step = torch.cat([da_i, da_f, da_g, da_o], dim=-1)
        if lengths is None:
            dc_carry = dc * f_g
            da[:, t] = step
            dh_carry = step.to(w_h_t.dtype).float() @ w
            continue
        valid = (t < lengths)[:, None]
        dc_carry = torch.where(valid, dc * f_g, dc_carry)
        step = torch.where(valid, step, 0.0)
        da[:, t] = step
        dh_carry = torch.where(valid, step.to(w_h_t.dtype).float() @ w,
                               dh_carry)

    if carry is None:
        return da

    return da, dc_carry, dh_carry


def _stack_groups(results):
    """Per-group results (tensors, or tuples of them) stacked on a new
    leading group axis."""

    if isinstance(results[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*results))

    return torch.stack(results)


def lstm_scan_grouped_plain(xw, w_h, reverse_from, lengths=None):
    """(G, B, T, 4H) projections, (G, H, 4H) weights -> (G, B, T, H): group
    g is :func:`lstm_scan_plain` of its own sequence and weights, reversed
    for ``g >= reverse_from``; ``lengths`` (B,) are every group's."""

    return _stack_groups([
        lstm_scan_plain(xw[g], w_h[g], g >= reverse_from, lengths)
        for g in range(xw.shape[0])])


def lstm_scan_residuals_grouped_plain(xw, w_h, reverse_from, lengths=None):
    """:func:`lstm_scan_residuals_plain` a group -> ``(out, gates, c)``,
    each with the leading group axis; ``lengths`` (B,) are every group's."""

    return _stack_groups([
        lstm_scan_residuals_plain(xw[g], w_h[g], g >= reverse_from, lengths)
        for g in range(xw.shape[0])])


def lstm_bptt_grouped_plain(gates, c_seq, dout, w_h_t, reverse_from,
                            lengths=None):
    """:func:`lstm_bptt_plain` a group -> da (G, B, T, 4H); the groups
    from ``reverse_from`` on had a reverse forward, ``lengths`` (B,) are
    every group's."""

    return _stack_groups([
        lstm_bptt_plain(gates[g], c_seq[g], dout[g], w_h_t[g],
                        g >= reverse_from, lengths)
        for g in range(gates.shape[0])])


def _check_inputs(xw, w_h, grouped=False):
    cuda_build.require_plain('lstm_scan', xw=xw, w_h=w_h)
    rank = 4 if grouped else 3
    if xw.dim() != rank or xw.shape[-1] % 4:
        layout = '(G, B, T, 4H)' if grouped else '(B, T, 4H)'
        raise ValueError(f'xw must be {layout}, got shape {tuple(xw.shape)}')
    hidden = xw.shape[-1] // 4
    shape = tuple(xw.shape[:-3]) + (hidden, 4 * hidden)
    if tuple(w_h.shape) != shape:
        raise ValueError(f'w_h must be {shape}, got {tuple(w_h.shape)}')
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


def _launch_scan(xw, w_h, reverse, residuals, lengths=None, carry=None,
                 reverse_from=None):
    """Kernel B, or E with ``residuals``, on CUDA tensors: with per-row
    ``lengths`` (an int32 tensor, or none), from a float32 ``carry`` ``(c0,
    h0)`` (or zeros). A carried launch returns its outputs and ``(c, h)``,
    the final carry. With ``reverse_from`` (no carry) the launch is
    grouped: xw (G, B, T, 4H), w_h (G, H, 4H), the outputs with the leading
    G, the groups from ``reverse_from`` on reversed."""

    grouped = reverse_from is not None
    groups = xw.shape[0] if grouped else 1
    lead = tuple(xw.shape[:-3])
    batch, frames, four_h = xw.shape[-3:]
    hidden = four_h // 4
    name = 'lstm_scan_residuals' if residuals else 'lstm_scan'
    name += ('_grouped' if grouped else '') + (
        '' if carry is None else '_carried')
    _check_cuda(xw, name, hidden)
    if hidden % 16:
        raise ValueError(f'{name} kernel supports hidden a multiple of 16 '
                         f'(8 CTAs of whole bf16 pairs), got {hidden}')

    out = torch.empty(lead + (batch, frames, hidden), dtype=xw.dtype,
                      device=xw.device)
    outputs = [out]
    if residuals:
        outputs += [torch.empty(lead + (batch, frames, four_h),
                                dtype=torch.float32, device=xw.device),
                    torch.empty(lead + (batch, frames, hidden),
                                dtype=torch.float32, device=xw.device)]
    carried = ()
    if carry is not None:
        final = (torch.empty_like(carry[0]), torch.empty_like(carry[1]))
        carried = tuple(t.data_ptr() for t in (*carry, *final))
    if batch == 0 or frames == 0 or groups == 0:
        if carry is not None:  # the carry as the next step would read it,
            # copied: an op returns no input
            final = (carry[0].clone(), carry[1].to(xw.dtype).float().clone())
    else:
        plan = scan_launch_plan(batch, hidden, xw.dtype, xw.device,
                                residuals, groups)
        xw, w_h = _aligned(xw), _aligned(w_h)
        lib = cuda_build.library('lstm_scan', _SCAN_SIGNATURES)
        # a grouped launch names its groups and the first reversed one
        # where an ungrouped one names its direction
        shape = ((groups, reverse_from, batch, frames, hidden) if grouped
                 else (batch, frames, hidden, int(reverse)))
        with torch.cuda.device(xw.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = getattr(lib, name)(
                xw.data_ptr(), w_h.data_ptr(),
                *(t.data_ptr() for t in outputs),
                None if lengths is None else lengths.data_ptr(), *carried,
                *shape, int(xw.dtype == torch.bfloat16), plan['rows'],
                int(plan['resident']), stream)
        cuda_build.check(status, name)

    outputs = tuple(outputs) if residuals else out
    if carry is not None:
        return outputs, final
    return outputs


def _check_lengths(lengths, xw):
    """Per-row lengths as the kernel takes them: int32 (B,) on xw's device,
    each in [0, T]."""

    cuda_build.require_plain('lstm_scan', lengths=lengths)
    batch, frames = xw.shape[-3:-1]
    if lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise TypeError(f'lengths must be integers, got {lengths.dtype}')
    if tuple(lengths.shape) != (batch,):
        raise ValueError(f'lengths must be ({batch},), got '
                         f'{tuple(lengths.shape)}')
    lengths = lengths.to(device=xw.device, dtype=torch.int32).contiguous()
    if batch and not bool(((lengths >= 0) & (lengths <= frames)).all()):
        raise ValueError(f'lengths must lie in [0, {frames}], got '
                         f'{lengths.tolist()}')

    return lengths


def _check_rows(xw, kernel, **tensors):
    """Float32 (B, H) carries (or their gradients) as the kernels take
    them: each contiguous on xw's device, (B, H) of xw (B, T, 4H) or the
    gates."""

    batch, hidden = xw.shape[0], xw.shape[-1] // 4
    checked = []
    for name, x in tensors.items():
        x = torch.as_tensor(x)
        cuda_build.require_plain(kernel, **{name: x})
        if tuple(x.shape) != (batch, hidden):
            raise ValueError(f'{name} must be ({batch}, {hidden}), got '
                             f'{tuple(x.shape)}')
        if not x.dtype.is_floating_point:
            raise TypeError(f'{name} must be floating point, got {x.dtype}')
        checked.append(x.to(device=xw.device, dtype=torch.float32)
                       .contiguous())

    return tuple(checked)


def _check_carry(initial_carry, xw):
    """A carry as the kernels take it: float32 ``(c, h)``, each (B, H),
    contiguous on xw's device (zeros when none is given)."""

    if initial_carry is None:
        zeros = torch.zeros((xw.shape[0], xw.shape[-1] // 4),
                            dtype=torch.float32, device=xw.device)
        return zeros, zeros.clone()
    if len(initial_carry) != 2:
        raise ValueError('initial_carry must be a pair (c, h)')

    return _check_rows(xw, 'lstm_scan', **{'initial_carry c': initial_carry[0],
                                           'initial_carry h': initial_carry[1]})


def scan_cost(batch, frames, hidden, dtype, residuals=False, carried=False,
              steps=None):
    """``(flops, bytes)`` of one launch of kernel B (E with ``residuals``):
    the recurrent product, 2 H 4H operations a row and step, over ``steps``
    row-steps (``batch * frames`` unless lengths say fewer); xw and W_h read
    and h written once in ``dtype``, E's float32 gates and cell states
    written, a float32 carry read and written, int32 lengths read."""

    size = torch.finfo(dtype).bits // 8
    rows = batch * frames
    steps = rows if steps is None else steps
    flops = 2.0 * steps * hidden * 4 * hidden
    num_bytes = size * (rows * 4 * hidden + hidden * 4 * hidden +
                        rows * hidden)
    if residuals:
        num_bytes += 4 * rows * 5 * hidden
    if carried:
        num_bytes += 4 * 4 * batch * hidden

    return flops, float(num_bytes)


def bptt_cost(batch, frames, hidden, dtype, carried=False, steps=None):
    """``(flops, bytes)`` of one launch of kernel F: the carry product, 2 4H
    H operations a row and step, over ``steps`` row-steps (``batch *
    frames`` unless lengths say fewer), and with ``carried`` one more a row
    for the initial carry's gradient; the float32 gates and cell states
    read and the float32 da written, dout and W_h^T read in ``dtype``, the
    float32 c0 and final carry's gradient read and the initial carry's
    written."""

    size = torch.finfo(dtype).bits // 8
    rows = batch * frames
    steps = rows if steps is None else steps
    flops = 2.0 * (steps + (batch if carried else 0)) * hidden * 4 * hidden
    num_bytes = (4 * (rows * 4 * hidden + rows * hidden + rows * 4 * hidden) +
                 size * (rows * hidden + 4 * hidden * hidden))
    if carried:
        num_bytes += 4 * 5 * batch * hidden

    return flops, float(num_bytes)


def _valid_steps(lengths):
    """The row-steps masked lengths ask for, where the lengths are values
    (not a tracer's fake tensor); None otherwise."""

    from torch._subclasses.fake_tensor import is_fake

    if lengths is None or is_fake(lengths):
        return None

    return int(lengths.sum())


def _count(wrapper, lengths, carried=False):
    """One launch of ``wrapper``'s kernel, and of its masked or carried
    route."""

    cuda_build.count(wrapper, 'launches',
                     *(('masked_launches',) if lengths is not None else ()),
                     *(('carried_launches',) if carried else ()))


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_scan',
                         mutates_args=())
def lstm_scan_op(xw: torch.Tensor, w_h: torch.Tensor, reverse: bool,
                 lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel B as an op (inputs as :func:`lstm_scan` checks them; lengths
    int32 on xw's device, or None)."""

    if xw.device.type == 'cpu':
        return lstm_scan_plain(xw, w_h, reverse, lengths)

    out = _launch_scan(xw, w_h, reverse, residuals=False, lengths=lengths)
    _count(lstm_scan, lengths)

    return out


@lstm_scan_op.register_fake
def _(xw, w_h, reverse, lengths):
    return xw.new_empty(xw.shape[:-1] + (xw.shape[-1] // 4,))


def _fresh(outputs, inputs):
    """``outputs`` with any tensor that is one of ``inputs`` copied: an op
    returns no input (the carry of zero steps is the one given)."""

    return tuple(x.clone() if any(x is y for y in inputs) else x
                 for x in outputs)


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_scan_carried',
                         mutates_args=())
def lstm_scan_carried_op(
        xw: torch.Tensor, w_h: torch.Tensor, reverse: bool,
        lengths: Optional[torch.Tensor], c0: torch.Tensor,
        h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B from the float32 carry ``(c0, h0)`` as an op -> ``(out, c,
    h)``, the final carry as :func:`lstm_scan` returns it."""

    if xw.device.type == 'cpu':
        out, (c, h) = lstm_scan_plain(xw, w_h, reverse, lengths, (c0, h0),
                                      return_carry=True)
        return (out, *_fresh((c, h), (c0, h0)))

    out, (c, h) = _launch_scan(xw, w_h, reverse, residuals=False,
                               lengths=lengths, carry=(c0, h0))
    _count(lstm_scan, lengths, carried=True)

    return out, c, h


@lstm_scan_carried_op.register_fake
def _(xw, w_h, reverse, lengths, c0, h0):
    out = xw.new_empty(xw.shape[:-1] + (xw.shape[-1] // 4,))

    return out, torch.empty_like(c0), torch.empty_like(h0)


def _scan_op_cost(xw, w_h, reverse, lengths, *carry, residuals=False):
    batch, frames, four_h = xw.shape

    return scan_cost(batch, frames, four_h // 4, xw.dtype, residuals,
                     carried=bool(carry), steps=_valid_steps(lengths))


cuda_build.register_cost(lstm_scan_op, _scan_op_cost)
cuda_build.register_cost(lstm_scan_carried_op, _scan_op_cost)


def lstm_scan(xw, w_h, reverse=False, lengths=None, initial_carry=None,
              return_carry=False):
    """Whole-sequence LSTM: (B, T, 4H) -> (B, T, H).

    ``xw`` holds the hoisted input projections including the bias, ``w_h``
    the (H, 4H) recurrent kernel in the same dtype (float32 or bf16; gate
    order i, f, g, o). ``reverse`` walks back to front and writes outputs in
    natural order. ``lengths`` (B,) integers in [0, T] mask each row's
    padded tail: from ``t = lengths[b]`` on, row b keeps its carry and
    writes 0, so its valid frames equal an unpadded run's bit for bit (a
    reverse scan starts at the row's true end). ``initial_carry`` ``(c,
    h)``, each (B, H), starts the recurrence in place of zeros, in float32;
    with ``return_carry`` the result is ``(out, (c, h))``: the float32
    final state, h as the next step reads it (rounded to bf16 in bf16
    mode), so a sequence cut into chunks that thread it equals one whole
    call bit for bit. CUDA tensors go through the Hopper kernel (or raise);
    CPU tensors through :func:`lstm_scan_plain`; both through
    :data:`lstm_scan_op`, or :data:`lstm_scan_carried_op` with a carry.
    """

    _check_inputs(xw, w_h)
    if lengths is not None:
        lengths = _check_lengths(lengths, xw)
    carried = initial_carry is not None or return_carry
    if not carried:
        return lstm_scan_op(xw, w_h, reverse, lengths)

    out, c, h = lstm_scan_carried_op(xw, w_h, reverse, lengths,
                                     *_check_carry(initial_carry, xw))

    return (out, (c, h)) if return_carry else out


lstm_scan.launches = 0
lstm_scan.masked_launches = 0  # those of lstm_scan.launches with lengths
lstm_scan.carried_launches = 0  # those with a carry in and out


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_scan_residuals',
                         mutates_args=())
def lstm_scan_residuals_op(
        xw: torch.Tensor, w_h: torch.Tensor, reverse: bool,
        lengths: Optional[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel E as an op -> ``(out, gates, c)``; lengths as
    :data:`lstm_scan_op`'s."""

    if xw.device.type == 'cpu':
        return lstm_scan_residuals_plain(xw, w_h, reverse, lengths)

    outputs = _launch_scan(xw, w_h, reverse, residuals=True, lengths=lengths)
    _count(lstm_scan_residuals, lengths)

    return outputs


def _residuals_fake(xw):
    hidden = xw.shape[-1] // 4

    return (xw.new_empty(xw.shape[:-1] + (hidden,)),
            xw.new_empty(xw.shape, dtype=torch.float32),
            xw.new_empty(xw.shape[:-1] + (hidden,), dtype=torch.float32))


@lstm_scan_residuals_op.register_fake
def _(xw, w_h, reverse, lengths):
    return _residuals_fake(xw)


@torch.library.custom_op(
    f'{cuda_build.NAMESPACE}::lstm_scan_residuals_carried', mutates_args=())
def lstm_scan_residuals_carried_op(
        xw: torch.Tensor, w_h: torch.Tensor, reverse: bool,
        lengths: Optional[torch.Tensor], c0: torch.Tensor, h0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Kernel E from the float32 carry ``(c0, h0)`` as an op -> ``(out,
    gates, c_seq, c, h)``, the final carry as :func:`lstm_scan` returns
    it."""

    if xw.device.type == 'cpu':
        out, gates, c_seq, (c, h) = lstm_scan_residuals_plain(
            xw, w_h, reverse, lengths, (c0, h0), return_carry=True)
        return (out, gates, c_seq, *_fresh((c, h), (c0, h0)))

    (out, gates, c_seq), (c, h) = _launch_scan(
        xw, w_h, reverse, residuals=True, lengths=lengths, carry=(c0, h0))
    _count(lstm_scan_residuals, lengths, carried=True)

    return out, gates, c_seq, c, h


@lstm_scan_residuals_carried_op.register_fake
def _(xw, w_h, reverse, lengths, c0, h0):
    return (*_residuals_fake(xw), torch.empty_like(c0), torch.empty_like(h0))


cuda_build.register_cost(
    lstm_scan_residuals_op,
    functools.partial(_scan_op_cost, residuals=True))
cuda_build.register_cost(
    lstm_scan_residuals_carried_op,
    functools.partial(_scan_op_cost, residuals=True))


def lstm_scan_residuals(xw, w_h, reverse=False, lengths=None,
                        initial_carry=None, return_carry=False):
    """:func:`lstm_scan` that also returns the residuals of the backward:
    ``(out, gates, c)`` with float32 gate activations (B, T, 4H) in order
    i, f, g, o and float32 cell states (B, T, H), and with
    ``return_carry`` the final carry after them, ``(out, gates, c, (c_last,
    h_last))``. ``lengths`` and ``initial_carry`` as :func:`lstm_scan`'s; a
    masked step's cell state is the kept one. CUDA tensors go through
    kernel E (or raise); CPU tensors through
    :func:`lstm_scan_residuals_plain`; both through
    :data:`lstm_scan_residuals_op`, or
    :data:`lstm_scan_residuals_carried_op` with a carry."""

    _check_inputs(xw, w_h)
    if lengths is not None:
        lengths = _check_lengths(lengths, xw)
    if initial_carry is None and not return_carry:
        return lstm_scan_residuals_op(xw, w_h, reverse, lengths)

    *outputs, c, h = lstm_scan_residuals_carried_op(
        xw, w_h, reverse, lengths, *_check_carry(initial_carry, xw))

    return (*outputs, (c, h)) if return_carry else tuple(outputs)


lstm_scan_residuals.launches = 0
lstm_scan_residuals.masked_launches = 0  # those with lengths
lstm_scan_residuals.carried_launches = 0  # those with a carry in and out


def _check_bptt_inputs(gates, c_seq, dout, w_h_t, grouped=False):
    cuda_build.require_plain('lstm_bptt', gates=gates, c_seq=c_seq,
                             dout=dout, w_h_t=w_h_t)
    if gates.dim() != (4 if grouped else 3) or gates.shape[-1] % 4:
        layout = '(G, B, T, 4H)' if grouped else '(B, T, 4H)'
        raise ValueError(f'gates must be {layout}, got shape '
                         f'{tuple(gates.shape)}')
    lead = tuple(gates.shape[:-3])
    batch, frames, four_h = gates.shape[-3:]
    hidden = four_h // 4
    shapes = {'c_seq': (c_seq, lead + (batch, frames, hidden)),
              'dout': (dout, lead + (batch, frames, hidden)),
              'w_h_t': (w_h_t, lead + (four_h, hidden))}
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


def _launch_bptt(gates, c_seq, dout, w_h_t, reverse, reverse_from=None,
                 lengths=None, carry=None):
    """Kernel F on CUDA tensors, with per-row ``lengths`` (int32, or none)
    and from ``carry`` ``(c0, dc_last, dh_last)`` (float32 (B, H) each, or
    none: zeros), then returning ``(da, dc0, dh0)``; with ``reverse_from``
    (no carry) the launch is grouped, every tensor with a leading group
    axis."""

    grouped = reverse_from is not None
    groups = gates.shape[0] if grouped else 1
    batch, frames, four_h = gates.shape[-3:]
    hidden = four_h // 4
    name = 'lstm_bptt' + ('_grouped' if grouped else '') + (
        '' if carry is None else '_carried')
    _check_cuda(gates, name, hidden)
    if hidden % 16:
        raise ValueError(f'{name} kernel supports hidden a multiple of 16 '
                         f'(8 CTAs of whole bf16 pairs), got {hidden}')

    da = torch.empty(gates.shape, dtype=torch.float32, device=gates.device)
    carried = ()
    if carry is not None:
        initial = (torch.empty_like(carry[1]), torch.empty_like(carry[2]))
        carried = tuple(t.data_ptr() for t in (*carry, *initial))
    if batch == 0 or frames == 0 or groups == 0:
        # zero steps pass the final carry's gradient through, copied
        initial = (carry[1].clone(), carry[2].clone()) if carry else None
    else:
        plan = bptt_launch_plan(batch, hidden, dout.dtype, gates.device,
                                groups, hold=lengths is not None or
                                carry is not None)
        gates, c_seq, dout, w_h_t = (_aligned(t) for t in (gates, c_seq,
                                                           dout, w_h_t))
        lib = cuda_build.library('lstm_bptt', _BPTT_SIGNATURES)
        shape = ((groups, reverse_from, batch, frames, hidden) if grouped
                 else (batch, frames, hidden, int(reverse)))
        with torch.cuda.device(gates.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = getattr(lib, name)(
                gates.data_ptr(), c_seq.data_ptr(), dout.data_ptr(),
                w_h_t.data_ptr(), da.data_ptr(),
                None if lengths is None else lengths.data_ptr(), *carried,
                *shape, int(dout.dtype == torch.bfloat16), plan['rows'],
                int(plan['resident']), stream)
        cuda_build.check(status, name)

    return da if carry is None else (da, *initial)


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_bptt',
                         mutates_args=())
def lstm_bptt_op(gates: torch.Tensor, c_seq: torch.Tensor,
                 dout: torch.Tensor, w_h_t: torch.Tensor, reverse: bool,
                 lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel F as an op -> da (inputs as :func:`lstm_bptt` checks them;
    lengths int32 on the gates' device, or None)."""

    if gates.device.type == 'cpu':
        return lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse, lengths)

    da = _launch_bptt(gates, c_seq, dout, w_h_t, reverse, lengths=lengths)
    _count(lstm_bptt, lengths)

    return da


@lstm_bptt_op.register_fake
def _(gates, c_seq, dout, w_h_t, reverse, lengths):
    return torch.empty_like(gates)


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_bptt_carried',
                         mutates_args=())
def lstm_bptt_carried_op(
        gates: torch.Tensor, c_seq: torch.Tensor, dout: torch.Tensor,
        w_h_t: torch.Tensor, reverse: bool, lengths: Optional[torch.Tensor],
        c0: torch.Tensor, dc_last: torch.Tensor, dh_last: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel F from the gradient ``(dc_last, dh_last)`` of the forward's
    final carry, reading ``c0`` as its first step's ``c_prev``, as an op ->
    ``(da, dc0, dh0)``."""

    carry = (c0, dc_last, dh_last)
    if gates.device.type == 'cpu':
        da, dc0, dh0 = lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse,
                                       lengths, carry)
        return (da, *_fresh((dc0, dh0), carry))

    da, dc0, dh0 = _launch_bptt(gates, c_seq, dout, w_h_t, reverse,
                                lengths=lengths, carry=carry)
    _count(lstm_bptt, lengths, carried=True)

    return da, dc0, dh0


@lstm_bptt_carried_op.register_fake
def _(gates, c_seq, dout, w_h_t, reverse, lengths, c0, dc_last, dh_last):
    return (torch.empty_like(gates), torch.empty_like(dc_last),
            torch.empty_like(dh_last))


def _bptt_op_cost(gates, c_seq, dout, w_h_t, reverse, lengths, *carry):
    batch, frames, four_h = gates.shape

    return bptt_cost(batch, frames, four_h // 4, dout.dtype,
                     carried=bool(carry), steps=_valid_steps(lengths))


cuda_build.register_cost(lstm_bptt_op, _bptt_op_cost)
cuda_build.register_cost(lstm_bptt_carried_op, _bptt_op_cost)


def lstm_bptt(gates, c_seq, dout, w_h_t, reverse=False, lengths=None,
              carry=None):
    """BPTT over the residuals of :func:`lstm_scan_residuals` -> d(xw) as
    float32 (B, T, 4H).

    ``gates`` (B, T, 4H) and ``c_seq`` (B, T, H) are float32; ``dout``
    (B, T, H) and the transposed recurrent kernel ``w_h_t`` (4H, H) are in
    the forward's compute dtype (float32 or bf16). ``reverse`` names the
    forward's direction, ``lengths`` (B,) its masked rows: a row has da = 0
    past its length and carries its gradients through. ``carry`` ``(c0,
    dc_last, dh_last)``, each (B, H), names the forward's initial cell state
    and the gradient of its final carry; the result is then ``(da, dc0,
    dh0)``, float32, the gradient of its initial carry
    (:func:`lstm_bptt_plain`). CUDA tensors go through kernel F (or raise);
    CPU tensors through :func:`lstm_bptt_plain`; both through
    :data:`lstm_bptt_op`, or :data:`lstm_bptt_carried_op` with a carry.
    """

    _check_bptt_inputs(gates, c_seq, dout, w_h_t)
    if lengths is not None:
        lengths = _check_lengths(lengths, gates)
    if carry is None:
        return lstm_bptt_op(gates, c_seq, dout, w_h_t, reverse, lengths)
    if len(carry) != 3:
        raise ValueError('carry must be (c0, dc_last, dh_last)')

    return lstm_bptt_carried_op(gates, c_seq, dout, w_h_t, reverse, lengths,
                                *_check_rows(gates, 'lstm_bptt',
                                             c0=carry[0], dc_last=carry[1],
                                             dh_last=carry[2]))


lstm_bptt.launches = 0
lstm_bptt.masked_launches = 0  # those with lengths
lstm_bptt.carried_launches = 0  # those with a carry's gradient in and out


def _shift_prev(x, reverse):
    """The previous step's value at each t of (..., T, H) (zero at the
    sequence's start): t - 1 for a forward scan, t + 1 for a reverse one."""

    zero = torch.zeros_like(x[..., :1, :])
    if reverse:
        return torch.cat([x[..., 1:, :], zero], dim=-2)

    return torch.cat([zero, x[..., :-1, :]], dim=-2)


def _h_prev(out, reverse, lengths=None, h0=None):
    """The float32 h each step's recurrent product read, (B, T, H): the
    previous step's output (a masked step's is 0, and its da is too), and
    at a row's first step ``h0`` as the step read it, rounded to out's
    dtype (zero without a carry). A reverse row with lengths starts at
    ``t = lengths - 1``, where the shifted output reads a masked step."""

    prev = _shift_prev(out, reverse).float()
    if h0 is None:
        return prev

    batch, frames = out.shape[:2]
    if not reverse:
        first = torch.zeros(batch, dtype=torch.int64, device=out.device)
    elif lengths is None:
        first = torch.full((batch,), frames - 1, device=out.device)
    else:
        first = lengths.to(torch.int64) - 1
    at_first = torch.arange(frames, device=out.device) == first[:, None]

    return torch.where(at_first[..., None],
                       h0.to(out.dtype).float()[:, None, :], prev)


def _dw_h(h_prev, da):
    """dW_h = sum over rows and steps of h_prev^T da, one float32 matmul
    outside the kernel (batched over a leading group axis)."""

    hidden = h_prev.shape[-1]
    if h_prev.dim() == 3:
        return h_prev.reshape(-1, hidden).t() @ da.reshape(-1, 4 * hidden)

    groups = h_prev.shape[0]
    return torch.bmm(h_prev.reshape(groups, -1, hidden).transpose(1, 2),
                     da.reshape(groups, -1, 4 * hidden))


class LSTMScanGrad(torch.autograd.Function):
    """The differentiable recurrence: kernel E forward, kernel F backward,
    masked by per-row ``lengths`` or not.

    Takes ``w_h`` in its parameter dtype and casts it to the compute dtype
    inside (bf16 when ``xw`` is bf16, else float32), so ``dW_h`` comes back
    in the parameter's own dtype, as ``_lstm_grad_bwd`` returns it
    (``pallas_lstm.py:406-437``).
    """

    @staticmethod
    def forward(ctx, xw, w_h, reverse, lengths=None):
        xw, w = xw.contiguous(), w_h.to(xw.dtype).contiguous()
        _check_inputs(xw, w)
        if lengths is not None:
            lengths = _check_lengths(lengths, xw)
        out, gates, c_seq = lstm_scan_residuals_op(xw, w, reverse, lengths)
        ctx.reverse = reverse
        ctx.w_dtype = w_h.dtype
        ctx.save_for_backward(w_h, out, gates, c_seq, lengths)

        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        w_h, out, gates, c_seq, lengths = ctx.saved_tensors

        w_h_t = w_h.t().to(out.dtype).contiguous()
        dout = dout.to(out.dtype).contiguous()
        _check_bptt_inputs(gates, c_seq, dout, w_h_t)
        da = lstm_bptt_op(gates, c_seq, dout, w_h_t, ctx.reverse, lengths)
        dw_h = _dw_h(_h_prev(out, ctx.reverse), da)

        return da.to(out.dtype), dw_h.to(ctx.w_dtype), None, None


class LSTMScanCarriedGrad(torch.autograd.Function):
    """The differentiable recurrence from a carry: kernel E from ``(c0,
    h0)`` forward, returning ``(out, c, h)`` with the final carry, and
    kernel F backward from the final carry's gradient, giving gradients to
    ``xw``, ``w_h``, ``c0`` and ``h0``; masked by ``lengths`` or not."""

    @staticmethod
    def forward(ctx, xw, w_h, reverse, lengths, c0, h0):
        xw, w = xw.contiguous(), w_h.to(xw.dtype).contiguous()
        _check_inputs(xw, w)
        if lengths is not None:
            lengths = _check_lengths(lengths, xw)
        carry = _check_carry((c0, h0), xw)
        out, gates, c_seq, c, h = lstm_scan_residuals_carried_op(
            xw, w, reverse, lengths, *carry)
        ctx.reverse = reverse
        ctx.dtypes = (w_h.dtype, c0.dtype, h0.dtype)
        ctx.save_for_backward(w_h, out, gates, c_seq, lengths, *carry)

        return out, c, h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, dc_last, dh_last):
        w_h, out, gates, c_seq, lengths, c0, h0 = ctx.saved_tensors

        w_h_t = w_h.t().to(out.dtype).contiguous()
        dout = dout.to(out.dtype).contiguous()
        _check_bptt_inputs(gates, c_seq, dout, w_h_t)
        da, dc0, dh0 = lstm_bptt_carried_op(
            gates, c_seq, dout, w_h_t, ctx.reverse, lengths, c0,
            *_check_rows(gates, 'lstm_bptt', dc_last=dc_last,
                         dh_last=dh_last))
        dw_h = _dw_h(_h_prev(out, ctx.reverse, lengths, h0), da)
        w_dtype, c_dtype, h_dtype = ctx.dtypes

        return (da.to(out.dtype), dw_h.to(w_dtype), None, None,
                dc0.to(c_dtype), dh0.to(h_dtype))


def lstm_scan_grad(xw, w_h, reverse=False, lengths=None, initial_carry=None,
                   return_carry=False):
    """Differentiable :func:`lstm_scan`: (B, T, 4H) float32 or bf16 ``xw``,
    (H, 4H) ``w_h`` in any float dtype -> (B, T, H) in xw's dtype, or
    ``(out, (c, h))`` with ``return_carry``; ``lengths`` and
    ``initial_carry`` as :func:`lstm_scan`'s.

    The same outputs as :func:`lstm_scan` (kernel E is kernel B's body);
    under autograd the backward runs kernel F and returns ``d(xw)`` in xw's
    dtype, ``dW_h`` in w_h's and the initial carry's gradient in its own
    dtypes.
    """

    if initial_carry is None and not return_carry:
        return LSTMScanGrad.apply(xw, w_h, reverse, lengths)

    if initial_carry is None:
        initial_carry = _check_carry(None, xw)
    out, c, h = LSTMScanCarriedGrad.apply(xw, w_h, reverse, lengths,
                                          *initial_carry)

    return (out, (c, h)) if return_carry else out


# The grouped launches: G independent sequences with their own W_h in one
# launch of kernel B, E or F (csrc/lstm_scan.cu, csrc/lstm_bptt.cu, the
# group on blockIdx.y), the card's counterpart of the JAX package's one
# grouped scan (``ops/lstm.py`` ``_grouped_lstm_scan``, behind
# ``GroupedBiLSTM``). Groups [0, reverse_from) run forward and the rest
# reversed (a grouped BiLSTM's backward directions, with no flipped copy).
# A group's arithmetic is its ungrouped launch's; lengths are every group's.

def _check_reverse_from(reverse_from, groups):
    if not 0 <= reverse_from <= groups:
        raise ValueError(f'reverse_from must lie in [0, {groups}], got '
                         f'{reverse_from}')


def _grouped_cost(cost, groups):
    flops, num_bytes = cost
    return groups * flops, groups * num_bytes


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_scan_grouped',
                         mutates_args=())
def lstm_scan_grouped_op(xw: torch.Tensor, w_h: torch.Tensor,
                         reverse_from: int,
                         lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped kernel B as an op (inputs as :func:`lstm_scan_grouped`
    checks them)."""

    if xw.device.type == 'cpu':
        return lstm_scan_grouped_plain(xw, w_h, reverse_from, lengths)

    out = _launch_scan(xw, w_h, None, residuals=False, lengths=lengths,
                       reverse_from=reverse_from)
    _count(lstm_scan_grouped, lengths)

    return out


@lstm_scan_grouped_op.register_fake
def _(xw, w_h, reverse_from, lengths):
    return xw.new_empty(xw.shape[:-1] + (xw.shape[-1] // 4,))


def _scan_grouped_op_cost(xw, w_h, reverse_from, lengths, residuals=False):
    groups, batch, frames, four_h = xw.shape

    return _grouped_cost(scan_cost(batch, frames, four_h // 4, xw.dtype,
                                   residuals, steps=_valid_steps(lengths)),
                         groups)


cuda_build.register_cost(lstm_scan_grouped_op, _scan_grouped_op_cost)


def lstm_scan_grouped(xw, w_h, reverse_from, lengths=None):
    """G whole-sequence LSTMs in one launch: (G, B, T, 4H) projections and
    (G, H, 4H) recurrent kernels in one dtype -> (G, B, T, H).

    Group g is :func:`lstm_scan` of ``xw[g]`` and ``w_h[g]``, reversed for
    ``g >= reverse_from``; ``lengths`` (B,) are every group's. CUDA tensors
    go through grouped kernel B, one launch (or raise); CPU tensors through
    :func:`lstm_scan_grouped_plain`; both through
    :data:`lstm_scan_grouped_op`."""

    _check_inputs(xw, w_h, grouped=True)
    _check_reverse_from(reverse_from, xw.shape[0])
    if lengths is not None:
        lengths = _check_lengths(lengths, xw)

    return lstm_scan_grouped_op(xw, w_h, int(reverse_from), lengths)


lstm_scan_grouped.launches = 0
lstm_scan_grouped.masked_launches = 0  # those with lengths


@torch.library.custom_op(
    f'{cuda_build.NAMESPACE}::lstm_scan_residuals_grouped', mutates_args=())
def lstm_scan_residuals_grouped_op(
        xw: torch.Tensor, w_h: torch.Tensor, reverse_from: int,
        lengths: Optional[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grouped kernel E as an op -> ``(out, gates, c)``."""

    if xw.device.type == 'cpu':
        return lstm_scan_residuals_grouped_plain(xw, w_h, reverse_from,
                                                 lengths)

    outputs = _launch_scan(xw, w_h, None, residuals=True, lengths=lengths,
                           reverse_from=reverse_from)
    _count(lstm_scan_residuals_grouped, lengths)

    return outputs


@lstm_scan_residuals_grouped_op.register_fake
def _(xw, w_h, reverse_from, lengths):
    return _residuals_fake(xw)


cuda_build.register_cost(
    lstm_scan_residuals_grouped_op,
    functools.partial(_scan_grouped_op_cost, residuals=True))


def lstm_scan_residuals_grouped(xw, w_h, reverse_from, lengths=None):
    """:func:`lstm_scan_grouped` that also returns the residuals of the
    backward, ``(out, gates, c)``, each with the leading group axis;
    ``lengths`` (B,) are every group's. CUDA tensors go through grouped
    kernel E, one launch (or raise); CPU tensors through
    :func:`lstm_scan_residuals_grouped_plain`."""

    _check_inputs(xw, w_h, grouped=True)
    _check_reverse_from(reverse_from, xw.shape[0])
    if lengths is not None:
        lengths = _check_lengths(lengths, xw)

    return lstm_scan_residuals_grouped_op(xw, w_h, int(reverse_from),
                                          lengths)


lstm_scan_residuals_grouped.launches = 0
lstm_scan_residuals_grouped.masked_launches = 0  # those with lengths


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_bptt_grouped',
                         mutates_args=())
def lstm_bptt_grouped_op(gates: torch.Tensor, c_seq: torch.Tensor,
                         dout: torch.Tensor, w_h_t: torch.Tensor,
                         reverse_from: int,
                         lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped kernel F as an op -> da (G, B, T, 4H)."""

    if gates.device.type == 'cpu':
        return lstm_bptt_grouped_plain(gates, c_seq, dout, w_h_t,
                                       reverse_from, lengths)

    da = _launch_bptt(gates, c_seq, dout, w_h_t, None, reverse_from, lengths)
    _count(lstm_bptt_grouped, lengths)

    return da


@lstm_bptt_grouped_op.register_fake
def _(gates, c_seq, dout, w_h_t, reverse_from, lengths):
    return torch.empty_like(gates)


cuda_build.register_cost(
    lstm_bptt_grouped_op,
    lambda gates, c_seq, dout, w_h_t, reverse_from, lengths: _grouped_cost(
        bptt_cost(gates.shape[1], gates.shape[2], gates.shape[3] // 4,
                  dout.dtype, steps=_valid_steps(lengths)), gates.shape[0]))


def lstm_bptt_grouped(gates, c_seq, dout, w_h_t, reverse_from, lengths=None):
    """:func:`lstm_bptt` of G groups in one launch: every tensor with a
    leading group axis (``w_h_t`` (G, 4H, H)), the groups from
    ``reverse_from`` on with a reverse forward, ``lengths`` (B,) every
    group's -> da (G, B, T, 4H) float32. CUDA tensors go through grouped
    kernel F (or raise); CPU tensors through
    :func:`lstm_bptt_grouped_plain`."""

    _check_bptt_inputs(gates, c_seq, dout, w_h_t, grouped=True)
    _check_reverse_from(reverse_from, gates.shape[0])
    if lengths is not None:
        lengths = _check_lengths(lengths, gates)

    return lstm_bptt_grouped_op(gates, c_seq, dout, w_h_t, int(reverse_from),
                                lengths)


lstm_bptt_grouped.launches = 0
lstm_bptt_grouped.masked_launches = 0  # those with lengths


class LSTMScanGroupedGrad(torch.autograd.Function):
    """The differentiable grouped recurrence: grouped kernel E forward,
    grouped kernel F backward, each one launch for every group, as
    :class:`LSTMScanGrad` is for one sequence, masked by ``lengths`` (B,)
    or not; dW_h of every group is one batched float32 matmul outside the
    kernel."""

    @staticmethod
    def forward(ctx, xw, w_h, reverse_from, lengths=None):
        xw, w = xw.contiguous(), w_h.to(xw.dtype).contiguous()
        _check_inputs(xw, w, grouped=True)
        _check_reverse_from(reverse_from, xw.shape[0])
        if lengths is not None:
            lengths = _check_lengths(lengths, xw)
        out, gates, c_seq = lstm_scan_residuals_grouped_op(
            xw, w, int(reverse_from), lengths)
        ctx.reverse_from = reverse_from
        ctx.w_dtype = w_h.dtype
        ctx.save_for_backward(w_h, out, gates, c_seq, lengths)

        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        w_h, out, gates, c_seq, lengths = ctx.saved_tensors
        split = ctx.reverse_from

        w_h_t = w_h.transpose(1, 2).to(out.dtype).contiguous()
        dout = dout.to(out.dtype).contiguous()
        _check_bptt_inputs(gates, c_seq, dout, w_h_t, grouped=True)
        da = lstm_bptt_grouped_op(gates, c_seq, dout, w_h_t, split, lengths)
        h_prev = torch.cat([_h_prev(out[:split], False),
                            _h_prev(out[split:], True)])

        return da.to(out.dtype), _dw_h(h_prev, da).to(ctx.w_dtype), None, None


def lstm_scan_grouped_grad(xw, w_h, reverse_from, lengths=None):
    """Differentiable :func:`lstm_scan_grouped`: (G, B, T, 4H) float32 or
    bf16 ``xw``, (G, H, 4H) ``w_h`` in any float dtype -> (G, B, T, H) in
    xw's dtype; ``lengths`` (B,) every group's; under autograd the backward
    runs grouped kernel F."""

    return LSTMScanGroupedGrad.apply(xw, w_h, reverse_from, lengths)
