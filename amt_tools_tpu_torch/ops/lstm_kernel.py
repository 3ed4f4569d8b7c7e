"""LSTM recurrence: the Hopper kernels and their plain PyTorch versions.

Port of the fused Pallas kernels of ``amt_tools_tpu/ops/pallas_lstm.py``:
kernel B (``_lstm_kernel`` through ``lstm_scan_pallas``), the
whole-sequence recurrence over hoisted input projections, forward only;
kernel E (``_lstm_fwd_res_kernel`` through ``_lstm_fwd_res``), the same
recurrence, which also returns the float32 gate activations and cell
states; kernel F (``_lstm_bwd_kernel`` through ``_lstm_grad_bwd``),
backpropagation through time from those residuals; and the custom VJP
``lstm_scan_pallas_grad`` (``:369-440``) as one ``torch.autograd.Function``
over E and F, :class:`LSTMScanGrad`.

Every launch is grouped: G independent sequences, each with its own W_h,
the group on ``blockIdx.y`` and the groups from ``reverse_from`` on walking
back to front, the card's counterpart of the one grouped scan behind JAX's
``GroupedBiLSTM`` (``ops/lstm.py:151-199``). A group's arithmetic does not
depend on G, so a grouped launch equals its groups' launches bit for bit.
:func:`lstm_scan_grouped` (B), :func:`lstm_scan_residuals_grouped` (E),
:func:`lstm_bptt_grouped` (F) and :func:`lstm_scan_grouped_grad` (the
Function) are the implementation; :func:`lstm_scan`,
:func:`lstm_scan_residuals`, :func:`lstm_bptt` and :func:`lstm_scan_grad`
run one (B, T, ·) sequence through them at G = 1 (``reverse_from`` 0 for a
reverse scan, 1 for a forward one).

Each takes per-row ``lengths`` (bucketed evaluation; every group's): a row
keeps its carry and writes 0 past its length, the JAX masked scan's step
(``ops/lstm.py:98-108``) with the kernels' float32 carry, so its valid
frames equal an unpadded run's bit for bit; in F a masked step has da = 0
and passes its carries' gradients through. At G = 1 each also takes a
float32 carry (the kernels' carry is one group's): B and E start from
``(c, h)`` in place of zeros and return the final one (streaming, JAX
``FastLSTM(initial_carry, return_carry)``, ``ops/lstm.py:208-257``), so
chunks that thread it equal one whole call bit for bit; F starts from the
final carry's gradient and returns the initial one's. The Pallas kernels
take neither lengths nor a carry, and JAX differentiates those cases
through its XLA scan (``ops/lstm.py:98-148``); these are its semantics.

Each wrapper checks its inputs and calls one custom op of
``torch.ops.amt_tools_tpu_torch`` a kernel: ``lstm_scan`` (B),
``lstm_scan_residuals`` (E) and ``lstm_bptt`` (F), each over (G, B, T, ·)
tensors with an int ``reverse_from``, optional lengths and an optional
carry, returning a list: the outputs, then the carry's when one is given.
An op's real implementation launches ``csrc/lstm_scan.cu`` (B, E) or
``csrc/lstm_bptt.cu`` (F) through its one C entry and counts the launch
on CUDA tensors (``launches``, ``masked_launches``, ``carried_launches``
and ``grouped_launches``, for G > 1, on :func:`lstm_scan`,
:func:`lstm_scan_residuals` and :func:`lstm_bptt`), and runs the
``*_plain`` versions, Python loops over T that repeat the kernels'
arithmetic, on CPU tensors. :func:`scan_cost` and :func:`bptt_cost`, times
G, are their FLOP formulas and byte counts (over the valid row-steps of a
masked launch). dW_h = sum h_prev^T da is a float32 matmul outside the
kernel (one ``mm`` at G = 1), whose h_prev is h0 at a row's first step when
a carry is given (for a reverse row with lengths, t = lengths - 1).

All three kernels run as thread-block clusters of 8 CTAs, each CTA owning
H/8 hidden units and holding their slice of W_h (B, E: H x 4H/8) or of
W_h^T (F: 4H x H/8) on chip; B and E exchange h, F exchanges da. What sets
a launch (rows a cluster, clusters, a resident or streamed slice, shared
memory) is computed here, by :func:`scan_geometry` or
:func:`bptt_geometry` and :func:`cluster_plan`, from the card's answer to
``cudaOccupancyMaxActiveClusters``.

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

from .. import profiling
from . import cuda_build

__all__ = ['lstm_scan', 'lstm_scan_plain', 'lstm_scan_residuals',
           'lstm_scan_residuals_plain', 'lstm_bptt', 'lstm_bptt_plain',
           'lstm_scan_grad', 'LSTMScanGrad', 'scan_geometry',
           'scan_resident', 'scan_max_rows', 'bptt_geometry',
           'bptt_resident', 'bptt_max_rows', 'cluster_plan',
           'scan_launch_plan', 'bptt_launch_plan', 'scan_supported',
           'scan_cost', 'bptt_cost', 'lstm_scan_op', 'lstm_scan_residuals_op',
           'lstm_bptt_op', 'lstm_scan_grouped', 'lstm_scan_grouped_plain',
           'lstm_scan_residuals_grouped', 'lstm_scan_residuals_grouped_plain',
           'lstm_bptt_grouped', 'lstm_bptt_grouped_plain',
           'lstm_scan_grouped_grad', 'one_sequence']

MAX_HIDDEN = 1024  # 16 warps a CTA
CLUSTER = 8        # CTAs a cluster, each owning H / 8 hidden units
MAX_ROWS = 16      # batch rows a cluster (two mma n-tiles)
MAX_THREADS = 512  # threads a CTA
MAX_SHARED_BYTES = 232448  # 227 KB, the most a block may use on Hopper

_POINTER, _INT = ctypes.c_void_p, ctypes.c_int

_SCAN_SIGNATURES = {
    'lstm_scan': [_POINTER] * 10 + [_INT] * 8 + [_POINTER],
    'lstm_scan_max_active_clusters': [_INT] * 5 + [ctypes.POINTER(_INT)],
    'lstm_scan_smem': [_INT] * 4,
}
_BPTT_SIGNATURES = {
    'lstm_bptt': [_POINTER] * 11 + [_INT] * 8 + [_POINTER],
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
    one row and 8 clusters), within what the buffers fit
    (:func:`cuda_build.cluster_rows`). ``waves`` is 1
    unless the batch needs more rows than fit. ``kernel`` is ``'scan'`` (B,
    E) or ``'bptt'`` (F).

    A grouped launch of ``groups`` sequences gives each group its own
    clusters (a cluster holds one group's W_h), ``groups * ceil(batch /
    rows)`` of them: the fewest rows that still fit one wave (G = 4, B = 8:
    2 rows, 16 clusters; G = 6, B = 8: 4 rows, 12 clusters), and the most
    rows the buffers fit where none does (G = 4, B = 128: 16 rows, 32
    clusters, 2 waves). ``groups=1`` is one sequence's plan. ``hold`` sizes
    kernel F's masked or carried launch, whose dh buffer may fit fewer
    rows; it keeps the unmasked launch's residency."""

    geometry, resident_rule = _CLUSTER_KERNELS[kernel][:2]
    resident = resident_rule(hidden, dtype)
    if hold:
        geometry = functools.partial(geometry, hold=True)
    max_rows = _max_rows(geometry, hidden, dtype, resident)
    rows = cuda_build.cluster_rows(batch, groups, max_rows, active_clusters)
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


def _check_cuda(x, name, hidden):
    if x.device.type != 'cuda':
        raise ValueError(f'{name} runs on CUDA or CPU tensors, not '
                         f'{x.device}')
    if hidden > MAX_HIDDEN:
        raise ValueError(f'{name} kernel supports hidden <= {MAX_HIDDEN}, '
                         f'got {hidden}')
    if hidden % 16:
        raise ValueError(f'{name} kernel supports hidden a multiple of 16 '
                         f'(8 CTAs of whole bf16 pairs), got {hidden}')


def _aligned(x):
    """``x``, or a copy of it where its data does not start on 16 bytes."""

    return x if x.data_ptr() % 16 == 0 else x.clone()


def _pointer(x):
    return None if x is None else x.data_ptr()


def _launch_scan(xw, w_h, reverse_from, residuals, lengths, carry):
    """Kernel B, or E with ``residuals``, on CUDA tensors (G, B, T, 4H) and
    (G, H, 4H), the groups from ``reverse_from`` on reversed, with per-row
    ``lengths`` (int32, or None) and from a float32 ``carry`` ``(c0, h0)``,
    each (1, B, H) (or None) -> ``[out]``, with the residuals ``gates`` and
    ``c_seq`` after it and with a carry the final ``c`` and ``h`` last."""

    groups, batch, frames, four_h = xw.shape
    hidden = four_h // 4
    name = 'lstm_scan_residuals' if residuals else 'lstm_scan'
    _check_cuda(xw, name, hidden)

    outputs = [torch.empty(xw.shape[:-1] + (hidden,), dtype=xw.dtype,
                           device=xw.device)]
    if residuals:
        outputs += [torch.empty(xw.shape, dtype=torch.float32,
                                device=xw.device),
                    torch.empty(xw.shape[:-1] + (hidden,),
                                dtype=torch.float32, device=xw.device)]
    if carry is not None:
        outputs += [torch.empty_like(carry[0]), torch.empty_like(carry[1])]
    if batch == 0 or frames == 0 or groups == 0:
        if carry is not None:  # the carry as the next step would read it,
            # copied: an op returns no input
            outputs[-2:] = [carry[0].clone(),
                            carry[1].to(xw.dtype).float().clone()]
        return outputs

    plan = scan_launch_plan(batch, hidden, xw.dtype, xw.device, residuals,
                            groups)
    xw, w_h = _aligned(xw), _aligned(w_h)
    gates, c_seq = outputs[1:3] if residuals else (None, None)
    pointers = [_pointer(x) for x in (
        xw, w_h, outputs[0], gates, c_seq, lengths,
        *(carry or (None, None)),
        *(outputs[-2:] if carry is not None else (None, None)))]
    lib = cuda_build.library('lstm_scan', _SCAN_SIGNATURES)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.lstm_scan(
            *pointers, groups, reverse_from, batch, frames, hidden,
            int(xw.dtype == torch.bfloat16), plan['rows'],
            int(plan['resident']), stream)
    cuda_build.check(status, name)

    return outputs


def _launch_bptt(gates, c_seq, dout, w_h_t, reverse_from, lengths, carry):
    """Kernel F on CUDA tensors with a leading group axis, the groups from
    ``reverse_from`` on from a reverse forward, with per-row ``lengths``
    (int32, or None) and from ``carry`` ``(c0, dc_last, dh_last)``, float32
    (1, B, H) each (or None) -> ``[da]``, with a carry ``dc0`` and ``dh0``
    after it."""

    groups, batch, frames, four_h = gates.shape
    hidden = four_h // 4
    _check_cuda(gates, 'lstm_bptt', hidden)

    outputs = [torch.empty(gates.shape, dtype=torch.float32,
                           device=gates.device)]
    if carry is not None:
        outputs += [torch.empty_like(carry[1]), torch.empty_like(carry[2])]
    if batch == 0 or frames == 0 or groups == 0:
        # zero steps pass the final carry's gradient through, copied
        if carry is not None:
            outputs[1:] = [carry[1].clone(), carry[2].clone()]
        return outputs

    plan = bptt_launch_plan(batch, hidden, dout.dtype, gates.device, groups,
                            hold=lengths is not None or carry is not None)
    gates, c_seq, dout, w_h_t = (_aligned(t) for t in (gates, c_seq, dout,
                                                       w_h_t))
    pointers = [_pointer(x) for x in (
        gates, c_seq, dout, w_h_t, outputs[0], lengths,
        *(carry or (None,) * 3),
        *(outputs[1:] if carry is not None else (None, None)))]
    lib = cuda_build.library('lstm_bptt', _BPTT_SIGNATURES)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.lstm_bptt(
            *pointers, groups, reverse_from, batch, frames, hidden,
            int(dout.dtype == torch.bfloat16), plan['rows'],
            int(plan['resident']), stream)
    cuda_build.check(status, 'lstm_bptt')

    return outputs


def _check_inputs(xw, w_h, reverse_from):
    cuda_build.require_plain('lstm_scan', xw=xw, w_h=w_h)
    if xw.dim() != 4 or xw.shape[-1] % 4:
        raise ValueError(f'xw must be (G, B, T, 4H) (a sequence: (B, T, '
                         f'4H)), got shape {tuple(xw.shape)}')
    hidden = xw.shape[-1] // 4
    shape = (xw.shape[0], hidden, 4 * hidden)
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
    _check_reverse_from(reverse_from, xw.shape[0])


def _check_bptt_inputs(gates, c_seq, dout, w_h_t, reverse_from):
    cuda_build.require_plain('lstm_bptt', gates=gates, c_seq=c_seq,
                             dout=dout, w_h_t=w_h_t)
    if gates.dim() != 4 or gates.shape[-1] % 4:
        raise ValueError(f'gates must be (G, B, T, 4H) (a sequence: (B, T, '
                         f'4H)), got shape {tuple(gates.shape)}')
    groups, batch, frames, four_h = gates.shape
    hidden = four_h // 4
    shapes = {'c_seq': (c_seq, (groups, batch, frames, hidden)),
              'dout': (dout, (groups, batch, frames, hidden)),
              'w_h_t': (w_h_t, (groups, four_h, hidden))}
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
    _check_reverse_from(reverse_from, groups)


def _check_reverse_from(reverse_from, groups):
    if not 0 <= reverse_from <= groups:
        raise ValueError(f'reverse_from must lie in [0, {groups}], got '
                         f'{reverse_from}')


def _check_lengths(lengths, xw):
    """Per-row lengths as the kernel takes them: int32 (B,) on xw's device,
    each in [0, T]; None stays None."""

    if lengths is None:
        return None
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
    """Float32 (1, B, H) carries (or their gradients) as the kernels take
    them: each contiguous on xw's device, of the one group of xw (1, B, T,
    4H) or of the gates. A carry is taken at G = 1 only: the kernels'
    carry is one group's."""

    groups, batch, _, four_h = xw.shape
    if groups != 1:
        raise ValueError(f'{kernel} takes a carry at one group only, got '
                         f'{groups} groups')
    checked = []
    for name, x in tensors.items():
        x = torch.as_tensor(x)
        cuda_build.require_plain(kernel, **{name: x})
        if tuple(x.shape) != (1, batch, four_h // 4):
            raise ValueError(f'{name} must be (1, {batch}, {four_h // 4}) '
                             f'(a sequence: ({batch}, {four_h // 4})), got '
                             f'{tuple(x.shape)}')
        if not x.dtype.is_floating_point:
            raise TypeError(f'{name} must be floating point, got {x.dtype}')
        checked.append(x.to(device=xw.device, dtype=torch.float32)
                       .contiguous())

    return tuple(checked)


def _check_carry(initial_carry, xw, return_carry=True):
    """A carry as the kernels take it: float32 ``(c, h)``, each (1, B, H),
    contiguous on xw's device; zeros when none is given but one is
    returned, and ``(None, None)`` when neither."""

    if initial_carry is None:
        if not return_carry:
            return None, None
        zeros = torch.zeros((1, xw.shape[1], xw.shape[-1] // 4),
                            dtype=torch.float32, device=xw.device)
        initial_carry = (zeros, zeros.clone())
    if len(initial_carry) != 2:
        raise ValueError('initial_carry must be a pair (c, h)')

    return _check_rows(xw, 'lstm_scan', **{'initial_carry c': initial_carry[0],
                                           'initial_carry h': initial_carry[1]})


def scan_cost(batch, frames, hidden, dtype, residuals=False, carried=False,
              steps=None):
    """``(flops, bytes)`` of one sequence of a launch of kernel B (E with
    ``residuals``): the recurrent product, 2 H 4H operations a row and
    step, over ``steps`` row-steps (``batch * frames`` unless lengths say
    fewer); xw and W_h read and h written once in ``dtype``, E's float32
    gates and cell states written, a float32 carry read and written, int32
    lengths read. A launch of G groups costs G times this."""

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
    """``(flops, bytes)`` of one sequence of a launch of kernel F: the carry
    product, 2 4H H operations a row and step, over ``steps`` row-steps
    (``batch * frames`` unless lengths say fewer), and with ``carried`` one
    more a row for the initial carry's gradient; the float32 gates and cell
    states read and the float32 da written, dout and W_h^T read in
    ``dtype``, the float32 c0 and final carry's gradient read and the
    initial carry's written. A launch of G groups costs G times this."""

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


def _count(wrapper, groups, lengths, carried):
    """One launch of ``wrapper``'s kernel, and of its masked, carried or
    grouped (G > 1) route."""

    cuda_build.count(wrapper, 'launches',
                     *(('masked_launches',) if lengths is not None else ()),
                     *(('carried_launches',) if carried else ()),
                     *(('grouped_launches',) if groups > 1 else ()))


def _fresh(outputs, inputs):
    """``outputs`` with any tensor that is one of ``inputs`` copied: an op
    returns no input (the carry of zero steps is the one given)."""

    return tuple(x.clone() if any(x is y for y in inputs) else x
                 for x in outputs)


def _carried_plain(plain, tensors, reverse_from, lengths, carry, **kwargs):
    """A plain version over the one group of ``tensors`` from ``carry``
    (each (1, B, H)) -> its outputs, the carry it returns last, each with
    the group axis."""

    carry = tuple(x[0] for x in carry)
    result = plain(*(t[0] for t in tensors), reverse_from == 0, lengths,
                   carry, **kwargs)
    flat = [x for r in result for x in (r if isinstance(r, tuple) else (r,))]

    return [x[None] for x in _fresh(flat, carry)]


def _scan_op(wrapper, xw, w_h, reverse_from, lengths, c0, h0, residuals):
    carry = None if c0 is None else (c0, h0)
    if xw.device.type == 'cpu':
        if carry is not None:
            plain = (lstm_scan_residuals_plain if residuals else
                     lstm_scan_plain)
            return _carried_plain(plain, (xw, w_h), reverse_from, lengths,
                                  carry, return_carry=True)
        if residuals:
            return list(lstm_scan_residuals_grouped_plain(
                xw, w_h, reverse_from, lengths))
        return [lstm_scan_grouped_plain(xw, w_h, reverse_from, lengths)]

    outputs = _launch_scan(xw, w_h, reverse_from, residuals, lengths, carry)
    _count(wrapper, xw.shape[0], lengths, carry is not None)

    return outputs


def _scan_fake(xw, c0, h0, residuals):
    hidden = xw.shape[-1] // 4
    outputs = [xw.new_empty(xw.shape[:-1] + (hidden,))]
    if residuals:
        outputs += [xw.new_empty(xw.shape, dtype=torch.float32),
                    xw.new_empty(xw.shape[:-1] + (hidden,),
                                 dtype=torch.float32)]
    if c0 is not None:
        outputs += [torch.empty_like(c0), torch.empty_like(h0)]

    return outputs


def _scan_op_cost(xw, w_h, reverse_from, lengths, c0=None, h0=None,
                  residuals=False):
    groups, batch, frames, four_h = xw.shape
    flops, num_bytes = scan_cost(batch, frames, four_h // 4, xw.dtype,
                                 residuals, carried=c0 is not None,
                                 steps=_valid_steps(lengths))

    return groups * flops, groups * num_bytes


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_scan',
                         mutates_args=())
def lstm_scan_op(xw: torch.Tensor, w_h: torch.Tensor, reverse_from: int,
                 lengths: Optional[torch.Tensor], c0: Optional[torch.Tensor],
                 h0: Optional[torch.Tensor]) -> list[torch.Tensor]:
    """Kernel B as an op -> ``[out]``, or ``[out, c, h]`` from the carry
    ``(c0, h0)`` (inputs as :func:`lstm_scan_grouped` checks them)."""

    return _scan_op(lstm_scan, xw, w_h, reverse_from, lengths, c0, h0,
                    residuals=False)


@lstm_scan_op.register_fake
def _(xw, w_h, reverse_from, lengths, c0, h0):
    return _scan_fake(xw, c0, h0, residuals=False)


cuda_build.register_cost(lstm_scan_op, _scan_op_cost)


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_scan_residuals',
                         mutates_args=())
def lstm_scan_residuals_op(
        xw: torch.Tensor, w_h: torch.Tensor, reverse_from: int,
        lengths: Optional[torch.Tensor], c0: Optional[torch.Tensor],
        h0: Optional[torch.Tensor]) -> list[torch.Tensor]:
    """Kernel E as an op -> ``[out, gates, c_seq]``, with ``c`` and ``h``
    after them from the carry ``(c0, h0)``."""

    return _scan_op(lstm_scan_residuals, xw, w_h, reverse_from, lengths, c0,
                    h0, residuals=True)


@lstm_scan_residuals_op.register_fake
def _(xw, w_h, reverse_from, lengths, c0, h0):
    return _scan_fake(xw, c0, h0, residuals=True)


cuda_build.register_cost(lstm_scan_residuals_op,
                         functools.partial(_scan_op_cost, residuals=True))


@torch.library.custom_op(f'{cuda_build.NAMESPACE}::lstm_bptt',
                         mutates_args=())
def lstm_bptt_op(gates: torch.Tensor, c_seq: torch.Tensor,
                 dout: torch.Tensor, w_h_t: torch.Tensor, reverse_from: int,
                 lengths: Optional[torch.Tensor], c0: Optional[torch.Tensor],
                 dc_last: Optional[torch.Tensor],
                 dh_last: Optional[torch.Tensor]) -> list[torch.Tensor]:
    """Kernel F as an op -> ``[da]``, or ``[da, dc0, dh0]`` from the
    gradient ``(dc_last, dh_last)`` of the forward's final carry, reading
    ``c0`` as its first step's ``c_prev`` (inputs as
    :func:`lstm_bptt_grouped` checks them)."""

    carry = None if c0 is None else (c0, dc_last, dh_last)
    if gates.device.type == 'cpu':
        if carry is None:
            return [lstm_bptt_grouped_plain(gates, c_seq, dout, w_h_t,
                                            reverse_from, lengths)]
        return _carried_plain(lstm_bptt_plain, (gates, c_seq, dout, w_h_t),
                              reverse_from, lengths, carry)

    outputs = _launch_bptt(gates, c_seq, dout, w_h_t, reverse_from, lengths,
                           carry)
    _count(lstm_bptt, gates.shape[0], lengths, carry is not None)

    return outputs


@lstm_bptt_op.register_fake
def _(gates, c_seq, dout, w_h_t, reverse_from, lengths, c0, dc_last,
      dh_last):
    outputs = [torch.empty_like(gates)]
    if c0 is not None:
        outputs += [torch.empty_like(dc_last), torch.empty_like(dh_last)]

    return outputs


def _bptt_op_cost(gates, c_seq, dout, w_h_t, reverse_from, lengths, c0=None,
                  dc_last=None, dh_last=None):
    groups, batch, frames, four_h = gates.shape
    flops, num_bytes = bptt_cost(batch, frames, four_h // 4, dout.dtype,
                                 carried=c0 is not None,
                                 steps=_valid_steps(lengths))

    return groups * flops, groups * num_bytes


cuda_build.register_cost(lstm_bptt_op, _bptt_op_cost)


def lstm_scan_grouped(xw, w_h, reverse_from, lengths=None, initial_carry=None,
                      return_carry=False):
    """G whole-sequence LSTMs in one launch: (G, B, T, 4H) projections and
    (G, H, 4H) recurrent kernels in one dtype -> (G, B, T, H).

    ``xw`` holds the hoisted input projections including the bias, ``w_h``
    the recurrent kernels in the same dtype (float32 or bf16; gate order
    i, f, g, o). Group g walks front to back for ``g < reverse_from`` and
    back to front (writing its outputs in natural order) from there on.
    ``lengths`` (B,) integers in [0, T], every group's, mask each row's
    padded tail: from ``t = lengths[b]`` on, row b keeps its carry and
    writes 0, so its valid frames equal an unpadded run's bit for bit (a
    reverse scan starts at the row's true end). ``initial_carry`` ``(c,
    h)``, each (1, B, H), starts the recurrence of one group (G = 1) in
    place of zeros, in float32; with ``return_carry`` the result is ``(out,
    (c, h))``: the float32 final state, h as the next step reads it
    (rounded to bf16 in bf16 mode), so a sequence cut into chunks that
    thread it equals one whole call bit for bit. CUDA tensors go through
    kernel B, one launch (or raise); CPU tensors through the plain
    versions; both through :data:`lstm_scan_op`."""

    _check_inputs(xw, w_h, reverse_from)
    out, *final = lstm_scan_op(xw, w_h, int(reverse_from),
                               _check_lengths(lengths, xw),
                               *_check_carry(initial_carry, xw, return_carry))

    return (out, tuple(final)) if return_carry else out


def lstm_scan_residuals_grouped(xw, w_h, reverse_from, lengths=None,
                                initial_carry=None, return_carry=False):
    """:func:`lstm_scan_grouped` that also returns the residuals of the
    backward: ``(out, gates, c)`` with float32 gate activations (G, B, T,
    4H) in order i, f, g, o and float32 cell states (G, B, T, H), and with
    ``return_carry`` the final carry after them, ``(out, gates, c, (c_last,
    h_last))``; a masked step's cell state is the kept one. CUDA tensors go
    through kernel E, one launch (or raise); CPU tensors through the plain
    versions; both through :data:`lstm_scan_residuals_op`."""

    _check_inputs(xw, w_h, reverse_from)
    outputs = lstm_scan_residuals_op(
        xw, w_h, int(reverse_from), _check_lengths(lengths, xw),
        *_check_carry(initial_carry, xw, return_carry))

    if return_carry:
        return (*outputs[:3], tuple(outputs[3:]))
    return tuple(outputs[:3])


def lstm_bptt_grouped(gates, c_seq, dout, w_h_t, reverse_from, lengths=None,
                      carry=None):
    """BPTT over the residuals of :func:`lstm_scan_residuals_grouped` ->
    d(xw) as float32 (G, B, T, 4H).

    ``gates`` (G, B, T, 4H) and ``c_seq`` (G, B, T, H) are float32;
    ``dout`` (G, B, T, H) and the transposed recurrent kernels ``w_h_t``
    (G, 4H, H) are in the forward's compute dtype (float32 or bf16). The
    groups from ``reverse_from`` on had a reverse forward; ``lengths`` (B,),
    every group's, name its masked rows: a row has da = 0 past its length
    and carries its gradients through. ``carry`` ``(c0, dc_last,
    dh_last)``, each (1, B, H) of one group (G = 1), names the forward's
    initial cell state and the gradient of its final carry; the result is
    then ``(da, dc0, dh0)``, float32, the gradient of its initial carry
    (:func:`lstm_bptt_plain`). CUDA tensors go through kernel F, one launch
    (or raise); CPU tensors through the plain versions; both through
    :data:`lstm_bptt_op`."""

    _check_bptt_inputs(gates, c_seq, dout, w_h_t, reverse_from)
    if carry is not None:
        if len(carry) != 3:
            raise ValueError('carry must be (c0, dc_last, dh_last)')
        carry = _check_rows(gates, 'lstm_bptt', c0=carry[0],
                            dc_last=carry[1], dh_last=carry[2])
    result = lstm_bptt_op(gates, c_seq, dout, w_h_t, int(reverse_from),
                          _check_lengths(lengths, gates),
                          *(carry or (None,) * 3))

    return result[0] if carry is None else tuple(result)


def one_sequence(grouped, tensors, reverse, lengths, carry, **kwargs):
    """``grouped(*tensors, reverse_from, lengths, carry, **kwargs)`` over
    one sequence: its tensors and carry given a leading group axis of one,
    run forward or reversed (``reverse_from`` 1 or 0), the results (tensors
    or nested tuples of them) without the axis."""

    if carry is not None:
        carry = tuple(torch.as_tensor(x)[None] for x in carry)
    result = grouped(*(t[None] for t in tensors), 0 if reverse else 1,
                     lengths, carry, **kwargs)

    return _first_group(result)


def _first_group(result):
    if isinstance(result, tuple):
        return tuple(_first_group(x) for x in result)

    return result.squeeze(0)


def lstm_scan(xw, w_h, reverse=False, lengths=None, initial_carry=None,
              return_carry=False):
    """Whole-sequence LSTM: (B, T, 4H) projections, (H, 4H) recurrent
    kernel -> (B, T, H), :func:`lstm_scan_grouped` at G = 1 (``reverse``
    walks back to front and writes outputs in natural order; a carry
    ``(c, h)`` is (B, H) each)."""

    return one_sequence(lstm_scan_grouped, (xw, w_h), reverse, lengths,
                        initial_carry, return_carry=return_carry)


lstm_scan.launches = 0
lstm_scan.masked_launches = 0  # those of lstm_scan.launches with lengths
lstm_scan.carried_launches = 0  # those with a carry in and out
lstm_scan.grouped_launches = 0  # those of more than one group


def lstm_scan_residuals(xw, w_h, reverse=False, lengths=None,
                        initial_carry=None, return_carry=False):
    """:func:`lstm_scan` that also returns the residuals of the backward,
    :func:`lstm_scan_residuals_grouped` at G = 1: ``(out, gates, c)``, each
    (B, T, ·), and with ``return_carry`` the final carry after them."""

    return one_sequence(lstm_scan_residuals_grouped, (xw, w_h), reverse,
                        lengths, initial_carry, return_carry=return_carry)


lstm_scan_residuals.launches = 0
lstm_scan_residuals.masked_launches = 0  # those with lengths
lstm_scan_residuals.carried_launches = 0  # those with a carry in and out
lstm_scan_residuals.grouped_launches = 0  # those of more than one group


def lstm_bptt(gates, c_seq, dout, w_h_t, reverse=False, lengths=None,
              carry=None):
    """BPTT over the residuals of :func:`lstm_scan_residuals` -> d(xw) as
    float32 (B, T, 4H), :func:`lstm_bptt_grouped` at G = 1: ``w_h_t`` is
    (4H, H), ``reverse`` the forward's direction, a ``carry`` ``(c0,
    dc_last, dh_last)`` (B, H) each, and the result then ``(da, dc0,
    dh0)``."""

    return one_sequence(lstm_bptt_grouped, (gates, c_seq, dout, w_h_t),
                        reverse, lengths, carry)


lstm_bptt.launches = 0
lstm_bptt.masked_launches = 0  # those with lengths
lstm_bptt.carried_launches = 0  # those with a carry's gradient in and out
lstm_bptt.grouped_launches = 0  # those of more than one group


def _shift_prev(x, reverse):
    """The previous step's value at each t of (..., T, H) (zero at the
    sequence's start): t - 1 for a forward scan, t + 1 for a reverse one."""

    zero = torch.zeros_like(x[..., :1, :])
    if reverse:
        return torch.cat([x[..., 1:, :], zero], dim=-2)

    return torch.cat([zero, x[..., :-1, :]], dim=-2)


def _h_prev(out, reverse_from, lengths=None, h0=None):
    """The float32 h each step's recurrent product read, (G, B, T, H): the
    previous step's output (a masked step's is 0, and its da is too), the
    groups from ``reverse_from`` on reversed, and at a row's first step
    ``h0`` (1, B, H) as the step read it, rounded to out's dtype (zero
    without a carry). A reverse row with lengths starts at ``t = lengths -
    1``, where the shifted output reads a masked step."""

    prev = torch.cat([_shift_prev(out[:reverse_from], False),
                      _shift_prev(out[reverse_from:], True)]).float()
    if h0 is None:
        return prev

    batch, frames = out.shape[1:3]
    if reverse_from:
        first = torch.zeros(batch, dtype=torch.int64, device=out.device)
    elif lengths is None:
        first = torch.full((batch,), frames - 1, device=out.device)
    else:
        first = lengths.to(torch.int64) - 1
    at_first = torch.arange(frames, device=out.device) == first[:, None]

    return torch.where(at_first[..., None],
                       h0.to(out.dtype).float()[:, :, None, :], prev)


def _dw_h(h_prev, da):
    """dW_h = sum over rows and steps of h_prev^T da, a float32 matmul
    outside the kernel: one ``mm`` for one group, batched over more."""

    groups, hidden = h_prev.shape[0], h_prev.shape[-1]
    if groups == 1:
        return (h_prev.reshape(-1, hidden).t() @
                da.reshape(-1, 4 * hidden))[None]

    return torch.bmm(h_prev.reshape(groups, -1, hidden).transpose(1, 2),
                     da.reshape(groups, -1, 4 * hidden))


class LSTMScanGrad(torch.autograd.Function):
    """The differentiable recurrence of G groups: kernel E forward, kernel
    F backward, each one launch for every group; masked by per-row
    ``lengths`` or not; from a carry ``(c0, h0)`` (G = 1) or zeros, and
    then returning ``(out, c, h)`` with the final carry, whose gradient
    reaches ``c0`` and ``h0``.

    Takes ``w_h`` in its parameter dtype and casts it to the compute dtype
    inside (bf16 when ``xw`` is bf16, else float32), so ``dW_h`` comes back
    in the parameter's own dtype, as ``_lstm_grad_bwd`` returns it
    (``pallas_lstm.py:406-437``).
    """

    @staticmethod
    def forward(ctx, xw, w_h, reverse_from, lengths=None, c0=None, h0=None):
        xw, w = xw.contiguous(), w_h.to(xw.dtype).contiguous()
        _check_inputs(xw, w, reverse_from)
        lengths = _check_lengths(lengths, xw)
        carry = _check_carry(None if c0 is None else (c0, h0), xw,
                             return_carry=False)
        out, gates, c_seq, *final = lstm_scan_residuals_op(
            xw, w, int(reverse_from), lengths, *carry)
        ctx.reverse_from = int(reverse_from)
        ctx.dtypes = (w_h.dtype,) + ((c0.dtype, h0.dtype) if final else ())
        ctx.save_for_backward(w_h, out, gates, c_seq, lengths, *carry)

        return (out, *final) if final else out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, *dfinal):
        with profiling.span('amt.lstm.backward'):
            w_h, out, gates, c_seq, lengths, c0, h0 = ctx.saved_tensors

            w_h_t = w_h.transpose(-1, -2).to(out.dtype).contiguous()
            dout = dout.to(out.dtype).contiguous()
            _check_bptt_inputs(gates, c_seq, dout, w_h_t, ctx.reverse_from)
            if c0 is not None:
                dfinal = _check_rows(gates, 'lstm_bptt', dc_last=dfinal[0],
                                     dh_last=dfinal[1])
            da, *dcarry = lstm_bptt_op(gates, c_seq, dout, w_h_t,
                                       ctx.reverse_from, lengths, c0,
                                       *(dfinal or (None, None)))
            h_prev = _h_prev(out, ctx.reverse_from, lengths, h0)
            w_dtype, *carry_dtypes = ctx.dtypes

            return (da.to(out.dtype), _dw_h(h_prev, da).to(w_dtype), None,
                    None, *([d.to(t) for d, t in zip(dcarry, carry_dtypes)]
                            or (None, None)))


def lstm_scan_grouped_grad(xw, w_h, reverse_from, lengths=None,
                           initial_carry=None, return_carry=False):
    """Differentiable :func:`lstm_scan_grouped`: (G, B, T, 4H) float32 or
    bf16 ``xw``, (G, H, 4H) ``w_h`` in any float dtype -> (G, B, T, H) in
    xw's dtype, or ``(out, (c, h))`` with ``return_carry``; ``lengths`` and
    ``initial_carry`` as :func:`lstm_scan_grouped`'s.

    The same outputs as :func:`lstm_scan_grouped` (kernel E is kernel B's
    body); under autograd the backward runs kernel F and returns ``d(xw)``
    in xw's dtype, ``dW_h`` in w_h's and the initial carry's gradient in
    its own dtypes."""

    if initial_carry is None and return_carry:
        initial_carry = _check_carry(None, xw)
    carry = (None, None) if initial_carry is None else initial_carry
    if len(carry) != 2:
        raise ValueError('initial_carry must be a pair (c, h)')
    result = LSTMScanGrad.apply(xw, w_h, reverse_from, lengths, *carry)
    if initial_carry is None:
        return result

    out, c, h = result

    return (out, (c, h)) if return_carry else out


def lstm_scan_grad(xw, w_h, reverse=False, lengths=None, initial_carry=None,
                   return_carry=False):
    """Differentiable :func:`lstm_scan`: (B, T, 4H) float32 or bf16 ``xw``,
    (H, 4H) ``w_h`` in any float dtype -> (B, T, H) in xw's dtype, or
    ``(out, (c, h))`` with ``return_carry``; :func:`lstm_scan_grouped_grad`
    at G = 1."""

    return one_sequence(lstm_scan_grouped_grad, (xw, w_h), reverse,
                        lengths, initial_carry, return_carry=return_carry)
