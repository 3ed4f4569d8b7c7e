"""Kernel F's cluster design (``csrc/lstm_bptt.cu``) on the CPU: its launch
geometry, and a step-for-step torch emulation of the kernel held to
``lstm_bptt_plain`` and to ``jax.grad`` of the JAX package's
``lstm_scan_pallas_grad`` in interpret mode. The kernel itself is held to
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The emulation follows what the kernel does that the plain version does not:
each of the 8 CTAs owns H/8 units and forms their gate gradients; what
crosses CTAs is da, gathered into every CTA's next-step buffer in rank
order (bf16-rounded in bf16 mode); each CTA's carry product for its own
units deals the k steps round robin over ``slices`` groups (16 rows an mma
step in bf16 with two alternating accumulators, 4 rows an FFMA step in
float32), and the partial sums are added in slice order.

Tolerances: the emulation against the plain version and against JAX, in
float32 1e-5 of the largest value (sums in another order); in bf16 the
card's bounds, 5e-4 of the largest value and 1e-4 of the mean magnitude on
the mean, against the plain version (the same residuals on both sides), and
the JAX comparison's max 2e-2 and mean 1e-3 of the largest value
(``tests/test_torch_lstm_grad.py``: the interpreted Pallas forward rounds
its bf16 gates at other places).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu.ops.pallas_lstm import lstm_scan_pallas_grad

from amt_tools_tpu_torch.ops.lstm_kernel import (CLUSTER, MAX_ROWS,
                                                 MAX_SHARED_BYTES,
                                                 bptt_geometry, bptt_max_rows,
                                                 bptt_resident, cluster_plan,
                                                 lstm_bptt_plain,
                                                 lstm_scan_residuals)

torch.set_num_threads(1)

DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _carry_product(da_x, w_h_t, geo, rank, dtype):
    """CTA ``rank``'s dh_carry for its units: partial sums of its k steps,
    dealt round robin over the slices per chunk, added in slice order."""

    units = geo['units']
    four_h = w_h_t.shape[0]
    cols = slice(rank * units, (rank + 1) * units)
    w = w_h_t[:, cols].float()
    da = da_x.float()
    step = 16 if dtype == torch.bfloat16 else 4
    slices, chunk = geo['slices'], geo['chunk']
    partial = torch.zeros((slices, 2) + (da.shape[0], units))
    for k0 in range(0, four_h, chunk):
        steps = min(chunk, four_h - k0) // step
        for sl in range(slices):
            for i, ks in enumerate(range(sl, steps, slices)):
                k = slice(k0 + ks * step, k0 + (ks + 1) * step)
                # bf16: two accumulators take alternate k steps of a slice
                acc = i % 2 if dtype == torch.bfloat16 else 0
                partial[sl, acc] += da[:, k] @ w[k]
    carry = torch.zeros((da.shape[0], units))
    for sl in range(slices):
        carry = carry + (partial[sl, 0] + partial[sl, 1])
    return carry


def emulate_cluster_bptt(gates, c_seq, dout, w_h_t, reverse, rows):
    """Kernel F step for step, cluster by cluster, CTA by CTA."""

    batch, frames, four_h = gates.shape
    hidden = four_h // 4
    dtype = dout.dtype
    geo = bptt_geometry(hidden, dtype, rows, bptt_resident(hidden, dtype))
    units = geo['units']
    da_out = torch.zeros((batch, frames, four_h))

    for row0 in range(0, batch, rows):
        b = slice(row0, min(row0 + rows, batch))
        n = b.stop - b.start
        dc = torch.zeros((n, hidden))
        da_x = torch.zeros((n, four_h), dtype=dtype)  # the exchanged da
        for s in range(frames):
            t = s if reverse else frames - 1 - s
            t_prev = t + 1 if reverse else t - 1
            step = torch.zeros((n, four_h))
            for rank in range(CLUSTER):
                u = slice(rank * units, (rank + 1) * units)
                carry = (_carry_product(da_x, w_h_t, geo, rank, dtype) if s
                         else torch.zeros((n, units)))
                i_g, f_g, g_g, o_g = (gates[b, t, q * hidden:][:, u]
                                      for q in range(4))
                c_t = c_seq[b, t, u]
                c_prev = (c_seq[b, t_prev, u] if 0 <= t_prev < frames
                          else torch.zeros_like(c_t))
                tanh_c = torch.tanh(c_t)
                dh = dout[b, t, u].float() + carry
                da_o = dh * tanh_c * o_g * (1.0 - o_g)
                dcu = dc[:, u] + dh * o_g * (1.0 - tanh_c * tanh_c)
                da_i = dcu * g_g * i_g * (1.0 - i_g)
                da_g = dcu * i_g * (1.0 - g_g * g_g)
                da_f = dcu * c_prev * f_g * (1.0 - f_g)
                dc[:, u] = dcu * f_g
                for q, value in enumerate((da_i, da_f, da_g, da_o)):
                    step[:, q * hidden + rank * units:
                         q * hidden + (rank + 1) * units] = value
            da_out[b, t] = step
            # every CTA's slices, gathered in rank order, as the product
            # reads them
            da_x = step.to(dtype)

    return da_out


def _inputs(batch, frames, hidden, seed):
    rng = np.random.RandomState(seed)
    xw = (rng.randn(batch, frames, 4 * hidden) * 0.5).astype(np.float32)
    w_h = (rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)).astype(np.float32)
    dout = rng.randn(batch, frames, hidden).astype(np.float32)
    return xw, w_h, dout


def _rel_errors(got, ref):
    diff = (got - ref).abs()
    return ((diff.max() / ref.abs().max()).item(),
            (diff.mean() / ref.abs().mean()).item())


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('hidden', [16, 48, 64])
def test_emulation_matches_plain_and_pallas_vjp(dtype, reverse, hidden):
    """B = 3 in clusters of 2 rows (the second part empty), T = 37 (not a
    multiple of the Pallas kernels' block of 16)."""

    torch_dtype, jax_dtype = DTYPES[dtype]
    batch, frames = 3, 37
    xw, w_h, dout = _inputs(batch, frames, hidden, seed=hidden)

    out, gates, c_seq = lstm_scan_residuals(
        torch.from_numpy(xw).to(torch_dtype),
        torch.from_numpy(w_h).to(torch_dtype), reverse)
    dout_t = torch.from_numpy(dout).to(torch_dtype)
    w_h_t = torch.from_numpy(w_h.T.copy()).to(torch_dtype)

    got = emulate_cluster_bptt(gates, c_seq, dout_t, w_h_t, reverse, rows=2)
    ref = lstm_bptt_plain(gates, c_seq, dout_t, w_h_t, reverse)
    worst, mean = _rel_errors(got, ref)
    if dtype == 'float32':
        assert worst <= 1e-5, worst
    else:
        assert worst <= 5e-4 and mean <= 1e-4, (worst, mean)

    def loss(x, w):
        out = lstm_scan_pallas_grad(x, w, reverse, 16, True)
        return jnp.sum(out.astype(jnp.float32) * dout)

    ref_x, _ = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(xw).astype(jax_dtype), jnp.asarray(w_h))
    ref_x = torch.from_numpy(np.array(ref_x.astype(jnp.float32)))
    # JAX's d(xw) is in xw's dtype, as the port's Function returns da
    diff = (got.to(torch_dtype).float() - ref_x).abs()
    scale = ref_x.abs().max()
    if dtype == 'float32':
        assert diff.max() <= 1e-5 * scale, diff.max() / scale
    else:
        assert diff.max() <= 2e-2 * scale and diff.mean() <= 1e-3 * scale


def test_emulation_exchanges_rounded_da():
    """In bf16 the carry product reads the exchanged, bf16-rounded da: an
    emulation that sent float32 da would leave the card's mean bound."""

    xw, w_h, dout = _inputs(4, 40, 64, seed=1)
    out, gates, c_seq = lstm_scan_residuals(
        torch.from_numpy(xw).bfloat16(), torch.from_numpy(w_h).bfloat16())
    dout_t = torch.from_numpy(dout).bfloat16()
    w_h_t = torch.from_numpy(w_h.T.copy()).bfloat16()
    ref = lstm_bptt_plain(gates, c_seq, dout_t, w_h_t)

    sent_f32 = emulate_cluster_bptt(gates, c_seq, dout_t.float(),
                                    w_h_t.float(), False, rows=4)
    assert _rel_errors(sent_f32, ref)[1] > 1e-4


# The launch geometry: what the wrapper computes before a launch, from the
# card's count of clusters it holds at once (given by hand here)

@pytest.mark.parametrize('batch,dtype,active,rows,clusters,waves', [
    (8, torch.float32, 16, 1, 8, 1),     # the training batch: 64 SMs
    (8, torch.bfloat16, 16, 1, 8, 1),
    (1, torch.float32, 16, 1, 1, 1),
    (130, torch.bfloat16, 16, 9, 15, 1),
    (130, torch.float32, 16, 6, 22, 2),  # float32 fits 6 rows at H = 256
])
def test_rows_and_clusters_from_batch(batch, dtype, active, rows, clusters,
                                      waves):
    plan = cluster_plan(batch, 256, dtype, active, kernel='bptt')

    assert (plan['rows'], plan['clusters'], plan['waves']) == (
        rows, clusters, waves)
    assert plan['ctas'] == CLUSTER * clusters and plan['resident']


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_shared_memory_fits_for_every_supported_hidden(dtype):
    size = torch.finfo(dtype).bits // 8
    for hidden in range(16, 1025, 16):
        resident = bptt_resident(hidden, dtype)
        max_rows = bptt_max_rows(hidden, dtype, resident)
        assert 2 <= max_rows <= MAX_ROWS
        for rows in range(1, max_rows + 1):
            geo = bptt_geometry(hidden, dtype, rows, resident)
            assert geo['bytes'] <= MAX_SHARED_BYTES
            assert all(part % 16 == 0 for part in geo['parts'].values())
            assert geo['threads'] <= 512 and geo['threads'] % 32 == 0
        # the slice on chip: all of 4H x H/8 when resident, two chunks of
        # rows in whole k steps when streamed
        geo = bptt_geometry(hidden, dtype, 1, resident)
        slice_bytes = 4 * hidden * geo['units'] * size
        assert geo['units'] * CLUSTER == hidden
        if resident:
            assert geo['parts']['w'] >= slice_bytes
        else:
            assert geo['parts']['w'] < slice_bytes and geo['chunk'] % 64 == 0


@pytest.mark.parametrize('hidden,dtype,resident', [
    (16, torch.float32, True), (256, torch.float32, True),
    (272, torch.float32, False), (1024, torch.float32, False),
    (256, torch.bfloat16, True), (352, torch.bfloat16, True),
    (368, torch.bfloat16, False), (1024, torch.bfloat16, False)])
def test_w_slice_resident_or_streamed(hidden, dtype, resident):
    assert bptt_resident(hidden, dtype) == resident


def test_training_shape():
    """H = 256: the W_h^T slice is 128 KiB in float32 and 64 KiB in bf16,
    as kernel B's; k is dealt over 16 FFMA slices (512 threads) or 8 mma
    slices of the 2 unit tiles (16 warps)."""

    for dtype, slice_kib, threads, slices in (
            (torch.float32, 128, 512, 16), (torch.bfloat16, 64, 512, 8)):
        geo = bptt_geometry(256, dtype, 1, True)
        size = torch.finfo(dtype).bits // 8
        assert 1024 * 32 * size == slice_kib * 1024
        assert geo['parts']['w'] == 1024 * (32 * size + 16)
        assert (geo['threads'], geo['slices']) == (threads, slices)
