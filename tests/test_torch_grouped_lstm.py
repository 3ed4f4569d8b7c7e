"""The grouped recurrence (the fused_lms layout) on the CPU: grouped kernels
B, E and F through their plain versions, ``LSTMScanGroupedGrad``,
``GroupedBiLSTM`` and the grouped cluster plan, against per-stream runs and
the JAX package's grouped scan (``ops/lstm.py`` ``_grouped_lstm_scan``,
``GroupedBiLSTM``).

The port runs a BiLSTM's backward groups reversed in the launch where JAX
scans time-flipped copies; the comparisons flip JAX's side back.
Tolerances: per-stream plain runs bit for bit (a group's plain version is
its stream's); JAX's float32 scan within 1e-5 (float32 sums in another
order through the recurrence), its gradients within 1e-5 of their largest
value. In bf16, JAX's scan rounds the carry to bf16 every step where the
kernels keep it in float32 (the divergence of the ungrouped layers), so
bf16 is held to the per-stream plain runs only.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu.ops.lstm import GroupedBiLSTM as JaxGroupedBiLSTM
from amt_tools_tpu.ops.lstm import _grouped_lstm_scan

from amt_tools_tpu_torch.ops import lstm_kernel
from amt_tools_tpu_torch.ops.lstm import GroupedBiLSTM
from amt_tools_tpu_torch.ops.lstm_kernel import (
    cluster_plan, lstm_bptt_grouped, lstm_bptt_plain, lstm_scan_grad,
    lstm_scan_grouped, lstm_scan_grouped_grad, lstm_scan_plain,
    lstm_scan_residuals_grouped, lstm_scan_residuals_plain)
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

STREAMS, BATCH, FRAMES, HIDDEN = 2, 3, 11, 16
LENGTHS = [11, 0, 6]


def _data(seed=0, streams=STREAMS, hidden=HIDDEN):
    rng = np.random.RandomState(seed)
    groups = 2 * streams
    xw = (rng.randn(groups, BATCH, FRAMES, 4 * hidden) * 0.5).astype(
        np.float32)
    w_h = (rng.randn(groups, hidden, 4 * hidden) * 0.2).astype(np.float32)
    dout = rng.randn(groups, BATCH, FRAMES, hidden).astype(np.float32)
    return xw, w_h, dout


def _jax_scan(xw, w_h, streams, lengths=None):
    """JAX's grouped scan over [forward groups, time-flipped backward
    groups], its backward outputs flipped back: the port's layout."""

    xw = jnp.concatenate([xw[:streams], jnp.flip(xw[streams:], axis=2)])
    mask = None
    if lengths is not None:
        m = jnp.arange(xw.shape[2])[None, :] < jnp.asarray(lengths)[:, None]
        mask = jnp.concatenate(
            [jnp.broadcast_to(m, (streams,) + m.shape),
             jnp.broadcast_to(jnp.flip(m, axis=1), (streams,) + m.shape)])
    out, _ = _grouped_lstm_scan(xw, w_h, mask=mask)

    return jnp.concatenate([out[:streams], jnp.flip(out[streams:], axis=2)])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('masked', [False, True])
def test_grouped_plain_equals_per_stream_runs(dtype, masked):
    """Grouped B (forward groups, reversed groups, shared lengths) and E
    and F, each group bit for bit its stream's plain run."""

    xw, w_h, dout = (torch.from_numpy(a).to(dtype) for a in _data(1))
    lengths = torch.tensor(LENGTHS) if masked else None
    split = STREAMS

    out = lstm_scan_grouped(xw, w_h, split, lengths)
    for g in range(2 * STREAMS):
        assert torch.equal(out[g], lstm_scan_plain(xw[g], w_h[g], g >= split,
                                                   lengths)), g
    if masked:
        return

    res = lstm_scan_residuals_grouped(xw, w_h, split)
    w_h_t = w_h.transpose(1, 2).contiguous()
    da = lstm_bptt_grouped(res[1], res[2], dout, w_h_t, split)
    for g in range(2 * STREAMS):
        alone = lstm_scan_residuals_plain(xw[g], w_h[g], g >= split)
        for got, want in zip(res, alone):
            assert torch.equal(got[g], want), g
        assert torch.equal(da[g], lstm_bptt_plain(alone[1], alone[2], dout[g],
                                                  w_h_t[g], g >= split)), g


@pytest.mark.parametrize('masked', [False, True])
def test_grouped_plain_matches_jax_grouped_scan(masked):
    xw, w_h, _ = _data(2)
    lengths = LENGTHS if masked else None

    got = lstm_scan_grouped(torch.from_numpy(xw), torch.from_numpy(w_h),
                            STREAMS, None if lengths is None else
                            torch.tensor(lengths))
    want = np.asarray(_jax_scan(jnp.asarray(xw), jnp.asarray(w_h), STREAMS,
                                lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_grouped_gradients_match_jax_grad():
    """``LSTMScanGroupedGrad`` (grouped E and F through their plain
    versions, dW_h one batched matmul) against ``jax.grad`` of the grouped
    scan, float32; and against the per-stream Function."""

    xw, w_h, dout = _data(3)

    def loss(xw, w_h):
        return jnp.sum(_jax_scan(xw, w_h, STREAMS) * dout)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xw), jnp.asarray(w_h))

    xw_t = torch.from_numpy(xw).requires_grad_()
    w_t = torch.from_numpy(w_h).requires_grad_()
    out = lstm_scan_grouped_grad(xw_t, w_t, STREAMS)
    out.backward(torch.from_numpy(dout))
    for got, ref in zip((xw_t.grad, w_t.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())

    grads = xw_t.grad.clone(), w_t.grad.clone()
    xw_t.grad = w_t.grad = None
    torch.stack([lstm_scan_grad(xw_t[g], w_t[g], g >= STREAMS)
                 for g in range(2 * STREAMS)]).backward(torch.from_numpy(dout))
    assert torch.equal(grads[0], xw_t.grad)
    torch.testing.assert_close(grads[1], w_t.grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize('streams', [2, 3])
@pytest.mark.parametrize('masked', [False, True])
def test_grouped_bilstm_matches_jax(streams, masked):
    """The layer through ``from_flax`` of JAX's variables (the stacked
    leaves keep JAX's layout), float32 1e-5; parameter names equal."""

    rng = np.random.RandomState(streams)
    x = rng.rand(streams, BATCH, FRAMES, 24).astype(np.float32)
    lengths = LENGTHS if masked else None

    jax_layer = JaxGroupedBiLSTM(features=HIDDEN, streams=streams)
    variables = jax_layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax_layer.apply(variables, jnp.asarray(x),
                           lengths=None if lengths is None else
                           jnp.asarray(lengths))

    layer = GroupedBiLSTM(24, HIDDEN, streams=streams)
    state = from_flax(variables)
    assert sorted(state) == sorted(layer.state_dict())
    layer.load_state_dict(state)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), None if lengths is None else
                    torch.tensor(lengths))
    assert got.shape == (streams, BATCH, FRAMES, 2 * HIDDEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_grouped_bilstm_refusals():
    layer = GroupedBiLSTM(8, HIDDEN, streams=2)
    with pytest.raises(ValueError, match='expected 2 streams'):
        layer(torch.zeros(3, 1, 4, 8))
    # Masked training runs (grouped E and F with lengths); lengths that do
    # not fit the batch are refused
    x = torch.zeros(2, 1, 4, 8, requires_grad=True)
    layer(x, torch.tensor([3])).sum().backward()
    assert not x.grad[:, :, 3:].any()
    with pytest.raises(ValueError, match='lengths must be'):
        layer(x, torch.tensor([3, 2]))
    with pytest.raises(ValueError, match='reverse_from'):
        lstm_scan_grouped(torch.zeros(2, 1, 4, 64), torch.zeros(2, 16, 64), 3)
    with pytest.raises(ValueError, match='w_h must be'):
        lstm_scan_grouped(torch.zeros(2, 1, 4, 64), torch.zeros(16, 64), 1)


@pytest.mark.parametrize('kernel,groups,batch,rows,clusters,waves', [
    # O&F2's four directions at the training batch, E and F
    ('scan', 4, 8, 2, 16, 1), ('bptt', 4, 8, 2, 16, 1),
    # the velocity model's six (3 rows would make 18 clusters)
    ('scan', 6, 8, 4, 12, 1), ('bptt', 6, 8, 4, 12, 1),
    # serving, B: no rows put 4 x 128 in one wave
    ('scan', 4, 128, 16, 32, 2)])
def test_grouped_cluster_plan(kernel, groups, batch, rows, clusters, waves):
    dtype = torch.bfloat16 if batch == 128 else torch.float32
    plan = cluster_plan(batch, 256, dtype, 16, kernel, groups=groups)

    assert (plan['rows'], plan['clusters'], plan['waves']) == (
        rows, clusters, waves)
    assert plan['groups'] == groups and plan['ctas'] == 8 * clusters


@pytest.mark.parametrize('kernel', ['scan', 'bptt'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_one_group_is_the_ungrouped_plan(kernel, dtype):
    """``groups=1`` gives the rule the ungrouped launches always took: the
    fewest rows for one wave, ``ceil(batch / active)``, within what fits."""

    for hidden in (16, 256, 512):
        for batch in (0, 1, 7, 8, 100, 128, 130, 300):
            for active in (1, 14, 16):
                plan = cluster_plan(batch, hidden, dtype, active, kernel)
                rows = min(plan['max_rows'], max(1, -(-batch // active)))
                assert plan['rows'] == rows
                assert plan['clusters'] == -(-batch // rows)
                assert plan['groups'] == 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_masked_and_carried_f_hold_a_dh_buffer(dtype):
    """Kernel F's masked or carried launch holds one more R x H/8 float32
    buffer (the dh a masked step passes on), after the dc carry; the plan
    keeps the unmasked launch's residency and takes at most its rows."""

    for hidden in (16, 48, 256, 512, 1024):
        resident = lstm_kernel.bptt_resident(hidden, dtype)
        for rows in (1, 4, 8):
            plain = lstm_kernel.bptt_geometry(hidden, dtype, rows, resident)
            held = lstm_kernel.bptt_geometry(hidden, dtype, rows, resident,
                                             hold=True)
            assert held['parts']['dh'] == plain['parts']['dc']
            assert held['bytes'] == plain['bytes'] + plain['parts']['dc']
        for batch in (8, 128):
            plan = cluster_plan(batch, hidden, dtype, 16, 'bptt')
            masked = cluster_plan(batch, hidden, dtype, 16, 'bptt', hold=True)
            assert masked['resident'] == plan['resident']
            assert masked['max_rows'] <= plan['max_rows']
            assert masked['smem_bytes'] <= lstm_kernel.MAX_SHARED_BYTES


@pytest.mark.parametrize('source,signatures', [
    ('lstm_scan', lstm_kernel._SCAN_SIGNATURES),
    ('lstm_bptt', lstm_kernel._BPTT_SIGNATURES)])
def test_ctypes_signatures_match_the_sources(source, signatures):
    """Every exported C function the wrappers call takes as many arguments
    as its ctypes signature names (ctypes would otherwise refuse the call,
    on the card only)."""

    text = (Path(lstm_kernel.__file__).parent.parent / 'csrc' /
            f'{source}.cu').read_text()
    declared = {name: len([a for a in args.split(',') if a.strip()])
                for name, args in re.findall(
                    r'extern "C" int (\w+)\(([^)]*)\)', text)}
    assert set(signatures) <= set(declared)
    for name, argtypes in signatures.items():
        assert len(argtypes) == declared[name], name
