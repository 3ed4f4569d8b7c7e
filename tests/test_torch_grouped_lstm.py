"""The grouped recurrence (the fused_lms layout) on the CPU: grouped kernels
B, E and F through their plain versions, ``LSTMScanGrad`` over groups,
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

from amt_tools_tpu_torch.ops import lstm as lstm_ops
from amt_tools_tpu_torch.ops import lstm_kernel
from amt_tools_tpu_torch.ops.lstm import FastBiLSTM, GroupedBiLSTM
from amt_tools_tpu_torch.ops.lstm_kernel import (
    cluster_plan, lstm_bptt, lstm_bptt_grouped, lstm_bptt_plain, lstm_scan,
    lstm_scan_grad, lstm_scan_grouped, lstm_scan_grouped_grad,
    lstm_scan_plain, lstm_scan_residuals, lstm_scan_residuals_grouped,
    lstm_scan_residuals_plain)
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


@pytest.mark.parametrize('kernel', ['B', 'E', 'F'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('reverse', [False, True])
def test_one_sequence_is_group_0_of_one_group(kernel, dtype, masked,
                                              reverse):
    """The wrappers of one (B, T, ·) sequence are the grouped ones at G =
    1: bit for bit group 0 of a one-group call (``reverse_from`` 0
    reversed, 1 forward). And ``lstm_scan_grad``'s dW_h at G = 1 is the one
    float32 ``mm`` of the (B·T, H) and (B·T, 4H) operands, bit for bit."""

    xw, w_h, dout = (torch.from_numpy(a[0]).to(dtype) for a in _data(4))
    lengths = torch.tensor(LENGTHS) if masked else None
    reverse_from = 0 if reverse else 1
    out, gates, c_seq = lstm_scan_residuals_plain(xw, w_h, reverse, lengths)
    w_h_t = w_h.t().contiguous()

    if kernel == 'B':
        pairs = [(lstm_scan(xw, w_h, reverse, lengths),
                  lstm_scan_grouped(xw[None], w_h[None], reverse_from,
                                    lengths))]
    elif kernel == 'E':
        pairs = zip(lstm_scan_residuals(xw, w_h, reverse, lengths),
                    lstm_scan_residuals_grouped(xw[None], w_h[None],
                                                reverse_from, lengths))
    else:
        pairs = [(lstm_bptt(gates, c_seq, dout, w_h_t, reverse, lengths),
                  lstm_bptt_grouped(gates[None], c_seq[None], dout[None],
                                    w_h_t[None], reverse_from, lengths))]
    for got, group in pairs:
        assert group.shape[0] == 1 and torch.equal(got, group[0])

    xw_t = xw.clone().requires_grad_()
    w_t = w_h.float().requires_grad_()
    lstm_scan_grad(xw_t, w_t, reverse, lengths).backward(dout)
    da = lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse, lengths)
    h_prev = lstm_kernel._shift_prev(out, reverse).float()
    hidden = h_prev.shape[-1]
    assert torch.equal(w_t.grad, h_prev.reshape(-1, hidden).t() @
                       da.reshape(-1, 4 * hidden))


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
    """``LSTMScanGrad`` over groups (grouped E and F through their plain
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
    ('scan', 4, 128, 16, 32, 2),
    # a FastBiLSTM's two directions: 16 clusters of one row at the training
    # batch, and one wave of 16-row clusters in serving
    ('scan', 2, 8, 1, 16, 1), ('bptt', 2, 8, 1, 16, 1),
    ('scan', 2, 128, 16, 16, 1)])
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
    on the card only), and each source exports one launch entry, named as
    the source, beside its occupancy and shared-memory queries."""

    text = (Path(lstm_kernel.__file__).parent.parent / 'csrc' /
            f'{source}.cu').read_text()
    declared = {name: len([a for a in args.split(',') if a.strip()])
                for name, args in re.findall(
                    r'extern "C" int (\w+)\(([^)]*)\)', text)}
    assert set(signatures) == set(declared) == {
        source, f'{source}_max_active_clusters', f'{source}_smem'}
    for name, argtypes in signatures.items():
        assert len(argtypes) == declared[name], name


# -- FastBiLSTM: both directions as one launch of two groups ----------------


def _per_direction(layer, x, lengths=None):
    """``FastBiLSTM``'s forward as two one-group runs, one a direction."""

    from amt_tools_tpu_torch.ops.layers import linear

    outs = [lstm_kernel.one_sequence(
        lstm_ops._recurrence, (linear(x, proj, layer.dtype), w_h), reverse,
        lengths, None)
        for proj, w_h, reverse in (
            (layer.input_proj_fwd, layer.recurrent_kernel_fwd, False),
            (layer.input_proj_bwd, layer.recurrent_kernel_bwd, True))]

    return torch.cat(outs, dim=-1)


def _bilstm(hidden, dtype, quant, seed=6):
    layer = FastBiLSTM(24, hidden, dtype=dtype, quant=quant,
                       generator=torch.Generator().manual_seed(seed))
    x = torch.from_numpy(np.random.RandomState(seed).rand(
        BATCH, FRAMES, 24).astype(np.float32) - 0.5)

    return layer, x


def test_bilstm_is_one_recurrence_of_two_groups(monkeypatch):
    """A ``FastBiLSTM`` forward makes one recurrence call: (2, B, T, 4H)
    projections, (2, H, 4H) kernels, the backward group reversed."""

    calls = []
    recurrence = lstm_ops._recurrence

    def spy(xw, w_h, reverse_from, *args, **kwargs):
        calls.append((tuple(xw.shape), tuple(w_h.shape), reverse_from))
        return recurrence(xw, w_h, reverse_from, *args, **kwargs)

    monkeypatch.setattr(lstm_ops, '_recurrence', spy)
    layer, x = _bilstm(HIDDEN, None, False)
    with torch.no_grad():
        layer(x, torch.tensor(LENGTHS))
    layer(x).sum().backward()

    call = ((2, BATCH, FRAMES, 4 * HIDDEN), (2, HIDDEN, 4 * HIDDEN), 1)
    assert calls == [call, call]


@pytest.mark.parametrize('dtype', [None, torch.bfloat16])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('hidden,quant', [(HIDDEN, False), (24, False),
                                          (HIDDEN, True)])
def test_bilstm_equals_its_directions_run_apart(dtype, masked, hidden,
                                                quant):
    """The grouped forward bit for bit the two one-group runs, float32 and
    bf16, masked or not, at H = 24 and with int8 projections."""

    layer, x = _bilstm(hidden, dtype, quant)
    lengths = torch.tensor(LENGTHS) if masked else None
    with torch.no_grad():
        got = layer(x, lengths)
        want = _per_direction(layer, x, lengths)

    assert got.shape == (BATCH, FRAMES, 2 * hidden)
    assert got.dtype == want.dtype == (dtype or torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize('masked', [False, True])
def test_padded_scan_of_two_groups_equals_its_directions(masked):
    """The card's zero-padded route (H = 24 run at 32 units) over the two
    groups bit for bit the per-direction ``padded_recurrence``, through
    the plain versions."""

    xw, w_h, _ = (torch.from_numpy(a) for a in _data(7, streams=1,
                                                      hidden=24))
    lengths = torch.tensor(LENGTHS) if masked else None
    got = lstm_ops._padded_scan(xw, w_h, 1, lengths, None, 32)

    assert got.shape == (2, BATCH, FRAMES, 24)
    for g in range(2):
        assert torch.equal(got[g], lstm_ops.padded_recurrence(
            xw[g], w_h[g], g == 1, 32, lengths)), g


@pytest.mark.parametrize('masked', [False, True])
def test_bilstm_gradients_equal_its_directions_run_apart(masked):
    """Under autograd (plain E and F over the two groups) the output, d(x)
    and the projections' gradients bit for bit the per-direction runs';
    dW_h, one batched matmul against one ``mm`` a direction, within 1e-5
    of its largest value."""

    layer, x = _bilstm(HIDDEN, None, False)
    lengths = torch.tensor(LENGTHS) if masked else None
    dout = torch.from_numpy(np.random.RandomState(8).randn(
        BATCH, FRAMES, 2 * HIDDEN).astype(np.float32))

    results = []
    for forward in (layer, lambda x, lengths: _per_direction(layer, x,
                                                             lengths)):
        layer.zero_grad()
        x_t = x.clone().requires_grad_()
        out = forward(x_t, lengths)
        out.backward(dout)
        results.append((out.detach(), x_t.grad, {
            n: p.grad.clone() for n, p in layer.named_parameters()}))

    (out, dx, grads), (out_ref, dx_ref, grads_ref) = results
    assert torch.equal(out, out_ref) and torch.equal(dx, dx_ref)
    for name, ref in grads_ref.items():
        if name.startswith('recurrent_kernel'):
            assert ((grads[name] - ref).abs().max().item() <=
                    1e-5 * ref.abs().max().item()), name
        else:
            assert torch.equal(grads[name], ref), name
