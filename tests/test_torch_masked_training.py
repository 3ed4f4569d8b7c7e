"""Masked and carried training against the JAX package on the CPU: the
layers with per-row lengths and a carry under autograd (kernels E and F
through their plain versions here) against ``jax.grad`` through the Flax
layers' XLA scan, bf16 against the Pallas VJP on rows cut to their length,
chunks that thread the carry against one call, a masked SGD step of O&F2
(per-head and ``fused_lms``) and a carried step of the online language
model.

Inputs are seeded numpy arrays at narrow widths (H 16-32, T <= 40).

Tolerances:
- float32 gradients: within 1e-5 of the largest value of the same tensor
  (the masked bound of ``tests/test_torch_lstm_lengths.py``; float32 sums
  in another order through tens of steps);
- bf16 against the per-row Pallas VJP (interpret mode): max 2e-2 and mean
  1e-3 of the largest value, as ``tests/test_torch_lstm_grad.py`` (an
  occasional bf16 gate rounds the other way);
- chunks that thread the carry against one call: d(xw) within 1e-6 of its
  largest value, dW_h and the carry's gradients within 1e-5;
- lengths = T against the unmasked Function: bit for bit;
- one SGD step of a model against Flax's: losses ``rtol=1e-5``, gradients
  within 1e-4 of their module's largest, parameters after the step
  ``atol=1e-5, rtol=1e-4`` and batch statistics ``atol=1e-6``, as
  ``tests/test_torch_train_model.py`` and ``tests/test_torch_train.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models.onsetsframes import (
    OnlineLanguageModel as JaxOnlineLanguageModel)
from amt_tools_tpu.ops.lstm import FastBiLSTM as JaxFastBiLSTM
from amt_tools_tpu.ops.lstm import FastLSTM as JaxFastLSTM
from amt_tools_tpu.ops.lstm import GroupedBiLSTM as JaxGroupedBiLSTM
from amt_tools_tpu.ops.lstm import _lstm_scan, lengths_to_mask
from amt_tools_tpu.ops.pallas_lstm import lstm_scan_pallas_grad
from amt_tools_tpu.train import init_state
from amt_tools_tpu.train import make_train_step as jax_make_train_step

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import (OnsetsFrames2, OnsetsFramesOnline,
                                        run_on_batch)
from amt_tools_tpu_torch.models.onsetsframes import OnlineLanguageModel
from amt_tools_tpu_torch.ops import lstm_kernel
from amt_tools_tpu_torch.ops.lstm import (FastBiLSTM, FastLSTM,
                                          GroupedBiLSTM, padded_recurrence)
from amt_tools_tpu_torch.ops.lstm_kernel import lstm_scan_grad
from amt_tools_tpu_torch.train import make_train_step
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

BATCH, FRAMES, DIM_IN, HIDDEN = 5, 23, 12, 16
# Every kind of row: empty, one frame, whole, and between
LENGTHS = np.array([0, 1, FRAMES, 9, 17])
TOL = 1e-5
BF16_MAX, BF16_MEAN = 2e-2, 1e-3


def _assert_rel(got, want, tol=TOL, name=''):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        name, np.abs(got - want).max(), scale)


def _grad_state(grads):
    """A Flax gradient tree as the port's ``state_dict`` names it."""

    return {k: v.numpy() for k, v in from_flax({'params': grads}).items()}


def _compare_params(module, grads, tol=TOL):
    ref = _grad_state(grads)
    names = dict(module.named_parameters())
    assert sorted(names) == sorted(ref)
    for name, param in names.items():
        _assert_rel(param.grad.numpy(), ref[name], tol, name)


def _inputs(seed, shape=(BATCH, FRAMES, DIM_IN), out_width=HIDDEN):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    dout = rng.randn(*shape[:-1], out_width).astype(np.float32)
    return x, dout


@pytest.mark.parametrize('bidirectional', [False, True])
def test_masked_layer_matches_jax_grad(bidirectional):
    """``FastLSTM(lengths)`` and ``FastBiLSTM(lengths)`` under autograd
    (masked E and F) against ``jax.grad`` through the Flax layer's masked
    scan: the input's and every parameter's gradient."""

    width = 2 * HIDDEN if bidirectional else HIDDEN
    x, dout = _inputs(0, out_width=width)
    flax_layer = (JaxFastBiLSTM if bidirectional else JaxFastLSTM)(
        features=HIDDEN)
    variables = flax_layer.init(jax.random.PRNGKey(1), jnp.asarray(x))

    def loss(params, inputs):
        out = flax_layer.apply({'params': params}, inputs,
                               lengths=jnp.asarray(LENGTHS))
        return jnp.sum(out * dout)

    ref_params, ref_x = jax.grad(loss, argnums=(0, 1))(variables['params'],
                                                       jnp.asarray(x))

    layer = (FastBiLSTM if bidirectional else FastLSTM)(DIM_IN, HIDDEN)
    layer.load_state_dict(from_flax(variables))
    inputs = torch.from_numpy(x).requires_grad_()
    out = layer(inputs, lengths=torch.from_numpy(LENGTHS))
    (out * torch.from_numpy(dout)).sum().backward()

    mask = np.arange(FRAMES)[None] < LENGTHS[:, None]
    assert torch.count_nonzero(out.detach()[torch.from_numpy(~mask)]) == 0
    _assert_rel(inputs.grad.numpy(), ref_x, name='x')
    _compare_params(layer, ref_params)


@pytest.mark.parametrize('masked', [False, True])
def test_carried_layer_matches_jax_grad(masked):
    """``FastLSTM(initial_carry, return_carry)`` under autograd (carried E
    and F), with a loss that reads the outputs and the returned carry:
    the gradients of the input, the parameters, c0 and h0 against
    ``jax.grad`` through the Flax layer."""

    x, dout = _inputs(1)
    rng = np.random.RandomState(2)
    c0, h0, dc, dh = (rng.randn(BATCH, HIDDEN).astype(np.float32)
                      for _ in range(4))
    lengths = LENGTHS if masked else None
    flax_layer = JaxFastLSTM(features=HIDDEN)
    variables = flax_layer.init(jax.random.PRNGKey(3), jnp.asarray(x))

    def loss(params, inputs, c, h):
        (c_last, h_last), out = flax_layer.apply(
            {'params': params}, inputs, initial_carry=(c, h),
            return_carry=True,
            lengths=None if lengths is None else jnp.asarray(lengths))
        return (jnp.sum(out * dout) + jnp.sum(c_last * dc) +
                jnp.sum(h_last * dh))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        variables['params'], jnp.asarray(x), jnp.asarray(c0), jnp.asarray(h0))

    layer = FastLSTM(DIM_IN, HIDDEN)
    layer.load_state_dict(from_flax(variables))
    inputs = torch.from_numpy(x).requires_grad_()
    carry = tuple(torch.from_numpy(v).requires_grad_() for v in (c0, h0))
    (c_last, h_last), out = layer(
        inputs, lengths=None if lengths is None else torch.from_numpy(lengths),
        initial_carry=carry, return_carry=True)
    ((out * torch.from_numpy(dout)).sum() +
     (c_last * torch.from_numpy(dc)).sum() +
     (h_last * torch.from_numpy(dh)).sum()).backward()

    _compare_params(layer, ref[0])
    for got, want, name in ((inputs.grad, ref[1], 'x'),
                            (carry[0].grad, ref[2], 'c0'),
                            (carry[1].grad, ref[3], 'h0')):
        _assert_rel(got.numpy(), want, name=name)
    if masked:  # a row of length 0 passes the final carry's gradient
        np.testing.assert_array_equal(carry[0].grad[0].numpy(), dc[0])
        np.testing.assert_array_equal(carry[1].grad[0].numpy(), dh[0])


@pytest.mark.parametrize('streams', [2, 3])
def test_masked_grouped_bilstm_matches_jax_grad(streams):
    """``GroupedBiLSTM(lengths)`` under autograd (grouped masked E and F)
    against ``jax.grad`` through JAX's grouped masked scan."""

    x, dout = _inputs(4, shape=(streams, BATCH, FRAMES, DIM_IN),
                      out_width=2 * HIDDEN)
    flax_layer = JaxGroupedBiLSTM(features=HIDDEN, streams=streams)
    variables = flax_layer.init(jax.random.PRNGKey(5), jnp.asarray(x))

    def loss(params, inputs):
        out = flax_layer.apply({'params': params}, inputs,
                               lengths=jnp.asarray(LENGTHS))
        return jnp.sum(out * dout)

    ref_params, ref_x = jax.grad(loss, argnums=(0, 1))(variables['params'],
                                                       jnp.asarray(x))

    layer = GroupedBiLSTM(DIM_IN, HIDDEN, streams=streams)
    layer.load_state_dict(from_flax(variables))
    inputs = torch.from_numpy(x).requires_grad_()
    out = layer(inputs, torch.from_numpy(LENGTHS))
    (out * torch.from_numpy(dout)).sum().backward()

    _assert_rel(inputs.grad.numpy(), ref_x, name='x')
    _compare_params(layer, ref_params)


@pytest.mark.parametrize('reverse', [False, True])
def test_padded_width_masked_and_carried_matches_jax_grad(reverse):
    """H = 24, a width the kernels do not take, through
    ``padded_recurrence`` at 32 units with lengths and a carry: the
    zero-padded carry's gradient sliced back to H; against ``jax.grad``
    through the masked XLA scan."""

    hidden, padded = 24, 32
    rng = np.random.RandomState(6)
    xw = (rng.randn(BATCH, FRAMES, 4 * hidden) * 0.5).astype(np.float32)
    w_h = (rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)).astype(np.float32)
    c0, h0, dc, dh = ((rng.randn(BATCH, hidden) * 0.5).astype(np.float32)
                      for _ in range(4))
    dout = rng.randn(BATCH, FRAMES, hidden).astype(np.float32)

    def loss(x, w, c, h):
        out, (h_last, c_last) = _lstm_scan(
            x, h, c, w, reverse=reverse,
            mask=lengths_to_mask(jnp.asarray(LENGTHS), FRAMES))
        return (jnp.sum(out * dout) + jnp.sum(c_last * dc) +
                jnp.sum(h_last * dh))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(xw, w_h, c0, h0)

    leaves = [torch.from_numpy(v).requires_grad_() for v in (xw, w_h, c0, h0)]
    out, (c_last, h_last) = padded_recurrence(
        leaves[0], leaves[1], reverse, padded, torch.from_numpy(LENGTHS),
        (leaves[2], leaves[3]))
    assert out.shape == (BATCH, FRAMES, hidden) and c_last.shape == (BATCH,
                                                                     hidden)
    ((out * torch.from_numpy(dout)).sum() +
     (c_last * torch.from_numpy(dc)).sum() +
     (h_last * torch.from_numpy(dh)).sum()).backward()

    for leaf, want, name in zip(leaves, ref, ('xw', 'w_h', 'c0', 'h0')):
        _assert_rel(leaf.grad.numpy(), want, name=name)


@pytest.mark.parametrize('reverse', [False, True])
def test_bf16_masked_grads_match_per_row_pallas_vjp(reverse):
    """bf16 masked E and F against the JAX package's Pallas VJP
    (``lstm_scan_pallas_grad``, interpret mode) on each row cut to its
    length: d(xw) on the valid frames (0 past them) and dW_h summed over
    the rows. Both keep a float32 carry."""

    rng = np.random.RandomState(7)
    xw = (rng.randn(BATCH, FRAMES, 4 * HIDDEN) * 0.5).astype(np.float32)
    w_h = (rng.randn(HIDDEN, 4 * HIDDEN) / np.sqrt(HIDDEN)).astype(np.float32)
    dout = rng.randn(BATCH, FRAMES, HIDDEN).astype(np.float32)
    xw16 = torch.from_numpy(xw).bfloat16()

    x = xw16.clone().requires_grad_()
    w = torch.from_numpy(w_h).requires_grad_()
    out = lstm_scan_grad(x, w, reverse, torch.from_numpy(LENGTHS))
    (out.float() * torch.from_numpy(dout)).sum().backward()

    def row_loss(x_row, w_row, d_row):
        out_row = lstm_scan_pallas_grad(x_row, w_row, reverse, 16, True)
        return jnp.sum(out_row.astype(jnp.float32) * d_row)

    grad = jax.grad(row_loss, argnums=(0, 1))
    ref_x = np.zeros_like(xw)
    ref_w = np.zeros_like(w_h)
    for row, length in enumerate(LENGTHS):
        if not length:
            continue
        prefix = jnp.asarray(xw16[row: row + 1, :length].float().numpy(),
                             jnp.bfloat16)
        gx, gw = grad(prefix, jnp.asarray(w_h),
                      jnp.asarray(dout[row: row + 1, :length]))
        ref_x[row, :length] = np.asarray(gx.astype(jnp.float32))[0]
        ref_w += np.asarray(gw)

    for got, want in ((x.grad.float().numpy(), ref_x), (w.grad.numpy(),
                                                          ref_w)):
        diff = np.abs(got - want)
        scale = np.abs(want).max()
        assert diff.max() <= BF16_MAX * scale, (diff.max(), scale)
        assert diff.mean() <= BF16_MEAN * scale, (diff.mean(), scale)
    mask = np.arange(FRAMES)[None] < LENGTHS[:, None]
    assert not x.grad.float().numpy()[~mask].any()


def _chunk_grads(xw, w_h, carry, dout, reverse, chunk, lengths=None):
    x = xw.clone().requires_grad_()
    w = w_h.clone().requires_grad_()
    state = tuple(v.clone().requires_grad_() for v in carry)
    leaves = (x, w) + state
    frames = xw.shape[1]
    starts = list(range(0, frames, chunk))
    pieces = {}
    for start in (reversed(starts) if reverse else starts):
        pieces[start], state = lstm_scan_grad(
            x[:, start:start + chunk], w, reverse, lengths,
            initial_carry=state, return_carry=True)
    out = torch.cat([pieces[s] for s in starts], dim=1)
    (out.float() * dout).sum().backward()
    return out.detach(), [leaf.grad for leaf in leaves]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_chunks_threading_the_carry_equal_one_call(dtype, reverse):
    """The carried Function over chunks of 7 frames, each from the carry
    the previous one returned, against one call of 35 frames from the same
    carry: outputs bit for bit, d(xw) within 1e-6 and dW_h, dc0 and dh0
    within 1e-5 of their largest value."""

    rng = np.random.RandomState(8)
    frames = 35
    xw = torch.from_numpy(
        (rng.randn(BATCH, frames, 4 * HIDDEN) * 0.5).astype(np.float32)).to(
            dtype)
    w_h = torch.from_numpy(
        (rng.randn(HIDDEN, 4 * HIDDEN) / np.sqrt(HIDDEN)).astype(np.float32))
    carry = tuple(torch.from_numpy((rng.randn(BATCH, HIDDEN) * 0.5).astype(
        np.float32)) for _ in range(2))
    dout = torch.from_numpy(rng.randn(BATCH, frames, HIDDEN).astype(
        np.float32))

    whole, want = _chunk_grads(xw, w_h, carry, dout, reverse, frames)
    chunked, got = _chunk_grads(xw, w_h, carry, dout, reverse, 7)

    assert torch.equal(chunked, whole)
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_rel(a.float().numpy(), b.float().numpy(),
                    1e-6 if i == 0 else 1e-5, name=str(i))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('carried', [False, True])
def test_full_lengths_equal_the_unmasked_function(dtype, reverse, carried):
    """Lengths = T give the unmasked Function's outputs and gradients bit
    for bit (plain versions), with and without a carry."""

    rng = np.random.RandomState(9)
    xw = torch.from_numpy(
        (rng.randn(BATCH, FRAMES, 4 * HIDDEN) * 0.5).astype(np.float32)).to(
            dtype)
    w_h = torch.from_numpy(
        (rng.randn(HIDDEN, 4 * HIDDEN) / np.sqrt(HIDDEN)).astype(np.float32))
    carry = tuple(torch.from_numpy((rng.randn(BATCH, HIDDEN) * 0.5).astype(
        np.float32)) for _ in range(2))
    dout = torch.from_numpy(rng.randn(BATCH, FRAMES, HIDDEN).astype(
        np.float32))
    full = torch.full((BATCH,), FRAMES)

    def run(lengths):
        x = xw.clone().requires_grad_()
        w = w_h.clone().requires_grad_()
        state = tuple(v.clone().requires_grad_() for v in carry)
        if carried:
            out, (c, h) = lstm_scan_grad(x, w, reverse, lengths,
                                         initial_carry=state,
                                         return_carry=True)
            loss = (out.float() * dout).sum() + c.sum() + h.sum()
        else:
            out = lstm_scan_grad(x, w, reverse, lengths)
            loss = (out.float() * dout).sum()
        loss.backward()
        grads = [x.grad, w.grad] + ([v.grad for v in state] if carried
                                    else [])
        return [out.detach()] + grads

    for got, want in zip(run(full), run(None)):
        assert torch.equal(got, want)


def _of2_batch(seed, frames=20, batch=3):
    rng = np.random.RandomState(seed)
    return {
        tools.KEY_FEATS: rng.rand(batch, 1, DIM_IN, frames).astype(
            np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(batch, 88, frames) < 0.1).astype(
            np.float32),
        tools.KEY_VALID_FRAMES: np.array([frames, 0, 11][:batch]),
    }


def _module_scale(grads, name):
    module = name.rsplit('.', 1)[0]
    return max(np.abs(v).max() for k, v in grads.items()
               if k.rsplit('.', 1)[0] == module)


@pytest.mark.parametrize('fused_lms', [False, True])
def test_masked_sgd_step_matches_flax(fused_lms):
    """One SGD step of a narrow O&F2 through ``make_train_step`` on a batch
    with valid frames (masked E and F six times, or grouped E and F once
    and E and F twice with ``fused_lms``) against JAX's train step: the
    loss, every gradient (of the same train-mode ``run_on_batch``), the
    parameters after the step and the BatchNorm running statistics, whose
    train-mode statistics include the zeroed padded frames on both sides."""

    data = _of2_batch(10)
    lr = 0.05
    kw = dict(model_complexity=2, dropout=False, fused_lms=fused_lms)
    jax_model = JaxOnsetsFrames2(dim_in=DIM_IN, profile=jtools.PianoProfile(),
                                 **kw)
    optimizer = optax.sgd(lr)
    jax_batch = jtools.dict_to_jax(data)
    state = init_state(jax_model, optimizer, jax_batch,
                       rng=jax.random.PRNGKey(0))
    variables = state.variables()

    def loss_fn(params):
        from amt_tools_tpu.models.common import run_on_batch as jax_run
        output, _ = jax_run(jax_model, {'params': params,
                                        'batch_stats': variables[
                                            'batch_stats']},
                            jax_batch, train=True,
                            rngs={'dropout': jax.random.PRNGKey(1)})
        return output[jtools.KEY_LOSS][jtools.KEY_LOSS_TOTAL]

    ref_grads = _grad_state(jax.jit(jax.grad(loss_fn))(variables['params']))

    model = OnsetsFrames2(dim_in=DIM_IN, profile=tools.PianoProfile(), **kw)
    model.load_state_dict(from_flax(variables))
    tensors = {k: torch.from_numpy(v) for k, v in data.items()}
    probe = OnsetsFrames2(dim_in=DIM_IN, profile=tools.PianoProfile(), **kw)
    probe.load_state_dict(from_flax(variables))
    run_on_batch(probe, tensors, train=True)[tools.KEY_LOSS][
        tools.KEY_LOSS_TOTAL].backward()
    names = dict(probe.named_parameters())
    assert sorted(names) == sorted(ref_grads)
    for name, param in names.items():
        diff = np.abs(param.grad.numpy() - ref_grads[name]).max()
        assert diff <= 1e-4 * _module_scale(ref_grads, name), name

    jax_step = jax_make_train_step(jax_model, optimizer, donate=False)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=lr))
    state, ref_loss = jax_step(state, jax_batch)
    loss = step(tensors)
    np.testing.assert_allclose(loss[tools.KEY_LOSS_TOTAL].item(),
                               float(ref_loss[jtools.KEY_LOSS_TOTAL]),
                               rtol=1e-5)

    ref = from_flax(state.variables())
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    for key in ref:
        tol = (dict(atol=1e-6, rtol=0) if 'running' in key else
               dict(atol=1e-5, rtol=1e-4))
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   err_msg=key, **tol)


def test_online_language_model_step_through_carried_chunks():
    """``OnlineLanguageModel.forward(feats, carry)`` under autograd over
    three chunks that thread the carry (carried E and F), the loss on the
    outputs and the last carry: the gradients of the parameters, the
    features and the first carry against ``jax.grad`` through Flax's
    ``OnlineLanguageModel`` over the same chunks."""

    rng = np.random.RandomState(11)
    feats = rng.randn(BATCH, 21, DIM_IN).astype(np.float32)
    dout = rng.randn(BATCH, 21, HIDDEN).astype(np.float32)
    c0, h0, dc = ((rng.randn(BATCH, HIDDEN) * 0.5).astype(np.float32)
                  for _ in range(3))
    bounds = ((0, 5), (5, 13), (13, 21))
    flax_lm = JaxOnlineLanguageModel(dim_in=DIM_IN, dim_out=HIDDEN)
    variables = flax_lm.init(jax.random.PRNGKey(12), jnp.asarray(feats),
                             carry=(jnp.asarray(c0), jnp.asarray(h0)))

    def loss(params, x, c, h):
        carry, total = (c, h), 0.0
        for start, stop in bounds:
            out, carry = flax_lm.apply({'params': params}, x[:, start:stop],
                                       carry=carry, train=True)
            total = total + jnp.sum(out * dout[:, start:stop])
        return total + jnp.sum(carry[0] * dc)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        variables['params'], jnp.asarray(feats), jnp.asarray(c0),
        jnp.asarray(h0))

    model = OnlineLanguageModel(DIM_IN, HIDDEN)
    model.load_state_dict(from_flax(variables))
    model.train()
    x = torch.from_numpy(feats).requires_grad_()
    first = tuple(torch.from_numpy(v).requires_grad_() for v in (c0, h0))
    carry, total = first, 0.0
    for start, stop in bounds:
        out, carry = model(x[:, start:stop], carry)
        total = total + (out * torch.from_numpy(dout[:, start:stop])).sum()
    (total + (carry[0] * torch.from_numpy(dc)).sum()).backward()

    _compare_params(model, ref[0])
    for got, want, name in ((x.grad, ref[1], 'feats'),
                            (first[0].grad, ref[2], 'c0'),
                            (first[1].grad, ref[3], 'h0')):
        _assert_rel(got.numpy(), want, name=name)


def test_online_model_trains_through_its_carries():
    """``OnsetsFramesOnline.forward(..., carries=)`` in train mode over two
    chunks: both language models take their carries through autograd (the
    carried plain versions here, nothing launched), every language-model
    parameter gets a gradient and so does the first chunk's carry."""

    model = OnsetsFramesOnline(dim_in=32, profile=tools.PianoProfile(),
                               model_complexity=2, dropout=False,
                               generator=torch.Generator().manual_seed(1))
    feats = model.pre_proc({tools.KEY_FEATS: torch.rand(2, 1, 32, 10)})[
        tools.KEY_FEATS]
    model.train()
    carries = {name: tuple(v.clone().requires_grad_() for v in pair)
               for name, pair in model.init_carries(2).items()}
    counts = (lstm_kernel.lstm_scan_residuals.carried_launches,
              lstm_kernel.lstm_bptt.carried_launches)
    state, total = carries, 0.0
    for start, stop in ((0, 4), (4, 10)):
        out, state = model(feats[:, start:stop], carries=state)
        total = total + out[tools.KEY_MULTIPITCH].square().sum()
    (total + state['onset'][1].sum()).backward()

    assert counts == (lstm_kernel.lstm_scan_residuals.carried_launches,
                      lstm_kernel.lstm_bptt.carried_launches)
    for name, param in model.named_parameters():
        if '_lm.' in name:
            assert torch.count_nonzero(param.grad), name
    for pair in carries.values():
        for value in pair:
            assert value.grad is not None
            assert torch.isfinite(value.grad).all()
            assert torch.count_nonzero(value.grad)
