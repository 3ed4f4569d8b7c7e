"""The differentiable LSTM recurrence: kernel E's and F's plain versions and
``lstm_scan_grad`` against the JAX package's Pallas kernels (interpret mode
on the CPU) and custom VJP, and the routing between kernels B and E/F.

Inputs: B = 8, T = 37 (not a multiple of the Pallas kernels' block of 16,
which they pad and the port does not), H = 32, both directions.

Tolerances:
- float32: the JAX test's ``atol=2e-5, rtol=1e-4`` (sums in another order);
- bf16: every compared value rounds to bf16 or depends on a bf16 gate, and
  the recurrent product sums in another order than the interpreted Pallas
  dot, so an occasional gate rounds the other way (one ulp, 2^-8
  relative) and the carries keep the difference for a few steps: max 2e-2
  of the largest value, mean 1e-3 of it.

The card's bf16 check of kernel F against its plain version (same
residuals on both sides) is tighter: max 5e-4 of the largest value, mean
1e-4 of the mean magnitude. ``test_card_bptt_bf16_tolerance_catches_
numerics_faults`` shows that a sum in another order stays within it and
that the two likely bf16 faults of the carry product exceed its mean.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu.ops.pallas_lstm import _lstm_fwd_res, lstm_scan_pallas_grad

from amt_tools_tpu_torch.ops import lstm as port_lstm
from amt_tools_tpu_torch.ops.lstm import FastBiLSTM
from amt_tools_tpu_torch.ops.lstm_kernel import (lstm_bptt_plain,
                                                 lstm_scan_grad,
                                                 lstm_scan_plain,
                                                 lstm_scan_residuals)

torch.set_num_threads(1)

BATCH, FRAMES, HIDDEN = 8, 37, 32
BF16_MAX, BF16_MEAN = 2e-2, 1e-3

DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed):
    rng = np.random.RandomState(seed)
    xw = (rng.randn(BATCH, FRAMES, 4 * HIDDEN) * 0.5).astype(np.float32)
    w_h = (rng.randn(HIDDEN, 4 * HIDDEN) / np.sqrt(HIDDEN)).astype(np.float32)
    dout = rng.randn(BATCH, FRAMES, HIDDEN).astype(np.float32)
    return xw, w_h, dout


def _assert_close(got, ref, dtype):
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
        return
    diff = np.abs(got - ref)
    scale = np.abs(ref).max()
    assert diff.max() <= BF16_MAX * scale, (diff.max(), scale)
    assert diff.mean() <= BF16_MEAN * scale, (diff.mean(), scale)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('reverse', [False, True])
def test_residuals_match_pallas(dtype, reverse):
    """Kernel E's plain version vs ``_lstm_fwd_res`` on out, gates and c."""

    torch_dtype, jax_dtype = DTYPES[dtype]
    xw, w_h, _ = _inputs(0)

    ref = _lstm_fwd_res(jnp.asarray(xw).astype(jax_dtype),
                        jnp.asarray(w_h).astype(jax_dtype), reverse=reverse,
                        interpret=True)
    got = lstm_scan_residuals(torch.from_numpy(xw).to(torch_dtype),
                              torch.from_numpy(w_h).to(torch_dtype), reverse)

    assert got[0].dtype == torch_dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        _assert_close(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                      dtype)

    # The residual forward's h is the serving recurrence's
    serving = lstm_scan_plain(torch.from_numpy(xw).to(torch_dtype),
                              torch.from_numpy(w_h).to(torch_dtype), reverse)
    assert torch.equal(got[0], serving)


def _jax_grads(xw, w_h, dout, reverse, jax_dtype):
    def loss(x, w):
        out = lstm_scan_pallas_grad(x, w, reverse, 16, True)
        return jnp.sum(out.astype(jnp.float32) * dout)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(xw).astype(jax_dtype),
                                         jnp.asarray(w_h))


def _port_grads(fn, xw, w_h, dout, reverse, torch_dtype):
    x = torch.from_numpy(xw).to(torch_dtype).requires_grad_()
    w = torch.from_numpy(w_h).clone().requires_grad_()
    (fn(x, w, reverse).float() * torch.from_numpy(dout)).sum().backward()
    return x.grad, w.grad


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('reverse', [False, True])
def test_grads_match_pallas_vjp(dtype, reverse):
    """``lstm_scan_grad`` (E and F through their plain versions) vs
    ``jax.grad`` through ``lstm_scan_pallas_grad`` in interpret mode."""

    torch_dtype, jax_dtype = DTYPES[dtype]
    xw, w_h, dout = _inputs(1)

    ref_x, ref_w = _jax_grads(xw, w_h, dout, reverse, jax_dtype)
    got_x, got_w = _port_grads(lstm_scan_grad, xw, w_h, dout, reverse,
                               torch_dtype)

    # d(xw) in xw's dtype, dW_h in the float32 parameter's
    assert got_x.dtype == torch_dtype and got_w.dtype == torch.float32
    assert ref_x.dtype == jax_dtype and ref_w.dtype == jnp.float32
    _assert_close(got_x.float().numpy(), np.asarray(ref_x.astype(jnp.float32)),
                  dtype)
    _assert_close(got_w.numpy(), np.asarray(ref_w), dtype)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('reverse', [False, True])
def test_bptt_plain_matches_pallas_vjp(dtype, reverse):
    """Kernel F's plain version alone, on residuals from kernel E's: its da
    is JAX's d(xw) before the cast to xw's dtype."""

    torch_dtype, jax_dtype = DTYPES[dtype]
    xw, w_h, dout = _inputs(2)

    _, gates, c_seq = lstm_scan_residuals(
        torch.from_numpy(xw).to(torch_dtype),
        torch.from_numpy(w_h).to(torch_dtype), reverse)
    da = lstm_bptt_plain(gates, c_seq, torch.from_numpy(dout).to(torch_dtype),
                         torch.from_numpy(w_h.T.copy()).to(torch_dtype),
                         reverse)
    assert da.dtype == torch.float32

    # JAX's kernel gets the cotangent in out's dtype, as F's plain version
    ref_x, _ = _jax_grads(xw, w_h, dout, reverse, jax_dtype)
    _assert_close(da.to(torch_dtype).float().numpy(),
                  np.asarray(ref_x.astype(jnp.float32)), dtype)


@pytest.mark.parametrize('reverse', [False, True])
def test_float32_function_matches_autograd_through_plain(reverse):
    """In float32, autograd through the plain forward is an independent
    check of the whole Function."""

    xw, w_h, dout = _inputs(3)
    got = _port_grads(lstm_scan_grad, xw, w_h, dout, reverse, torch.float32)
    ref = _port_grads(lstm_scan_plain, xw, w_h, dout, reverse, torch.float32)

    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-4)


def test_dw_h_stays_float32_for_bf16_projections():
    """W_h goes into the Function uncast: with bf16 xw its gradient is not
    rounded to bf16 on its way to the float32 parameter."""

    xw, w_h, dout = _inputs(4)
    _, got_w = _port_grads(lstm_scan_grad, xw, w_h, dout, False,
                           torch.bfloat16)
    assert got_w.dtype == torch.float32
    # Some entries carry more than bf16's 8 significant bits
    assert not torch.equal(got_w, got_w.to(torch.bfloat16).float())


def _bptt_variant(gates, c_seq, dout, w_h_t, sum64=False, da_unrounded=False,
                  w_h_t_f32=None):
    """``lstm_bptt_plain`` (forward direction) with planted changes:
    ``sum64`` sums the carry product in float64 (a sound other order);
    ``da_unrounded`` forms it from da before its bf16 rounding, and
    ``w_h_t_f32`` from a float32 W_h^T (two bf16 faults)."""

    batch, frames, four_h = gates.shape
    hidden = four_h // 4
    w = (w_h_t.float() if w_h_t_f32 is None else w_h_t_f32)
    w = w.double() if sum64 else w
    dh_carry = torch.zeros((batch, hidden))
    dc_carry = torch.zeros_like(dh_carry)
    da = torch.empty((batch, frames, four_h))

    for t in range(frames - 1, -1, -1):
        c_prev = c_seq[:, t - 1] if t else torch.zeros_like(dh_carry)
        i_g, f_g, g_g, o_g = gates[:, t].split(hidden, dim=-1)
        tanh_c = torch.tanh(c_seq[:, t])
        dh = dout[:, t].float() + dh_carry
        da_o = dh * tanh_c * o_g * (1.0 - o_g)
        dc = dc_carry + dh * o_g * (1.0 - tanh_c * tanh_c)
        da_i = dc * g_g * i_g * (1.0 - i_g)
        da_g = dc * i_g * (1.0 - g_g * g_g)
        da_f = dc * c_prev * f_g * (1.0 - f_g)
        dc_carry = dc * f_g

        step = torch.cat([da_i, da_f, da_g, da_o], dim=-1)
        da[:, t] = step
        carried = step if da_unrounded else step.to(w_h_t.dtype).float()
        dh_carry = (carried.to(w.dtype) @ w).float()

    return da


@pytest.mark.parametrize('recipe', ['projected', 'gaussian'])
def test_card_bptt_bf16_tolerance_catches_numerics_faults(recipe):
    """Kernel F's bf16 tolerance on the card (``tests/test_torch_cuda.py``,
    ``chip_smoke.py``), on da and on dW_h = h_prev^T da: max 5e-4 of the
    largest value and mean 1e-4 of the mean magnitude. A carry product
    summed in another order stays within both; forming it from unrounded
    da or a float32 W_h^T exceeds the mean (the max alone cannot tell)."""

    max_rel, mean_rel = 5e-4, 1e-4
    batch, frames, hidden = 8, 625, 256
    g = torch.Generator().manual_seed(6)
    if recipe == 'projected':  # chip_smoke.py's inputs
        x = torch.rand(batch, frames, 768, generator=g)
        w_x = torch.randn(768, 4 * hidden, generator=g) / 768 ** 0.5
        xw = x.bfloat16() @ w_x.bfloat16()
    else:  # tests/test_torch_cuda.py's inputs
        xw = (torch.randn(batch, frames, 4 * hidden, generator=g) * 0.5
              ).bfloat16()
    w_h = torch.nn.init.orthogonal_(torch.empty(hidden, 4 * hidden),
                                    generator=g)
    dout = torch.randn(batch, frames, hidden, generator=g).bfloat16()

    out, gates, c_seq = lstm_scan_residuals(xw, w_h.bfloat16())
    w_h_t = w_h.t().bfloat16().contiguous()
    ref = lstm_bptt_plain(gates, c_seq, dout, w_h_t)
    assert torch.equal(_bptt_variant(gates, c_seq, dout, w_h_t), ref)

    h_prev = torch.cat([torch.zeros(batch, 1, hidden), out[:, :-1].float()],
                       dim=1).reshape(-1, hidden)

    def errors(**change):
        da = _bptt_variant(gates, c_seq, dout, w_h_t, **change)
        worst = (0.0, 0.0)
        for a, b in ((da, ref), (h_prev.t() @ da.reshape(-1, 4 * hidden),
                                 h_prev.t() @ ref.reshape(-1, 4 * hidden))):
            diff = (a - b).abs()
            worst = (max(worst[0], (diff.max() / b.abs().max()).item()),
                     max(worst[1], (diff.mean() / b.abs().mean()).item()))
        return worst

    worst, mean = errors(sum64=True)
    assert worst <= max_rel and mean <= mean_rel, (worst, mean)
    for fault in ({'da_unrounded': True},
                  {'w_h_t_f32': w_h.t().contiguous()}):
        _, mean = errors(**fault)
        assert mean > mean_rel, (fault, mean)


def _spy(monkeypatch):
    """Count the layers' calls of kernel B's and the Function's grouped
    wrappers (one sequence is one group)."""

    calls = {'lstm_scan_grouped': 0, 'lstm_scan_grouped_grad': 0}
    for name in calls:
        original = getattr(port_lstm, name)

        def wrapper(*args, _original=original, _name=name, **kwargs):
            calls[_name] += 1
            return _original(*args, **kwargs)

        monkeypatch.setattr(port_lstm, name, wrapper)

    return calls


def test_routing_grad_on_takes_e_and_f(monkeypatch):
    calls = _spy(monkeypatch)
    layer = FastBiLSTM(12, HIDDEN, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 9, 12)

    layer(x).sum().backward()

    # Both directions in one grouped call
    assert calls == {'lstm_scan_grouped': 0, 'lstm_scan_grouped_grad': 1}
    assert layer.recurrent_kernel_fwd.grad is not None
    assert layer.recurrent_kernel_bwd.grad is not None


def test_routing_grad_off_takes_b(monkeypatch):
    calls = _spy(monkeypatch)
    layer = FastBiLSTM(12, HIDDEN, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 9, 12)

    with torch.no_grad():
        out = layer(x)
    with torch.inference_mode():
        layer(x)

    assert calls == {'lstm_scan_grouped': 2, 'lstm_scan_grouped_grad': 0}

    # The two routes give the same outputs
    assert torch.equal(layer(x).detach(), out)
