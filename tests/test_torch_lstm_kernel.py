"""The port's LSTM recurrence and BiLSTM layer vs the JAX package's Pallas
LSTM kernel (interpret mode) and XLA scan, on the CPU.

On CPU tensors the wrapper runs its plain version, a loop over T; the
Hopper kernel itself is held against that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances:
- float32: 1e-5 absolute (the same math, sums in another order);
- bf16: 1e-2 absolute on outputs in (-1, 1), a few bf16 ulps. Both follow
  the Pallas kernel's bf16 recipe, but the port rounds every bf16 op while
  XLA on the CPU may keep intermediates in float32, so single bf16
  roundings (2^-8 relative) differ and propagate through the recurrence.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu.ops.lstm import FastBiLSTM as JaxFastBiLSTM
from amt_tools_tpu.ops.lstm import _lstm_scan
from amt_tools_tpu.ops.pallas_lstm import lstm_scan_pallas

from amt_tools_tpu_torch.ops.lstm import FastBiLSTM
from amt_tools_tpu_torch.ops.lstm_kernel import lstm_scan, lstm_scan_plain
from amt_tools_tpu_torch.weights import from_flax

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)


def _data(batch=4, frames=37, hidden=32, seed=0):
    rng = np.random.RandomState(seed)
    xw = (rng.randn(batch, frames, 4 * hidden) * 0.5).astype(np.float32)
    w_h = (rng.randn(hidden, 4 * hidden) * 0.1).astype(np.float32)
    return xw, w_h


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('frames', [37, 70])
def test_f32_matches_pallas_and_scan(reverse, frames):
    xw, w_h = _data(frames=frames)
    batch, hidden = xw.shape[0], w_h.shape[0]

    got = lstm_scan(torch.from_numpy(xw), torch.from_numpy(w_h),
                    reverse=reverse).numpy()

    kernel = lstm_scan_pallas(jnp.asarray(xw), jnp.asarray(w_h),
                              reverse=reverse, block_t=16, interpret=True)
    zeros = jnp.zeros((batch, hidden))
    scan, _ = _lstm_scan(jnp.asarray(xw), zeros, zeros, jnp.asarray(w_h),
                         reverse=reverse)

    np.testing.assert_allclose(got, np.asarray(kernel), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(scan), atol=1e-5)


@pytest.mark.parametrize('reverse', [False, True])
def test_bf16_matches_pallas_interpret(reverse):
    xw, w_h = _data(frames=45, seed=1)
    xw_bf16 = torch.from_numpy(xw).bfloat16()
    w_bf16 = torch.from_numpy(w_h).bfloat16()

    got = lstm_scan(xw_bf16, w_bf16, reverse=reverse)
    assert got.dtype == torch.bfloat16

    # Identical bf16 operands on the JAX side
    kernel = lstm_scan_pallas(jnp.asarray(xw_bf16.float().numpy(), jnp.bfloat16),
                              jnp.asarray(w_bf16.float().numpy(), jnp.bfloat16),
                              reverse=reverse, block_t=16, interpret=True)

    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kernel.astype(jnp.float32)),
                               atol=1e-2)


def _bf16_variant(xw, w_h, carry_bf16=False, logistic=False, sum64=False):
    """The bf16 recurrence with one change to its numerics.

    ``carry_bf16`` rounds c and h to bf16 every step (the XLA scan),
    ``logistic`` takes ``torch.sigmoid`` for the tanh form, and ``sum64``
    sums the recurrent product in float64 (a sound kernel's other order).
    """

    batch, frames, four_h = xw.shape
    hidden = four_h // 4
    sigmoid = torch.sigmoid if logistic else (
        lambda x: 0.5 * torch.tanh(0.5 * x) + 0.5)
    acc = torch.float64 if sum64 else torch.float32

    h = torch.zeros(batch, hidden)
    c = torch.zeros_like(h)
    out = torch.empty(batch, frames, hidden, dtype=torch.bfloat16)
    for t in range(frames):
        gates = (xw[:, t].to(acc) +
                 h.bfloat16().to(acc) @ w_h.to(acc)).float().bfloat16()
        i_g, f_g, g_g, o_g = gates.split(hidden, dim=-1)
        i_g, f_g, o_g, g_g = (sigmoid(i_g), sigmoid(f_g), sigmoid(o_g),
                              torch.tanh(g_g))
        c = f_g.float() * c + (i_g * g_g).float()
        h = o_g.float() * torch.tanh(c)
        if carry_bf16:
            c, h = c.bfloat16().float(), h.bfloat16().float()
        out[:, t] = h.bfloat16()

    return out


@pytest.mark.parametrize('recipe', ['projected', 'gaussian'])
def test_card_bf16_tolerance_catches_numerics_faults(recipe):
    """The bf16 tolerance that holds the card's kernel to its plain version
    (``tests/test_torch_cuda.py``, ``chip_smoke.py``): max 1e-2 and mean
    8e-5 absolute. Every output rounds to bf16, so the max is one or two
    ulps (up to 2^-7) for sound and faulty numerics alike; the mean tells
    them apart. A sum in another order stays within both; a bf16 carry or
    the logistic sigmoid exceeds the mean."""

    max_atol, mean_atol = 1e-2, 8e-5
    g = torch.Generator().manual_seed(1)
    batch, frames, hidden = 6, 600, 256
    if recipe == 'projected':  # chip_smoke.py's inputs
        x = torch.rand(batch, frames, 768, generator=g)
        w_x = torch.randn(768, 4 * hidden, generator=g) / 768 ** 0.5
        xw = x.bfloat16() @ w_x.bfloat16()
    else:  # tests/test_torch_cuda.py's inputs
        xw = (torch.randn(batch, frames, 4 * hidden, generator=g) * 0.5
              ).bfloat16()
    w_h = torch.nn.init.orthogonal_(torch.empty(hidden, 4 * hidden),
                                    generator=g).bfloat16()

    ref = lstm_scan(xw, w_h).float()
    assert (_bf16_variant(xw, w_h).float() == ref).all()

    def errors(**fault):
        err = (_bf16_variant(xw, w_h, **fault).float() - ref).abs()
        return err.max().item(), err.mean().item()

    worst, mean = errors(sum64=True)
    assert worst <= max_atol and mean <= mean_atol
    for fault in ('carry_bf16', 'logistic'):
        _, mean = errors(**{fault: True})
        assert mean > mean_atol, (fault, mean)


def test_reverse_is_forward_of_flipped_input():
    xw, w_h = _data(frames=29, seed=2)
    xw_t, w_t = torch.from_numpy(xw), torch.from_numpy(w_h)

    backward = lstm_scan_plain(xw_t, w_t, reverse=True)
    flipped = lstm_scan_plain(torch.flip(xw_t, (1,)), w_t)

    np.testing.assert_array_equal(backward.numpy(),
                                  torch.flip(flipped, (1,)).numpy())


def test_bilstm_layer_matches_flax():
    rng = np.random.RandomState(3)
    inputs = rng.randn(2, 33, 24).astype(np.float32)

    module = JaxFastBiLSTM(features=16)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(inputs))
    ref = np.asarray(module.apply(variables, jnp.asarray(inputs)))

    layer = FastBiLSTM(24, 16)
    layer.load_state_dict(from_flax(variables))
    got = layer(torch.from_numpy(inputs)).detach().numpy()

    assert got.shape == ref.shape == (2, 33, 32)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    xw = torch.zeros(2, 5, 64)
    w_h = torch.zeros(16, 64)

    with pytest.raises(ValueError):
        lstm_scan(xw[0], w_h)
    with pytest.raises(ValueError):
        lstm_scan(xw, torch.zeros(16, 32))
    with pytest.raises(TypeError):
        lstm_scan(xw.double(), w_h.double())
    with pytest.raises(TypeError):
        lstm_scan(xw.bfloat16(), w_h)
    with pytest.raises(ValueError):
        lstm_scan(xw.transpose(0, 1), w_h)
