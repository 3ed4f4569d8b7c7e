"""Kernel B with per-row lengths, through its masked plain version, vs the
JAX package's masked LSTM, on the CPU.

The port's masked recurrence keeps the Pallas kernel's float32 carry: on
valid frames it equals the unmasked recurrence over the same rows cut to
their lengths, bit for bit, in float32 and bf16. JAX's masked path is its
XLA scan, which in bf16 rounds the carry to bf16 every step, so the port is
held to it in float32 (1e-5, sums in another order) and, in bf16, to the
Pallas kernel in interpret mode on each row cut to its length, within the
port's bf16 bound for B against Pallas (1e-2 absolute,
``tests/test_torch_lstm_kernel.py``). Padded outputs are exactly 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu.ops.lstm import FastBiLSTM as JaxFastBiLSTM
from amt_tools_tpu.ops.lstm import FastLSTM as JaxFastLSTM
from amt_tools_tpu.ops.pallas_lstm import lstm_scan_pallas

from amt_tools_tpu_torch.ops.lstm import (FastBiLSTM, FastLSTM,
                                          lengths_to_mask, padded_recurrence)
from amt_tools_tpu_torch.ops.lstm_kernel import lstm_scan, lstm_scan_plain
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 1e-2
# Lengths 0, 1, T and in between, in one batch
LENGTHS = [0, 1, 23, 37, 11]
FRAMES = 37


def _data(hidden=32, batch=len(LENGTHS), frames=FRAMES, seed=0):
    rng = np.random.RandomState(seed)
    xw = (rng.randn(batch, frames, 4 * hidden) * 0.5).astype(np.float32)
    w_h = (rng.randn(hidden, 4 * hidden) * 0.1).astype(np.float32)
    return xw, w_h


def _lengths():
    return torch.tensor(LENGTHS, dtype=torch.int32)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_valid_frames_equal_the_row_cut_to_its_length(dtype, reverse):
    """A row padded to T and masked is, on its valid frames, the unmasked
    recurrence over the row cut to its length, bit for bit; every padded
    output is exactly 0."""

    xw, w_h = _data(seed=1)
    xw_t = torch.from_numpy(xw).to(dtype)
    w_t = torch.from_numpy(w_h).to(dtype)

    for row, length in enumerate(LENGTHS):
        padded = lstm_scan(xw_t[row: row + 1], w_t, reverse=reverse,
                           lengths=torch.tensor([length]))
        alone = lstm_scan(xw_t[row: row + 1, :length].contiguous(), w_t,
                          reverse=reverse)
        assert torch.equal(padded[:, :length], alone)
        assert torch.count_nonzero(padded[:, length:]) == 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_rows_of_mixed_lengths_are_masked_independently(dtype, reverse):
    """Lengths 0, 1, T and between in one batch: each row as when masked
    alone (the CPU's matmul may sum another batch size in another order:
    1e-6 in float32, the bf16 bound in bf16; the kernel on the card is
    held to bit equality, tests/test_torch_cuda.py)."""

    xw, w_h = _data(seed=7)
    xw_t = torch.from_numpy(xw).to(dtype)
    w_t = torch.from_numpy(w_h).to(dtype)

    got = lstm_scan(xw_t, w_t, reverse=reverse, lengths=_lengths())

    for row, length in enumerate(LENGTHS):
        alone = lstm_scan(xw_t[row: row + 1], w_t, reverse=reverse,
                          lengths=torch.tensor([length]))
        np.testing.assert_allclose(
            got[row: row + 1].float().numpy(), alone.float().numpy(),
            atol=1e-6 if dtype == torch.float32 else BF16_TOL)
        assert torch.count_nonzero(got[row, length:]) == 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_full_lengths_are_the_unmasked_result(dtype, reverse):
    xw, w_h = _data(seed=2)
    xw_t = torch.from_numpy(xw).to(dtype)
    w_t = torch.from_numpy(w_h).to(dtype)
    full = torch.full((len(LENGTHS),), FRAMES, dtype=torch.int32)

    assert torch.equal(lstm_scan(xw_t, w_t, reverse=reverse, lengths=full),
                       lstm_scan(xw_t, w_t, reverse=reverse))


@pytest.mark.parametrize('reverse', [False, True])
def test_bf16_matches_pallas_on_truncated_rows(reverse):
    """bf16: each row's valid frames against JAX's Pallas kernel
    (interpret mode) on the row cut to its length, forward on the prefix,
    reverse on the prefix with ``reverse=True``."""

    xw, w_h = _data(seed=3)
    xw_t = torch.from_numpy(xw).bfloat16()
    w_t = torch.from_numpy(w_h).bfloat16()

    got = lstm_scan(xw_t, w_t, reverse=reverse, lengths=_lengths())

    w_jax = jnp.asarray(w_t.float().numpy(), jnp.bfloat16)
    for row, length in enumerate(LENGTHS):
        if length == 0:
            continue
        prefix = jnp.asarray(xw_t[row: row + 1, :length].float().numpy(),
                             jnp.bfloat16)
        ref = lstm_scan_pallas(prefix, w_jax, reverse=reverse, block_t=16,
                               interpret=True)
        np.testing.assert_allclose(got[row, :length].float().numpy(),
                                   np.asarray(ref[0].astype(jnp.float32)),
                                   atol=BF16_TOL)


def test_f32_bilstm_matches_flax_masked():
    """The layer with lengths against JAX's masked ``FastBiLSTM`` (its XLA
    scan), padded frames with non-zero garbage."""

    rng = np.random.RandomState(4)
    inputs = rng.randn(len(LENGTHS), FRAMES, 24).astype(np.float32)

    module = JaxFastBiLSTM(features=16)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(inputs))
    ref = np.asarray(module.apply(variables, jnp.asarray(inputs),
                                  lengths=jnp.asarray(LENGTHS)))

    layer = FastBiLSTM(24, 16)
    layer.load_state_dict(from_flax(variables))
    with torch.no_grad():
        got = layer(torch.from_numpy(inputs), lengths=_lengths()).numpy()

    np.testing.assert_allclose(got, ref, atol=F32_TOL)
    mask = lengths_to_mask(_lengths(), FRAMES).numpy()
    assert not got[~mask].any()


def test_f32_lstm_matches_flax_masked():
    rng = np.random.RandomState(5)
    inputs = rng.randn(len(LENGTHS), FRAMES, 12).astype(np.float32)

    module = JaxFastLSTM(features=16)
    variables = module.init(jax.random.PRNGKey(1), jnp.asarray(inputs))
    ref = np.asarray(module.apply(variables, jnp.asarray(inputs),
                                  lengths=jnp.asarray(LENGTHS)))

    layer = FastLSTM(12, 16)
    layer.load_state_dict(from_flax(variables))
    with torch.no_grad():
        got = layer(torch.from_numpy(inputs), lengths=_lengths()).numpy()

    np.testing.assert_allclose(got, ref, atol=F32_TOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_zero_padded_width_takes_the_lengths(dtype, reverse):
    """H = 24 run zero-padded to 32 units (the route a card takes for a
    width the kernels refuse) takes the lengths unchanged: the unpadded
    masked recurrence, bf16 bit for bit and float32 within 1e-6 (the CPU's
    matmul sums 32 terms in another order than 24, as
    ``tests/test_torch_lstm_route.py`` holds the unmasked route), padded
    frames exactly 0."""

    xw, w_h = _data(hidden=24, seed=6)
    xw_t = torch.from_numpy(xw).to(dtype)
    w_t = torch.from_numpy(w_h).to(dtype)

    with torch.no_grad():
        padded = padded_recurrence(xw_t, w_t, reverse, 32, _lengths())
    masked = lstm_scan(xw_t, w_t, reverse=reverse, lengths=_lengths())

    if dtype == torch.bfloat16:
        assert torch.equal(padded, masked)
    else:
        np.testing.assert_allclose(padded.numpy(), masked.numpy(), atol=1e-6)
    mask = lengths_to_mask(_lengths(), FRAMES)
    assert torch.count_nonzero(padded[~mask]) == 0


def test_lengths_while_autograd_records_raise():
    layer = FastBiLSTM(8, 16)
    inputs = torch.randn(2, 5, 8)

    with pytest.raises(NotImplementedError, match='masked training'):
        layer(inputs, lengths=torch.tensor([5, 3]))

    with torch.no_grad():
        assert layer(inputs, lengths=torch.tensor([5, 3])).shape == (2, 5, 32)


def test_wrapper_checks_lengths():
    xw, w_h = _data(batch=2, frames=5, hidden=16)
    xw_t, w_t = torch.from_numpy(xw), torch.from_numpy(w_h)

    with pytest.raises(ValueError, match=r'\[0, 5\]'):
        lstm_scan(xw_t, w_t, lengths=torch.tensor([6, 1]))
    with pytest.raises(ValueError, match=r'\[0, 5\]'):
        lstm_scan(xw_t, w_t, lengths=torch.tensor([-1, 1]))
    with pytest.raises(ValueError):
        lstm_scan(xw_t, w_t, lengths=torch.tensor([5]))
    with pytest.raises(TypeError):
        lstm_scan(xw_t, w_t, lengths=torch.tensor([5.0, 1.0]))

    # Any integer dtype is taken
    got = lstm_scan(xw_t, w_t, lengths=torch.tensor([5, 2]))
    assert torch.equal(got, lstm_scan_plain(xw_t, w_t,
                                            lengths=torch.tensor([5, 2])))
