"""The port's on-device note decode vs the JAX package's, on the CPU.

Tolerance: none. Every buffer (pitch rows, onset and offset frames, note
counts including ``count > capacity`` overflow) must equal JAX's bit for
bit, and the host finalization must give identical notes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu.ops import decode as jdecode
from amt_tools_tpu.tools import PianoProfile as JaxPianoProfile

from amt_tools_tpu_torch.ops import decode
from amt_tools_tpu_torch.tools import PianoProfile

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)


def _maps(batch, rows, frames, density, seed):
    rng = np.random.RandomState(seed)
    multi_pitch = (rng.rand(batch, rows, frames) < density).astype(np.float32)
    onsets = (rng.rand(batch, rows, frames) < density / 3).astype(np.float32)
    return multi_pitch, onsets


def _jax_buffers(multi_pitch, onsets, capacity):
    fn = jax.vmap(lambda m, o: jdecode.notes_on_device(m, o, capacity=capacity))
    return [np.asarray(b) for b in
            fn(jnp.asarray(multi_pitch),
               None if onsets is None else jnp.asarray(onsets))]


def _port_buffers(multi_pitch, onsets, capacity):
    return [b.numpy() for b in decode.notes_on_device(
        torch.from_numpy(multi_pitch),
        None if onsets is None else torch.from_numpy(onsets),
        capacity=capacity)]


def test_threshold_and_edges_match():
    rng = np.random.RandomState(0)
    acts = rng.rand(2, 5, 40).astype(np.float32)
    np.testing.assert_array_equal(
        decode.threshold(torch.from_numpy(acts), 0.5).numpy(),
        np.asarray(jdecode.threshold(jnp.asarray(acts), 0.5)))

    binary = (acts > 0.6).astype(np.float32)
    np.testing.assert_array_equal(
        decode.multi_pitch_to_onsets(torch.from_numpy(binary)).numpy(),
        np.asarray(jdecode.multi_pitch_to_onsets(jnp.asarray(binary))))


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_sigmoid_threshold_matches_jax(dtype):
    # In bf16, cells with logits just below 0 sit at exactly 0.5 and fire
    logits = np.concatenate([np.linspace(-0.05, 0.05, 201),
                             np.random.RandomState(0).randn(500) * 4])
    logits = logits.astype(np.float32)
    port_x = torch.from_numpy(logits).to(getattr(torch, dtype))
    jax_x = jnp.asarray(port_x.float().numpy(), getattr(jnp, dtype))

    port = decode.sigmoid(port_x)
    ref = jax.nn.sigmoid(jax_x)
    # bf16: equal; float32: within an ulp (the two exp implementations)
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0 if dtype == 'bfloat16' else 2e-7)
    np.testing.assert_array_equal(decode.threshold(port).numpy(),
                                  np.asarray(jdecode.threshold(ref)))
    if dtype == 'bfloat16':
        assert decode.threshold(decode.sigmoid(
            torch.tensor([-0.01], dtype=torch.bfloat16))).item() == 1.0


@pytest.mark.parametrize('with_onsets', [False, True])
def test_note_segments_match(with_onsets):
    multi_pitch, onsets = _maps(2, 7, 150, 0.4, seed=1)
    onsets = onsets if with_onsets else None

    got = decode.note_segments(torch.from_numpy(multi_pitch),
                               None if onsets is None else torch.from_numpy(onsets))
    ref = jax.vmap(jdecode.note_segments)(
        jnp.asarray(multi_pitch),
        None if onsets is None else jnp.asarray(onsets))

    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize('frames,density,capacity,with_onsets',
                         [(300, 0.3, 512, True),    # fits
                          (300, 0.3, 512, False),   # onsets from pitch edges
                          (257, 0.5, 64, True),     # count > capacity
                          (128, 0.0, 32, True),     # silent maps
                          (1000, 0.9, 256, False)])  # dense, ragged tiles
def test_notes_on_device_bit_for_bit(frames, density, capacity, with_onsets):
    multi_pitch, onsets = _maps(3, 11, frames, density, seed=frames)
    onsets = onsets if with_onsets else None

    got = _port_buffers(multi_pitch, onsets, capacity)
    ref = _jax_buffers(multi_pitch, onsets, capacity)

    for g, r in zip(got, ref):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, r)

    if density == 0.5:
        assert (got[-1] > capacity).all()


def test_single_map_and_host_finalization():
    multi_pitch, onsets = _maps(1, 9, 200, 0.35, seed=5)
    times = np.arange(200) * 512 / 16000

    got = decode.notes_on_device(torch.from_numpy(multi_pitch[0]),
                                 torch.from_numpy(onsets[0]), capacity=256)
    ref = jdecode.notes_on_device(jnp.asarray(multi_pitch[0]),
                                  jnp.asarray(onsets[0]), capacity=256)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    profile = PianoProfile()
    port_notes = decode.notes_from_device(*[g.numpy() for g in got], times,
                                          profile)
    jax_notes = jdecode.notes_from_device(*[np.asarray(r) for r in ref], times,
                                          JaxPianoProfile())
    np.testing.assert_array_equal(port_notes[0], jax_notes[0])
    np.testing.assert_array_equal(port_notes[1], jax_notes[1])
    assert len(port_notes[0]) > 0
