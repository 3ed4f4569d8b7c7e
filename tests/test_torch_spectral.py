"""PyTorch port vs the JAX package: spectral builders, framing, dB scaling
and the STFT/mel feature modules (CPU; the port runs its plain versions).

Tolerances:
- numpy builders (window, DFT bank, mel filterbank): bit for bit;
- framing: exact (a gather of the same samples);
- dB scaling on identical float32 inputs: 1e-4 dB (log10 rounding);
- [0, 1] features: 4e-4, the bound the JAX package sets for its own fused
  STFT against the FFT path (``ops/pallas_stft.py:30``); the port contracts
  against the DFT bank in float32 where the JAX CPU path runs an FFT.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amt_tools_tpu.features import MelSpec as JaxMelSpec
from amt_tools_tpu.features import STFT as JaxSTFT
from amt_tools_tpu.ops import spectral as jspec

from amt_tools_tpu_torch.features import STFT, MelSpec
from amt_tools_tpu_torch.ops import spectral

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)


def _tonal(num_samples, seed=0, sr=16000):
    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / sr
    audio = sum(a * np.sin(2 * np.pi * f * t)
                for a, f in zip(rng.rand(4) * 0.2 + 0.05,
                                rng.rand(4) * 3000 + 60))
    return (audio + 1e-3 * rng.randn(num_samples)).astype(np.float32)


@pytest.mark.parametrize('win_length', [16, 512, 1023])
def test_window_and_dft_bank_bit_for_bit(win_length):
    np.testing.assert_array_equal(spectral.hann_window(win_length),
                                  jspec.hann_window(win_length))
    np.testing.assert_array_equal(
        spectral.hann_window(win_length, periodic=False),
        jspec.hann_window(win_length, periodic=False))
    np.testing.assert_array_equal(spectral.dft_bank(1024, win_length),
                                  jspec.dft_bank(1024, win_length))


@pytest.mark.parametrize('htk', [False, True])
def test_mel_builders_bit_for_bit(htk):
    freqs = np.linspace(0, 8000, 97)
    np.testing.assert_array_equal(spectral.hz_to_mel(freqs, htk),
                                  jspec.hz_to_mel(freqs, htk))
    mels = spectral.hz_to_mel(freqs, htk)
    np.testing.assert_array_equal(spectral.mel_to_hz(mels, htk),
                                  jspec.mel_to_hz(mels, htk))
    np.testing.assert_array_equal(
        spectral.mel_filterbank(16000, 2048, n_mels=229, htk=htk),
        jspec.mel_filterbank(16000, 2048, n_mels=229, htk=htk))


@pytest.mark.parametrize('frame_length,hop,center',
                         [(512, 128, True), (511, 100, True),
                          (512, 128, False), (400, 160, False)])
def test_frame_signal_matches(frame_length, hop, center):
    audio = _tonal(3001)[None].repeat(2, 0)
    got = spectral.frame_signal(torch.from_numpy(audio), frame_length, hop,
                                center=center)
    ref = jspec.frame_signal(jnp.asarray(audio), frame_length, hop,
                             center=center)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_stft_mag_matches():
    audio = _tonal(8000)
    got = spectral.stft_mag(torch.from_numpy(audio), 512, 128, win_length=400)
    ref = jspec.stft_mag(jnp.asarray(audio), 512, 128, win_length=400)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * ref.max(),
                               rtol=1e-4)


@pytest.mark.parametrize('sample_ndim', [None, 2])
def test_db_scaling_per_clip(sample_ndim):
    rng = np.random.RandomState(1)
    # Clips of very different loudness: a batch-wide reference would move
    # the quiet clip's values
    power = rng.rand(3, 20, 30).astype(np.float32) ** 4
    power[1] *= 1e4
    power[2, :, :5] = 0.0
    got = spectral.power_to_db(torch.from_numpy(power),
                               sample_ndim=sample_ndim)
    ref = jspec.power_to_db(jnp.asarray(power), sample_ndim=sample_ndim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)

    amp = np.sqrt(power)
    got = spectral.amplitude_to_db(torch.from_numpy(amp),
                                   sample_ndim=sample_ndim)
    ref = jspec.amplitude_to_db(jnp.asarray(amp), sample_ndim=sample_ndim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def _clips():
    loud = _tonal(12000, seed=2)
    quiet = 0.01 * _tonal(12000, seed=3)
    return np.stack([loud, quiet])


@pytest.mark.parametrize('n_mels', [48, 229])
def test_melspec_features_match(n_mels):
    audio = _clips()
    port = MelSpec(n_mels=n_mels)
    jax_mel = JaxMelSpec(n_mels=n_mels)

    got = port.process(torch.from_numpy(audio)).numpy()
    ref = np.asarray(jax_mel.process_jax(jnp.asarray(audio)))

    assert got.shape == ref.shape == (2, 1, n_mels, 24)
    np.testing.assert_allclose(got, ref, atol=4e-4)

    # Per-clip dB reference: each clip alone gives the same features
    for b in range(2):
        alone = port.process(torch.from_numpy(audio[b:b + 1])).numpy()
        np.testing.assert_allclose(alone[0], got[b], atol=1e-6)


def test_stft_features_and_frame_algebra():
    audio = _clips()
    port = STFT(n_fft=512, hop_length=128)
    jax_stft = JaxSTFT(n_fft=512, hop_length=128)

    got = port.process(torch.from_numpy(audio)).numpy()
    ref = np.asarray(jax_stft.process_jax(jnp.asarray(audio)))
    np.testing.assert_allclose(got, ref, atol=4e-4)

    for n in (0, 1, 511, 512, 12000):
        assert port.get_expected_frames(n) == jax_stft.get_expected_frames(n)
    np.testing.assert_array_equal(port.get_times(audio[0]),
                                  jax_stft.get_times(audio[0]))
    np.testing.assert_array_equal(port.get_times(audio[0], at_start=True),
                                  jax_stft.get_times(audio[0], at_start=True))
    assert port.get_feature_size() == jax_stft.get_feature_size()
