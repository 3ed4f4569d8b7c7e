"""The port's STFT power wrapper vs the JAX package's fused Pallas STFT
kernel (interpret mode) and its FFT path, on the CPU.

On CPU tensors the wrapper runs its plain version, a framed float32 matmul
against the DFT bank; the Hopper kernel itself is held against that plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: 1e-4 relative, where "relative" is to each clip's peak power
(the sums differ in order from an FFT, and quiet bins carry an absolute
error set by the frame energy, not by their own value).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amt_tools_tpu.ops import spectral as jspec
from amt_tools_tpu.ops.pallas_stft import split_bank_bf16, stft_power_pallas

from amt_tools_tpu_torch.ops import spectral
from amt_tools_tpu_torch.ops.stft_kernel import stft_power, stft_power_plain

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)

RTOL_OF_PEAK = 1e-4


def _tonal(batch, num_samples, seed=0, sr=16000):
    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / sr
    clips = []
    for _ in range(batch):
        clips.append(sum(a * np.sin(2 * np.pi * f * t + p)
                         for a, f, p in zip(rng.rand(4) * 0.2 + 0.05,
                                            rng.rand(4) * 2000 + 100,
                                            rng.rand(4) * 6.28)))
    return np.stack(clips).astype(np.float32)


def _assert_close_to_peak(got, ref):
    peak = ref.reshape(ref.shape[0], -1).max(axis=1)[:, None, None]
    np.testing.assert_allclose(got / peak, ref / peak, atol=RTOL_OF_PEAK)


def _port(audio, n_fft, hop, center=True):
    bank = torch.from_numpy(spectral.dft_bank(n_fft))
    return stft_power(torch.from_numpy(audio), bank, n_fft, hop,
                      center=center).numpy()


def test_matches_pallas_kernel_interpret():
    n_fft, hop = 512, 128
    audio = _tonal(3, 16000)

    hi, lo = split_bank_bf16(jspec.dft_bank(n_fft))
    ref = np.asarray(stft_power_pallas(jnp.asarray(audio), hi, lo, n_fft, hop,
                                       block_t=8, interpret=True))
    got = _port(audio, n_fft, hop)

    assert got.shape == ref.shape == (3, 257, 126)
    _assert_close_to_peak(got, ref)


@pytest.mark.parametrize('n_fft,hop,center', [(512, 128, True),
                                              (400, 160, True),
                                              (512, 128, False)])
def test_matches_fft_power(n_fft, hop, center):
    audio = _tonal(2, 9001, seed=1)

    ref = np.asarray(jspec.stft_mag(jnp.asarray(audio), n_fft, hop,
                                    center=center)) ** 2
    got = _port(audio, n_fft, hop, center)

    assert got.shape == ref.shape
    _assert_close_to_peak(got, ref)


def test_plain_version_is_the_cpu_path():
    audio = torch.from_numpy(_tonal(2, 4000))
    bank = torch.from_numpy(spectral.dft_bank(256))
    launches = stft_power.launches

    np.testing.assert_array_equal(stft_power(audio, bank, 256, 64).numpy(),
                                  stft_power_plain(audio, bank, 256, 64).numpy())
    assert stft_power.launches == launches


def test_wrapper_rejects_bad_inputs():
    bank = torch.from_numpy(spectral.dft_bank(256))
    audio = torch.zeros(2, 1000)

    with pytest.raises(ValueError):
        stft_power(audio[0], bank, 256, 64)
    with pytest.raises(TypeError):
        stft_power(audio.double(), bank, 256, 64)
    with pytest.raises(ValueError):
        stft_power(audio, bank, 512, 64)
    with pytest.raises(ValueError):
        stft_power(torch.zeros(1000, 2).t(), bank, 256, 64)
