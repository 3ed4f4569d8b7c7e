"""Magnitude spectrogram features.

Counterpart of ``amt_tools_tpu/features/stft.py``. The power spectrum runs
through :func:`ops.stft_kernel.stft_power`: the Hopper kernel for CUDA
audio (the JAX package's Pallas path, ``features/stft.py:51-68``), its plain
framed matmul for CPU audio.
"""

import torch

from ..ops import spectral
from ..ops.stft_kernel import stft_power
from .waveform import WaveformWrapper


class STFT(WaveformWrapper):
    """Short-time Fourier transform magnitude features -> (1, n_fft//2+1, T)."""

    def __init__(self, sample_rate=16000, hop_length=512, decibels=True,
                 win_length=None, center=True, n_fft=2048):
        self.n_fft = n_fft

        if win_length is None:
            win_length = n_fft

        super().__init__(sample_rate=sample_rate, hop_length=hop_length,
                         decibels=decibels, win_length=win_length, center=center)

        # Host constants built once; device copies made on first use
        self._window = spectral.hann_window(self.win_length)
        self._dft_bank = spectral.dft_bank(self.n_fft, self.win_length,
                                           self._window)
        self._device_banks = {}

    def _bank(self, device):
        if device not in self._device_banks:
            self._device_banks[device] = torch.from_numpy(self._dft_bank).to(device)

        return self._device_banks[device]

    def _stft_power(self, audio):
        """(..., N) float32 audio -> (..., n_fft//2+1, T) power spectrogram."""

        lead = audio.shape[:-1]
        flat = audio.reshape((-1, audio.shape[-1])).contiguous()
        power = stft_power(flat, self._bank(audio.device), self.n_fft,
                           self.hop_length, center=self.center)

        return power.reshape(lead + power.shape[1:])

    def process(self, audio):
        return self.post_proc(torch.sqrt(self._stft_power(audio)))

    def get_feature_size(self):
        return self.n_fft // 2 + 1
