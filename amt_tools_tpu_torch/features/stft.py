"""Magnitude spectrogram features.

Counterpart of ``amt_tools_tpu/features/stft.py``. The power spectrum runs
through :func:`ops.stft_kernel.stft_power`: the Hopper kernel for CUDA
audio (the JAX package's Pallas path, ``features/stft.py:51-68``), its plain
framed matmul for CPU audio.
"""

import torch
import torch.nn.functional as F

from ..ops import cuda_build, spectral
from ..ops.stft_kernel import stft_power
from .common import FeatureModule
from .waveform import WaveformWrapper


class STFT(WaveformWrapper):
    """Short-time Fourier transform magnitude features -> (1, n_fft//2+1, T)."""

    def __init__(self, sample_rate=16000, hop_length=512, decibels=True,
                 win_length=None, center=True, n_fft=2048,
                 pad_mode='constant', pad_end=False):
        if pad_mode not in ('constant', 'reflect'):
            raise ValueError(f"pad_mode must be 'constant' or 'reflect', got "
                             f"{pad_mode!r}")
        if pad_end and center:
            raise ValueError('pad_end frames the audio from its first sample: '
                             'give center=False')
        self.n_fft = n_fft
        self.pad_mode = pad_mode
        self.pad_end = pad_end

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
        return cuda_build.cached(
            self._device_banks, device,
            lambda: torch.from_numpy(self._dft_bank).to(device))

    def _stft_power(self, audio):
        """(..., N) float32 audio -> (..., n_fft//2+1, T) power spectrogram.

        Centred frames are zero-padded, or with ``pad_mode='reflect'``
        reflected (half a frame each side, as ``torch.stft`` pads them),
        which gives the same T = 1 + N // hop frames. With ``pad_end`` the
        frames start at the first sample and the audio is zero-padded at
        its end so that each hop starts a frame: T = ceil(N / hop), as
        ``tf.signal.stft(..., pad_end=True)`` frames it."""

        lead = audio.shape[:-1]
        flat = audio.reshape((-1, audio.shape[-1])).contiguous()
        center = self.center
        if center and self.pad_mode == 'reflect':
            half = self.n_fft // 2
            flat = F.pad(flat, (half, half), mode='reflect')
            center = False
        if self.pad_end:
            frames = -(-flat.shape[-1] // self.hop_length)
            flat = F.pad(flat, (0, (frames - 1) * self.hop_length + self.n_fft
                                - flat.shape[-1]))
        power = stft_power(flat, self._bank(audio.device), self.n_fft,
                           self.hop_length, center=center)

        return power.reshape(lead + power.shape[1:])

    def process(self, audio):
        return self.post_proc(torch.sqrt(self._stft_power(audio)))

    # (C, F, 0), not the raw frames' (win_length, 0)
    get_null_features = FeatureModule.get_null_features

    def get_feature_size(self):
        return self.n_fft // 2 + 1
