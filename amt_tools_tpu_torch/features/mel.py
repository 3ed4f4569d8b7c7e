"""Mel spectrogram features: the STFT power spectrum projected onto a Slaney
mel filterbank, then power-dB scaled per clip.

Counterpart of ``amt_tools_tpu/features/mel.py``. The projection is a plain
float32 ``torch.matmul`` (the JAX package leaves it to XLA, ``mel.py:37``).
"""

import torch

from ..ops import spectral
from .stft import STFT


class MelSpec(STFT):
    """Mel spectrogram features -> (1, n_mels, T)."""

    def __init__(self, sample_rate=16000, hop_length=512, decibels=True,
                 n_mels=229, n_fft=2048, win_length=None, center=True,
                 htk=False):
        super().__init__(sample_rate=sample_rate, hop_length=hop_length,
                         decibels=decibels, win_length=win_length,
                         center=center, n_fft=n_fft)

        self.n_mels = n_mels
        self.htk = htk

        # (n_mels, n_fft//2+1), host constant; device copies on first use
        self._mel_fb = spectral.mel_filterbank(sample_rate, n_fft,
                                               n_mels=n_mels, htk=htk)
        self._device_fbs = {}

    def _filterbank(self, device):
        if device not in self._device_fbs:
            self._device_fbs[device] = torch.from_numpy(self._mel_fb).to(device)

        return self._device_fbs[device]

    def process(self, audio):
        power = self._stft_power(audio)
        mel = torch.matmul(self._filterbank(audio.device), power)

        return self.post_proc(mel)

    def to_decibels(self, feats):
        """Mel features are powers: power-dB scaling, per-clip maximum."""

        return spectral.power_to_db(feats, sample_ndim=2)

    def get_feature_size(self):
        return self.n_mels
