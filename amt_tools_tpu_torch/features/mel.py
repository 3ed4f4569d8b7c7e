"""Mel spectrogram features: the STFT power spectrum projected onto a Slaney
mel filterbank, then power-dB scaled per clip.

Counterpart of ``amt_tools_tpu/features/mel.py``. The projection is a plain
float32 ``torch.matmul`` (the JAX package leaves it to XLA, ``mel.py:37``).
``fmin`` and ``fmax`` bound the filterbank; ``absolute_db`` gives the
High-resolution Piano Transcription model's features, ``10 log10(max(1e-10,
mel))`` against a reference of 1 with no floor below the maximum and no
[0, 1] mapping, in place of the per-clip scale; ``log_offset`` gives
hFT-Transformer's, the natural ``log(mel + log_offset)``.
"""

import torch

from .. import profiling
from ..ops import cuda_build, spectral
from .stft import STFT


class MelSpec(STFT):
    """Mel spectrogram features -> (1, n_mels, T)."""

    def __init__(self, sample_rate=16000, hop_length=512, decibels=True,
                 n_mels=229, n_fft=2048, win_length=None, center=True,
                 htk=False, fmin=0.0, fmax=None, absolute_db=False,
                 log_offset=None, pad_mode='constant'):
        if absolute_db and log_offset is not None:
            raise ValueError('absolute_db and log_offset are two scales: '
                             'give one')
        super().__init__(sample_rate=sample_rate, hop_length=hop_length,
                         decibels=decibels, win_length=win_length,
                         center=center, n_fft=n_fft, pad_mode=pad_mode)

        self.n_mels = n_mels
        self.htk = htk
        self.absolute_db = absolute_db
        self.log_offset = log_offset

        # (n_mels, n_fft//2+1), host constant; device copies on first use
        self._mel_fb = spectral.mel_filterbank(sample_rate, n_fft,
                                               n_mels=n_mels, fmin=fmin,
                                               fmax=fmax, htk=htk)
        self._device_fbs = {}

    def _filterbank(self, device):
        return cuda_build.cached(
            self._device_fbs, device,
            lambda: torch.from_numpy(self._mel_fb).to(device))

    def process(self, audio):
        with profiling.span('amt.features'):
            power = self._stft_power(audio)
            mel = torch.matmul(self._filterbank(audio.device), power)

            return self.post_proc(mel)

    def to_decibels(self, feats):
        """Mel features are powers: power-dB scaling, per-clip maximum."""

        return spectral.power_to_db(feats, sample_ndim=2)

    def post_proc(self, feats):
        """With ``absolute_db`` (and ``decibels``): ``10 log10(max(1e-10,
        x))``; with ``log_offset`` (and ``decibels``): ``log(x +
        log_offset)``; either with a channel dimension inserted. Else the
        per-clip [0, 1] scale."""

        if self.decibels and self.log_offset is not None:
            return torch.log(feats + self.log_offset).unsqueeze(-3)
        if not (self.decibels and self.absolute_db):
            return super().post_proc(feats)

        return (10.0 * torch.log10(torch.clamp_min(feats, 1e-10))).unsqueeze(
            -3)

    def get_feature_size(self):
        return self.n_mels
