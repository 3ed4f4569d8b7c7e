"""Frame-level signal power features.

Counterpart of ``amt_tools_tpu/features/power.py``: the mean squared sample
of each frame of the waveform wrapper's frames, in dB against each track's
own maximum (``sample_ndim=1``: the last axis is the track), as torch ops
on the audio's device.
"""

import numpy as np
import torch

from ..ops import spectral
from .waveform import WaveformWrapper

__all__ = ['SignalPower']


class SignalPower(WaveformWrapper):
    """Mean squared signal power a frame -> (T,)."""

    def __init__(self, sample_rate=44100, hop_length=512, decibels=True,
                 win_length=None, center=True):
        super().__init__(sample_rate=sample_rate, hop_length=hop_length,
                         decibels=decibels, win_length=win_length, center=center)

    def process(self, audio):
        # (..., W, T) framed audio from the waveform wrapper
        frames = super().process(audio)

        powers = torch.sum(torch.square(frames), dim=-2) / self.win_length

        if self.decibels:
            # (..., T) power curves: the dB reference of each track
            powers = spectral.amplitude_to_db(powers, sample_ndim=1)

        return powers

    def get_null_features(self):
        return np.zeros((0,), dtype=np.float32)

    def get_feature_size(self):
        return 1
