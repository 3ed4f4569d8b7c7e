"""Framed-audio feature base: the centred-frame parts of
``amt_tools_tpu/features/waveform.py`` ``WaveformWrapper``."""

import numpy as np

from .common import FeatureModule


class WaveformWrapper(FeatureModule):
    """Frame geometry shared by the spectral features (centred frames)."""

    def __init__(self, sample_rate=44100, hop_length=512, decibels=False,
                 win_length=None, center=True):
        super().__init__(sample_rate=sample_rate, hop_length=hop_length,
                         num_channels=1, decibels=decibels)

        self.win_length = hop_length if win_length is None else win_length
        self.center = center

    def get_expected_frames(self, audio):
        num_samples = audio if np.isscalar(audio) else np.asarray(audio).shape[-1]

        if self.center or num_samples == 0:
            return super().get_expected_frames(audio)

        # Hops with full frames, plus one for an incomplete frame
        return 1 + ((max(0, num_samples - self.win_length) - 1) // self.hop_length + 1)

    def get_times(self, audio, at_start=False):
        times = super().get_times(audio)

        if self.center and at_start:
            times = times - (self.win_length // 2) / self.sample_rate
        elif not self.center and not at_start:
            times = times + (self.win_length // 2) / self.sample_rate

        return times

    def get_feature_size(self):
        return self.win_length
