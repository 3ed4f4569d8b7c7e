"""Raw framed-audio features and the frame geometry of the spectral ones.

Counterpart of ``amt_tools_tpu/features/waveform.py`` ``WaveformWrapper``,
with the uncentred frame-count algebra (``get_expected_frames``,
``get_sample_range``, ``:25-42``) and the ``frame_pad`` of uncentred audio
ahead of framing (``process_jax``, ``:44-55``).
"""

import numpy as np

from ..ops import spectral
from .common import FeatureModule


class WaveformWrapper(FeatureModule):
    """Expose framed raw audio as (win_length, T) features."""

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

    def get_sample_range(self, num_frames):
        if self.center or num_frames == 0:
            return super().get_sample_range(num_frames)

        if num_frames == 1:
            return np.arange(1, self.win_length + 1)

        return (np.arange(1, self.hop_length + 1) +
                self.get_num_samples_required() + (num_frames - 2) * self.hop_length)

    def process(self, audio):
        """(..., N) audio tensor -> (..., win_length, T) frames; uncentred
        audio is zero-padded to whole frames first (:meth:`frame_pad`)."""

        if not self.center:
            audio = self.frame_pad(audio)

        frames = spectral.frame_signal(audio, self.win_length, self.hop_length,
                                       center=self.center)

        # (..., T, W) -> (..., W, T) to match the (F, T) convention
        return frames.transpose(-1, -2)

    def get_null_features(self):
        return np.zeros((self.win_length, 0), dtype=np.float32)

    def get_times(self, audio, at_start=False):
        times = super().get_times(audio)

        if self.center and at_start:
            times = times - (self.win_length // 2) / self.sample_rate
        elif not self.center and not at_start:
            times = times + (self.win_length // 2) / self.sample_rate

        return times

    def get_feature_size(self):
        return self.win_length
