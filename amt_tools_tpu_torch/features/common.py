"""Feature extraction module base class.

Counterpart of ``amt_tools_tpu/features/common.py``: the frame-count
algebra (T = 1 + N // hop), frame times, and the dB post-processing that
maps [-80, 0] dB onto [0, 1]. Concrete modules implement :meth:`process`,
a function on (..., N) audio tensors that runs on the audio's device.
"""

from abc import abstractmethod

import numpy as np
import torch

from ..ops import spectral


class FeatureModule(object):
    """Generic music feature extraction module."""

    def __init__(self, sample_rate, hop_length, num_channels, decibels=True):
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.num_channels = num_channels
        self.decibels = decibels

    def get_expected_frames(self, audio):
        """Number of frames produced for a piece of audio (or sample count)."""

        num_samples = audio if np.isscalar(audio) else np.asarray(audio).shape[-1]

        if num_samples == 0:
            return 0

        return 1 + num_samples // self.hop_length

    @abstractmethod
    def process(self, audio):
        """Feature transform: (..., N) audio tensor -> (..., C, F, T)."""

        raise NotImplementedError

    def to_decibels(self, feats):
        """Amplitude features to dB, each clip referenced to its own maximum."""

        return spectral.amplitude_to_db(feats, sample_ndim=2)

    def post_proc(self, feats):
        """dB scaling into [0, 1] and channel-dim insertion."""

        if self.decibels:
            feats = self.to_decibels(feats)
            # Assuming a range of -80 to 0 dB, scale between 0 and 1
            feats = torch.clamp(feats / 80.0 + 1.0, 0.0, 1.0)

        # Add a channel dimension before F
        return feats.unsqueeze(-3)

    def get_times(self, audio):
        """Time (seconds) of the start of each frame."""

        num_frames = self.get_expected_frames(audio)

        return np.arange(num_frames) * self.hop_length / self.sample_rate

    def get_sample_rate(self):
        return self.sample_rate

    def get_hop_length(self):
        return self.hop_length

    def get_num_channels(self):
        return self.num_channels

    @abstractmethod
    def get_feature_size(self):
        """Dimensionality along the feature (frequency) axis."""

        raise NotImplementedError
