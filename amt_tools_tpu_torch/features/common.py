"""Feature extraction module base class.

Counterpart of ``amt_tools_tpu/features/common.py``: the frame-count
algebra (T = 1 + N // hop, ``get_sample_range``, the padding of audio to
whole frames, ``:50-85``), frame times, and the dB post-processing that maps
[-80, 0] dB onto [0, 1]. Concrete modules
implement :meth:`process`, a function on (..., N) audio tensors that runs
on the audio's device; :meth:`process_audio` is the host entry point the
datasets use.
"""

from abc import abstractmethod

import numpy as np
import torch

from ..ops import spectral
from ..tools.utils import resolve_device


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

    def get_sample_range(self, num_frames):
        """Audio lengths (in samples) that produce exactly ``num_frames``."""

        if num_frames <= 0:
            return np.array([0])

        max_samples = num_frames * self.hop_length - 1
        min_samples = max(1, max_samples - self.hop_length + 1)

        return np.arange(min_samples, max_samples + 1)

    def get_num_samples_required(self):
        """Number of samples required to extract one full frame of features."""

        return self.get_sample_range(1)[-1]

    @staticmethod
    def divisor_pad(audio, divisor):
        """Zero-pad audio so its length is divisible by ``divisor``.

        A numpy array is padded as the JAX package pads it (``np.append``
        of a 1-D zero run); a tensor is padded on its last axis on its own
        device.
        """

        pad_amt = divisor - (audio.shape[-1] % divisor)

        if 0 < pad_amt < divisor:
            if isinstance(audio, torch.Tensor):
                return torch.nn.functional.pad(audio, (0, int(pad_amt)))
            audio = np.append(audio, np.zeros(pad_amt, dtype=np.float32),
                              axis=-1)

        return audio

    def frame_pad(self, audio):
        """Zero-pad audio to fill out the final frame."""

        divisor = self.get_num_samples_required()

        if audio.shape[-1] > divisor:
            divisor = self.hop_length

        return self.divisor_pad(audio, divisor)

    def get_null_features(self):
        """Features for empty audio: a zero-frame array of the right shape."""

        return np.zeros((self.get_num_channels(), self.get_feature_size(), 0),
                        dtype=np.float32)

    @abstractmethod
    def process(self, audio):
        """Feature transform: (..., N) audio tensor -> (..., C, F, T)."""

        raise NotImplementedError

    def process_audio(self, audio, device=None):
        """Host entry point: numpy audio in, numpy float32 features out.

        Runs :meth:`process` on ``device`` (the card unless the caller
        names one; ``'cpu'`` takes the plain versions). Eager PyTorch does
        not recompile per length, so the audio is not padded to the JAX
        package's length buckets; its frames equal an unbucketed run's.
        """

        # A fresh array: cached tracks are read-only, and a tensor must
        # own memory it may write
        audio = np.array(audio, dtype=np.float32)
        if audio.shape[-1] == 0:
            return self.get_null_features()

        device = resolve_device(device)
        with torch.inference_mode():
            feats = self.process(torch.from_numpy(audio).to(device))

        return feats.cpu().numpy()

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

    @classmethod
    def features_name(cls):
        """Class-name tag of the feature module."""

        return cls.__name__

    @abstractmethod
    def get_feature_size(self):
        """Dimensionality along the feature (frequency) axis."""

        raise NotImplementedError
