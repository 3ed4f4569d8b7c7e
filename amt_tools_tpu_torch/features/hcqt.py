"""Harmonic CQT/VQT: one transform a harmonic multiple of fmin.

Counterpart of ``amt_tools_tpu/features/hcqt.py``: ``HVQT`` and ``HCQT``
(DeepSalience's harmonics [0.5, 1, 2, 3, 4, 5] by default), one
:class:`VQT` a harmonic, concatenated on the channel axis. Every VQT shares
the frame algebra T = 1 + N // hop, so the harmonics give the same frame
count. Each harmonic's ``VQT`` takes the JAX class's defaults (the full
bank, ``exact=True``): on CUDA audio kernel C on its float32 FFMA route, on
CPU audio its plain version. JAX's ``frame_chunk`` has no counterpart, as
for ``VQT``.
"""

import torch

from ..tools.instrument import midi_to_hz, note_to_midi
from .common import FeatureModule
from .cqt import VQT

__all__ = ['HVQT', 'HCQT']


class HVQT(FeatureModule):
    """Harmonic VQT -> (H, n_bins, T)."""

    def __init__(self, sample_rate=22050, hop_length=512, decibels=True,
                 fmin=None, harmonics=None, n_bins=84, bins_per_octave=12,
                 gamma=None):
        if fmin is None:
            fmin = float(midi_to_hz(note_to_midi('C1')))
        self.fmin = fmin

        if harmonics is None:
            harmonics = [0.5, 1, 2, 3, 4, 5]
        self.harmonics = sorted(harmonics)

        super().__init__(sample_rate, hop_length, len(self.harmonics), decibels)

        self.n_bins = n_bins
        self.bins_per_octave = bins_per_octave

        # One VQT module a harmonic
        self.modules = [VQT(sample_rate=sample_rate, hop_length=hop_length,
                            decibels=decibels, fmin=h * fmin, n_bins=n_bins,
                            bins_per_octave=bins_per_octave, gamma=gamma)
                        for h in self.harmonics]

    def process(self, audio):
        """(..., N) float32 audio -> (..., H, n_bins, T) [0, 1] features."""

        # Each harmonic gives (..., 1, F, T); concatenate on the channel axis
        return torch.cat([module.process(audio) for module in self.modules],
                         dim=-3)

    def get_times(self, audio, at_start=False):
        return self.modules[0].get_times(audio, at_start)

    def get_feature_size(self):
        return self.n_bins


class HCQT(HVQT):
    """Harmonic CQT: an HVQT with gamma = 0."""

    def __init__(self, sample_rate=22050, hop_length=512, decibels=True,
                 fmin=None, harmonics=None, n_bins=84, bins_per_octave=12):
        super().__init__(sample_rate=sample_rate, hop_length=hop_length,
                         decibels=decibels, fmin=fmin, harmonics=harmonics,
                         n_bins=n_bins, bins_per_octave=bins_per_octave,
                         gamma=0.0)
