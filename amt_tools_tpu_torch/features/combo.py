"""Several feature modules stacked on the channel axis.

Counterpart of ``amt_tools_tpu/features/combo.py``: the modules must share
a sample rate, a hop and a feature size; the combination's sample range is
the intersection of theirs, its frames are clipped to the shortest
module's, and its ``features_name`` (the feature cache's key) joins the
modules' with ``'+'``.
"""

import numpy as np
import torch

from .common import FeatureModule

__all__ = ['FeatureCombo']


class FeatureCombo(FeatureModule):
    """Concatenate features of several modules along the channel axis."""

    def __init__(self, modules):
        if not modules:
            raise ValueError('FeatureCombo requires at least one module.')

        self.modules = modules

        sample_rates = {m.get_sample_rate() for m in modules}
        hop_lengths = {m.get_hop_length() for m in modules}
        feature_sizes = {m.get_feature_size() for m in modules}

        if len(sample_rates) > 1:
            raise ValueError('All modules must share one sample rate.')
        if len(hop_lengths) > 1:
            raise ValueError('All modules must share one hop length.')
        if len(feature_sizes) > 1:
            raise ValueError('All modules must share one feature size '
                             'to concatenate on the channel axis.')

        num_channels = sum(m.get_num_channels() for m in modules)

        super().__init__(sample_rate=sample_rates.pop(),
                         hop_length=hop_lengths.pop(),
                         num_channels=num_channels,
                         decibels=None)

    def get_expected_frames(self, audio):
        return min(m.get_expected_frames(audio) for m in self.modules)

    def get_sample_range(self, num_frames):
        # Intersect the valid sample ranges of all modules
        ranges = [set(m.get_sample_range(num_frames).tolist())
                  for m in self.modules]
        common = set.intersection(*ranges)

        if not common:
            raise ValueError('Feature modules have incompatible sample ranges.')

        return np.array(sorted(common))

    def process(self, audio):
        feats = [m.process(audio) for m in self.modules]

        # Clip all modules to the shortest frame count, then stack channels
        num_frames = min(f.shape[-1] for f in feats)
        feats = [f[..., :num_frames] for f in feats]

        return torch.cat(feats, dim=-3)

    def get_times(self, audio):
        return self.modules[0].get_times(audio)

    def get_feature_size(self):
        return self.modules[0].get_feature_size()

    def features_name(self):
        return '+'.join(m.features_name() for m in self.modules)
