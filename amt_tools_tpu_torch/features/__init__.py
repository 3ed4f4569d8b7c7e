"""Feature extraction on tensors: STFT and mel spectrograms."""

from .common import FeatureModule
from .waveform import WaveformWrapper
from .stft import STFT
from .mel import MelSpec

__all__ = ['FeatureModule', 'WaveformWrapper', 'STFT', 'MelSpec']
