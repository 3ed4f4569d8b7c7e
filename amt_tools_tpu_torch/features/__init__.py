"""Feature extraction on tensors: STFT, mel and constant-Q spectrograms."""

from .common import FeatureModule
from .waveform import WaveformWrapper
from .stft import STFT
from .mel import MelSpec
from .cqt import VQT, CQT

__all__ = ['FeatureModule', 'WaveformWrapper', 'STFT', 'MelSpec', 'VQT',
           'CQT']
