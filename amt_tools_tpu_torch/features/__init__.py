"""Feature extraction on tensors: STFT, mel and constant-Q spectrograms,
and the online feature streams."""

from .common import FeatureModule
from .waveform import WaveformWrapper
from .stft import STFT
from .mel import MelSpec
from .cqt import VQT, CQT
from .stream import AudioStream, FeatureStream, MicrophoneStream

__all__ = ['FeatureModule', 'WaveformWrapper', 'STFT', 'MelSpec', 'VQT',
           'CQT', 'FeatureStream', 'MicrophoneStream', 'AudioStream']
