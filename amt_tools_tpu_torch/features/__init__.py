"""Feature extraction on tensors: STFT, mel, constant-Q and harmonic
constant-Q spectrograms, signal power, combinations of modules, and the
online feature streams."""

from .common import FeatureModule
from .waveform import WaveformWrapper
from .stft import STFT
from .mel import MelSpec
from .cqt import VQT, CQT
from .hcqt import HVQT, HCQT
from .power import SignalPower
from .combo import FeatureCombo
from .stream import (AudioFileStream, AudioStream, FeatureStream,
                     MicrophoneStream)

__all__ = ['FeatureModule', 'WaveformWrapper', 'STFT', 'MelSpec', 'VQT',
           'CQT', 'HVQT', 'HCQT', 'SignalPower', 'FeatureCombo',
           'FeatureStream', 'MicrophoneStream', 'AudioStream',
           'AudioFileStream']
