"""Transcription models: base class, logistic head, Onsets & Frames v1/v2."""

from .common import TranscriptionModel, LogisticBank
from .onsetsframes import (AcousticModel, LanguageModel, OnsetsFrames,
                           OnsetsFrames2)

__all__ = ['TranscriptionModel', 'LogisticBank', 'AcousticModel',
           'LanguageModel', 'OnsetsFrames', 'OnsetsFrames2']
