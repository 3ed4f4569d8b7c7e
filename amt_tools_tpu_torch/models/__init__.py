"""Transcription models: base class, output heads, Onsets & Frames v1/v2
and TabCNN."""

from .common import TranscriptionModel, SoftmaxGroups, LogisticBank
from .onsetsframes import (AcousticModel, LanguageModel, OnsetsFrames,
                           OnsetsFrames2)
from .tabcnn import TabCNN

__all__ = ['TranscriptionModel', 'SoftmaxGroups', 'LogisticBank',
           'AcousticModel', 'LanguageModel', 'OnsetsFrames', 'OnsetsFrames2',
           'TabCNN']
