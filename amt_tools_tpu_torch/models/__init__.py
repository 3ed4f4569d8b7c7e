"""Transcription models: base class, output heads, ``run_on_batch``,
Onsets & Frames v1/v2 and TabCNN."""

from .common import TranscriptionModel, SoftmaxGroups, LogisticBank, run_on_batch
from .onsetsframes import (AcousticModel, LanguageModel, OnsetsFrames,
                           OnsetsFrames2)
from .tabcnn import TabCNN

__all__ = ['TranscriptionModel', 'SoftmaxGroups', 'LogisticBank', 'run_on_batch',
           'AcousticModel', 'LanguageModel', 'OnsetsFrames', 'OnsetsFrames2',
           'TabCNN']
