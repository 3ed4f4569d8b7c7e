"""Transcription models: base class, output heads, ``run_on_batch``,
Onsets & Frames v1/v2 (with the velocity head), the streaming Onsets &
Frames and TabCNN."""

from .common import (TranscriptionModel, SoftmaxGroups, LogisticBank,
                     RegressionBank, run_on_batch)
from .onsetsframes import (AcousticModel, LanguageModel, OnlineLanguageModel,
                           OnsetsFrames, OnsetsFrames2, OnsetsFramesOnline)
from .tabcnn import TabCNN

__all__ = ['TranscriptionModel', 'SoftmaxGroups', 'LogisticBank',
           'RegressionBank', 'run_on_batch', 'AcousticModel',
           'LanguageModel', 'OnlineLanguageModel', 'OnsetsFrames',
           'OnsetsFrames2', 'OnsetsFramesOnline', 'TabCNN']
