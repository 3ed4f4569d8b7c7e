"""Transcription models: base class, output heads, ``run_on_batch``,
Onsets & Frames v1/v2 (with the velocity head and the fused layouts and
their converters), the streaming Onsets & Frames, TabCNN and the note
model of High-resolution Piano Transcription (``RegressCRNN``),
hFT-Transformer (``HFTransformer``) and MT3's sequence-to-sequence piano
transcriber (``Seq2SeqTranscriber``)."""

from .common import (TranscriptionModel, OutputLayer, SoftmaxGroups,
                     LogisticBank, RegressionBank, run_on_batch)
from .onsetsframes import (AcousticModel, GroupedAcousticModel,
                           LanguageModel, OnlineLanguageModel, OnsetsFrames,
                           OnsetsFrames2, OnsetsFramesOnline,
                           fuse_acoustic_variables, unfuse_acoustic_variables,
                           fuse_lm_variables, unfuse_lm_variables)
from .tabcnn import TabCNN
from .hpt import RegressCRNN
from .hft import HFTransformer
from .mt3 import Seq2SeqTranscriber

__all__ = ['TranscriptionModel', 'OutputLayer', 'SoftmaxGroups',
           'LogisticBank', 'RegressionBank', 'run_on_batch', 'AcousticModel',
           'GroupedAcousticModel', 'LanguageModel', 'OnlineLanguageModel',
           'OnsetsFrames', 'OnsetsFrames2', 'OnsetsFramesOnline', 'TabCNN',
           'fuse_acoustic_variables', 'unfuse_acoustic_variables',
           'fuse_lm_variables', 'unfuse_lm_variables', 'RegressCRNN',
           'HFTransformer', 'Seq2SeqTranscriber']
