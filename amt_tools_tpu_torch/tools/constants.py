"""Track-dictionary keys, file names and instrument defaults.

The same strings as ``amt_tools_tpu/tools/constants.py``, so batches,
outputs and losses carry interchangeable keys in both packages.
"""

__all__ = [
    'KEY_TRACK',
    'KEY_AUDIO',
    'KEY_FS',
    'KEY_HOP',
    'KEY_FEATS',
    'KEY_MULTIPITCH',
    'KEY_PITCHLIST',
    'KEY_ONSETS',
    'KEY_OFFSETS',
    'KEY_TIMES',
    'KEY_NOTES',
    'KEY_VELOCITY',
    'KEY_OUTPUT',
    'KEY_TABLATURE',
    'KEY_NOTE_VELOCITY',
    'KEY_ACCURACY',
    'KEY_VALID_FRAMES',
    'KEY_LOSS',
    'KEY_LOSS_TOTAL',
    'KEY_LOSS_ONSETS',
    'KEY_LOSS_OFFSETS',
    'KEY_LOSS_PITCH',
    'KEY_LOSS_VELOCITY',
    'TRAIN',
    'VAL',
    'TEST',
    'KEY_PRECISION',
    'KEY_RECALL',
    'KEY_F1',
    'KEY_NOTE_ON',
    'KEY_NOTE_OFF',
    'KEY_TDR',
    'MODEL_STATE',
    'CKPT_EXT',
    'TXT_EXT',
    'FLOAT',
    'FLOAT32',
    'DEFAULT_PIANO_LOWEST_PITCH',
    'DEFAULT_PIANO_HIGHEST_PITCH',
    'DEFAULT_GUITAR_TUNING',
    'DEFAULT_GUITAR_NUM_FRETS',
]

KEY_TRACK = 'track'
KEY_AUDIO = 'audio'
KEY_FS = 'fs'
KEY_HOP = 'hop_length'
KEY_FEATS = 'features'
KEY_MULTIPITCH = 'multi_pitch'
KEY_PITCHLIST = 'pitch_list'
KEY_ONSETS = 'onsets'
KEY_OFFSETS = 'offsets'
KEY_TIMES = 'times'
KEY_NOTES = 'notes'
KEY_VELOCITY = 'velocity'
KEY_OUTPUT = 'model_output'
KEY_TABLATURE = 'tablature'
KEY_NOTE_VELOCITY = 'note_velocity'
KEY_ACCURACY = 'accuracy'
KEY_VALID_FRAMES = 'valid_frames'  # bucketed evaluation: real frames a row

KEY_LOSS = 'loss'
KEY_LOSS_TOTAL = 'loss_total'
KEY_LOSS_ONSETS = 'loss_onsets'
KEY_LOSS_OFFSETS = 'loss_offsets'
KEY_LOSS_PITCH = 'loss_pitch'
KEY_LOSS_VELOCITY = 'loss_velocity'

TRAIN = 'train'
VAL = 'validation'
TEST = 'test'

KEY_PRECISION = 'precision'
KEY_RECALL = 'recall'
KEY_F1 = 'f1-score'

KEY_NOTE_ON = 'note-on'
KEY_NOTE_OFF = 'note-off'

KEY_TDR = 'tdr'

# Checkpoints are <MODEL_STATE>-<iteration>.<CKPT_EXT>
MODEL_STATE = 'model'
CKPT_EXT = 'ckpt'
TXT_EXT = 'txt'

FLOAT = 'float'
FLOAT32 = 'float32'

DEFAULT_PIANO_LOWEST_PITCH = 21
DEFAULT_PIANO_HIGHEST_PITCH = 108

DEFAULT_GUITAR_TUNING = ['E2', 'A2', 'D3', 'G3', 'B3', 'E4']
DEFAULT_GUITAR_NUM_FRETS = 19
