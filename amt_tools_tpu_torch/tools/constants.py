"""Track-dictionary keys, paths, file names and instrument defaults.

The same strings as ``amt_tools_tpu/tools/constants.py``, so batches,
outputs and losses carry interchangeable keys in both packages. The default
directories are the JAX package's too (``:16-49``): both are rooted at the
repository, so one feature and ground-truth cache serves both packages, and
``AMT_TOOLS_TPU_GENERATED_DIR`` moves it for both.
"""

import os

__all__ = [
    'TOOL_DIR',
    'ROOT_DIR',
    'HOME',
    'DEFAULT_DATASETS_DIR',
    'DEFAULT_GENERATED_DIR',
    'GROUND_TRUTH_DIR',
    'DEFAULT_FEATURES_GT_DIR',
    'DEFAULT_EXPERIMENTS_DIR',
    'DEFAULT_VISUALIZATION_DIR',
    'WAV_EXT',
    'MID_EXT',
    'MIDI_EXT',
    'JAMS_EXT',
    'NPZ_EXT',
    'CSV_EXT',
    'JAMS_NOTE_MIDI',
    'JAMS_PITCH_HZ',
    'JAMS_STRING_IDX',
    'JAMS_METADATA',
    'MIDI_NOTE_ON',
    'MIDI_NOTE_OFF',
    'MIDI_SUSTAIN_ON',
    'MIDI_SUSTAIN_OFF',
    'MIDI_SUSTAIN_CONTROL_NUM',
    'MIDI_CONTROL_CHANGE',
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
    'UINT',
    'INT',
    'INT64',
    'FLOAT',
    'FLOAT32',
    'FLOAT64',
    'BFLOAT16',
    'OPT_STATE',
    'KEY_LOSS_TABS',
    'KEY_LOSS_KLD',
    'KEY_LOSS_INH',
    'KEY_LOSS_REC',
    'DEFAULT_PIANO_LOWEST_PITCH',
    'DEFAULT_PIANO_HIGHEST_PITCH',
    'DEFAULT_GUITAR_LABELS',
    'DEFAULT_GUITAR_TUNING',
    'DEFAULT_GUITAR_NUM_FRETS',
]

# This package's tools directory, and the repository root above the
# package: this file is <root>/amt_tools_tpu_torch/tools/
TOOL_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT_DIR = os.path.dirname(os.path.dirname(TOOL_DIR))

HOME = os.path.expanduser('~')

DEFAULT_DATASETS_DIR = os.path.join(HOME, 'Desktop', 'Datasets')

DEFAULT_GENERATED_DIR = os.path.abspath(
    os.environ.get('AMT_TOOLS_TPU_GENERATED_DIR',
                   os.path.join(ROOT_DIR, 'generated')))
GROUND_TRUTH_DIR = 'ground_truth'

DEFAULT_FEATURES_GT_DIR = os.path.join(DEFAULT_GENERATED_DIR, 'data')
DEFAULT_EXPERIMENTS_DIR = os.path.join(DEFAULT_GENERATED_DIR, 'experiments')
DEFAULT_VISUALIZATION_DIR = os.path.join(DEFAULT_GENERATED_DIR,
                                         'visualization')

WAV_EXT = 'wav'
MID_EXT = 'mid'    # MAPS
MIDI_EXT = 'midi'  # MAESTRO
JAMS_EXT = 'jams'
NPZ_EXT = 'npz'
CSV_EXT = 'csv'

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
KEY_LOSS_TABS = 'loss_tabs'
KEY_LOSS_KLD = 'loss_kld'
KEY_LOSS_INH = 'loss_inhib'
KEY_LOSS_REC = 'loss_recon'

JAMS_NOTE_MIDI = 'note_midi'
JAMS_PITCH_HZ = 'pitch_contour'
JAMS_STRING_IDX = 'data_source'
JAMS_METADATA = 'file_metadata'

MIDI_NOTE_ON = 'note_on'
MIDI_NOTE_OFF = 'note_off'
MIDI_SUSTAIN_ON = 'sustain_on'
MIDI_SUSTAIN_OFF = 'sustain_off'
MIDI_SUSTAIN_CONTROL_NUM = 64
MIDI_CONTROL_CHANGE = 'control_change'

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
OPT_STATE = 'opt-state'
CKPT_EXT = 'ckpt'
TXT_EXT = 'txt'

UINT = 'uint'
INT = 'int'
INT64 = 'int64'
FLOAT = 'float'
FLOAT32 = 'float32'
FLOAT64 = 'float64'
BFLOAT16 = 'bfloat16'

DEFAULT_PIANO_LOWEST_PITCH = 21
DEFAULT_PIANO_HIGHEST_PITCH = 108

DEFAULT_GUITAR_LABELS = ['E', 'A', 'D', 'G', 'B', 'e']
DEFAULT_GUITAR_TUNING = ['E2', 'A2', 'D3', 'G3', 'B3', 'E4']
DEFAULT_GUITAR_NUM_FRETS = 19
