"""Track-dictionary keys and instrument defaults used on the serving paths.

The same strings as ``amt_tools_tpu/tools/constants.py``, so batches and
outputs carry interchangeable keys in both packages.
"""

__all__ = [
    'KEY_FEATS',
    'KEY_MULTIPITCH',
    'KEY_ONSETS',
    'KEY_OFFSETS',
    'KEY_TIMES',
    'KEY_OUTPUT',
    'KEY_TABLATURE',
    'DEFAULT_PIANO_LOWEST_PITCH',
    'DEFAULT_PIANO_HIGHEST_PITCH',
    'DEFAULT_GUITAR_TUNING',
    'DEFAULT_GUITAR_NUM_FRETS',
]

KEY_FEATS = 'features'
KEY_MULTIPITCH = 'multi_pitch'
KEY_ONSETS = 'onsets'
KEY_OFFSETS = 'offsets'
KEY_TIMES = 'times'
KEY_OUTPUT = 'model_output'
KEY_TABLATURE = 'tablature'

DEFAULT_PIANO_LOWEST_PITCH = 21
DEFAULT_PIANO_HIGHEST_PITCH = 108

DEFAULT_GUITAR_TUNING = ['E2', 'A2', 'D3', 'G3', 'B3', 'E4']
DEFAULT_GUITAR_NUM_FRETS = 19
