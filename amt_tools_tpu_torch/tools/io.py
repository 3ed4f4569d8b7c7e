"""Text output of estimates and results (host side).

Copies of ``amt_tools_tpu/tools/io.py`` ``write_and_print`` (``:136``),
``write_pitch_list`` (``:160``) and ``write_notes`` (``:175``), which the
estimators' and evaluators' ``save_dir`` use; the files are byte for byte
the JAX package's. The rest of the JAX module (audio, MIDI, JAMS) is not
ported yet.
"""

import os

import numpy as np

__all__ = ['write_and_print', 'write_pitch_list', 'write_notes']


def write_and_print(file, text, verbose=True, end=''):
    """Write text to a file and optionally echo it to the console."""

    text = str(text) + end

    try:
        file.write(text)
    finally:
        if verbose:
            print(text, end='')


def write_pitch_list(times, pitches, path, places=3):
    """Write a pitch list as lines of ``frame_time pitch1 pitch2 ...``."""

    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)

    times = np.round(times, decimals=places)

    with open(path, 'w') as estim_file:
        for i in range(len(times)):
            line = f'{times[i]} {str(np.round(pitches[i], decimals=places))[1: -1]}'
            end = '' if (i + 1) == len(pitches) else '\n'
            write_and_print(estim_file, line, verbose=False, end=end)


def write_notes(pitches, intervals, path, places=3):
    """Write notes as lines of ``onset offset pitch``."""

    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)

    pitches = np.round(pitches, decimals=places)
    intervals = np.round(intervals, decimals=places)

    with open(path, 'w') as estim_file:
        for i in range(len(pitches)):
            line = f'{intervals[i][0]} {intervals[i][1]} {str(pitches[i])}'
            end = '' if (i + 1) == len(pitches) else '\n'
            write_and_print(estim_file, line, verbose=False, end=end)
