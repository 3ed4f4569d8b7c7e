"""Instrument profiles: the mapping from MIDI pitch to activation-map rows.

Copy of the parts of ``amt_tools_tpu/tools/instrument.py`` the piano serving
path needs.
"""

import numpy as np

from . import constants

__all__ = [
    'midi_to_hz',
    'InstrumentProfile',
    'PianoProfile',
]


def midi_to_hz(midi):
    """Convert MIDI pitch (possibly fractional) to frequency in Hz (A4=440)."""

    return 440.0 * (2.0 ** ((np.asarray(midi, dtype=np.float64) - 69) / 12))


class InstrumentProfile(object):
    """Generic instrument profile defined by an inclusive MIDI pitch range."""

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def get_midi_range(self):
        """Ascending array of MIDI pitches playable on the instrument."""

        return np.arange(self.low, self.high + 1)

    def get_range_len(self):
        """Number of discrete pitches the instrument supports."""

        return self.high - self.low + 1


class PianoProfile(InstrumentProfile):
    """Standard 88-key piano profile (MIDI 21..108 by default)."""

    def __init__(self, low=None, high=None):
        if low is None:
            low = constants.DEFAULT_PIANO_LOWEST_PITCH
        if high is None:
            high = constants.DEFAULT_PIANO_HIGHEST_PITCH

        super().__init__(low, high)

    def get_num_dofs(self):
        """A piano has a single degree of freedom."""

        return 1
