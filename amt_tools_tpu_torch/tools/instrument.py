"""Instrument profiles: the mapping from MIDI pitch to activation-map rows.

Copy of the parts of ``amt_tools_tpu/tools/instrument.py`` the piano and
guitar serving paths need: ``note_to_midi`` (``:33``), ``midi_to_note``
(``:54``), ``midi_to_hz``, ``hz_to_midi`` (``:71``), ``PianoProfile``,
``TablatureProfile`` (``:112``) and ``GuitarProfile`` (``:163``).
"""

import re

import numpy as np

from . import constants

__all__ = [
    'note_to_midi',
    'midi_to_note',
    'midi_to_hz',
    'hz_to_midi',
    'InstrumentProfile',
    'PianoProfile',
    'TablatureProfile',
    'GuitarProfile',
]

# Semitone offsets within an octave for each natural note name
_PITCH_CLASSES = {'C': 0, 'D': 2, 'E': 4, 'F': 5, 'G': 7, 'A': 9, 'B': 11}
_ACCIDENTALS = {'#': 1, '♯': 1, 's': 1, 'b': -1, '♭': -1, '!': -1, '': 0}

_NOTE_RE = re.compile(r'^(?P<note>[A-Ga-g])(?P<accidental>[#♯sb♭!]*)(?P<octave>[+-]?\d+)?$')


def note_to_midi(note):
    """Convert a spelled note (e.g. ``'A4'``, ``'E2'``, ``'F#3'``) to MIDI pitch.

    Uses the convention C4 = 60 (i.e. MIDI = 12 * (octave + 1) + pitch class).
    Accepts a single string or an iterable of strings.
    """

    if not isinstance(note, str):
        return np.array([note_to_midi(n) for n in note])

    match = _NOTE_RE.match(note.strip())
    if match is None:
        raise ValueError(f'Cannot parse note name: {note!r}')

    pitch_class = _PITCH_CLASSES[match.group('note').upper()]
    offset = sum(_ACCIDENTALS[a] for a in match.group('accidental'))
    octave = int(match.group('octave')) if match.group('octave') else 0

    return 12 * (octave + 1) + pitch_class + offset


def midi_to_note(midi):
    """Convert MIDI pitch number(s) to spelled note name(s) (sharps)."""

    if not np.isscalar(midi):
        return [midi_to_note(m) for m in np.asarray(midi).flatten()]

    names = ['C', 'C#', 'D', 'D#', 'E', 'F', 'F#', 'G', 'G#', 'A', 'A#', 'B']
    midi = int(round(midi))
    return f'{names[midi % 12]}{midi // 12 - 1}'


def midi_to_hz(midi):
    """Convert MIDI pitch (possibly fractional) to frequency in Hz (A4=440)."""

    return 440.0 * (2.0 ** ((np.asarray(midi, dtype=np.float64) - 69) / 12))



def hz_to_midi(hz):
    """Convert frequency in Hz to (fractional) MIDI pitch (A4=440)."""

    return 12 * (np.log2(np.asarray(hz, dtype=np.float64)) - np.log2(440.0)) + 69

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


class TablatureProfile(InstrumentProfile):
    """Profile for instruments with multiple degrees of freedom (strings)."""

    def __init__(self, tuning, num_pitches):
        self.tuning = tuning
        self.num_pitches = num_pitches

        midi_tuning = self.get_midi_tuning()

        low, high = midi_tuning[0], midi_tuning[-1] - 1 + self.num_pitches

        super().__init__(low, high)

    def get_num_dofs(self):
        """Number of degrees of freedom (entries in the tuning)."""

        return len(self.tuning)

    def get_midi_tuning(self):
        """MIDI pitch of the lowest note playable on each degree of freedom."""

        return np.array([note_to_midi(n) for n in self.tuning])


class GuitarProfile(TablatureProfile):
    """Standard-tuning guitar profile (EADGBe, 19 frets by default)."""

    def __init__(self, tuning=None, num_frets=None):
        if tuning is None:
            tuning = constants.DEFAULT_GUITAR_TUNING
        if num_frets is None:
            num_frets = constants.DEFAULT_GUITAR_NUM_FRETS

        # Plus one for the open string
        super().__init__(tuning, num_frets + 1)

    def get_num_frets(self):
        """Number of frets supported by this profile."""

        return self.num_pitches - 1
