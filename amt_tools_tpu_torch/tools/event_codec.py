"""The token vocabulary of MT3's piano transcriber (Hawthorne, Simon,
Swavely, Manilow and Engel, Sequence-to-Sequence Piano Transcription with
Transformers, ISMIR 2021, arXiv:2107.09142; ``magenta/mt3``
``vocabularies.py``, ``event_codec.py``, ``run_length_encoding.py``
``decode_events`` and ``note_sequences.py`` ``decode_note_event``), and
the decode of generated tokens to notes on the host.

The JAX package has no counterpart. Ids 0, 1 and 2 are PAD, EOS and UNK;
id ``3 + e`` is the codec's event ``e``: 1,001 shifts of 10 ms (0 to 10
s), 128 pitches, 128 velocities (0 marks an offset), the tie, 128 programs
and 128 drums, 1,514 events in all. The model's 1,536 embeddings round
1,517 up to a multiple of 128.

:func:`decode_rows` decodes each row (one segment's tokens) on its own,
from the segment's start time, by these rules, vectorized over the rows:

- the row ends at its first EOS; PAD, UNK and ids past the codec are
  invalid;
- shift tokens set the segment's clock: a run of shifts adds its 10 ms
  steps to the segment's start, and the first event after the run starts
  the next run's count from the start again (MT3's run-length shifts are
  times within the segment);
- a shift past the segment's end drops it and the rest of the row;
- an event earlier than the latest event before it is invalid;
- a velocity token sets the velocity state (100 until one comes); a pitch
  token at velocity 0 closes that pitch's open note (invalid if none is
  open), at another velocity opens a note, closing the pitch's open note
  there first;
- the tie, program and drum events fit no piano rule and are invalid;
- a note still open at the end of the row is closed at the segment's end;
  a note lasts at least 10 ms.

Every invalid or dropped token is counted and skipped.
"""

import numpy as np

__all__ = ['PAD', 'EOS', 'UNK', 'NUM_SPECIAL', 'STEPS_PER_SECOND',
           'MAX_SHIFT_STEPS', 'EVENT_RANGES', 'NUM_EVENTS', 'VOCAB_USED',
           'DEFAULT_VELOCITY', 'MIN_NOTE_DURATION', 'token', 'decode_rows']

PAD, EOS, UNK = 0, 1, 2
NUM_SPECIAL = 3
STEPS_PER_SECOND = 100
MAX_SHIFT_STEPS = 1000

# Event type -> (first event id, number of values), in the codec's order
EVENT_RANGES = {}
_first = 0
for _name, _size in (('shift', MAX_SHIFT_STEPS + 1), ('pitch', 128),
                     ('velocity', 128), ('tie', 1), ('program', 128),
                     ('drum', 128)):
    EVENT_RANGES[_name] = (_first, _size)
    _first += _size
NUM_EVENTS = _first
VOCAB_USED = NUM_SPECIAL + NUM_EVENTS

DEFAULT_VELOCITY = 100
MIN_NOTE_DURATION = 0.01


def token(kind, value):
    """The id of the event ``kind`` (a key of :data:`EVENT_RANGES`) of
    ``value``."""

    first, size = EVENT_RANGES[kind]
    if not 0 <= value < size:
        raise ValueError(f'{kind} takes values 0 to {size - 1}, got {value}')

    return NUM_SPECIAL + first + value


def _in(events, kind):
    first, size = EVENT_RANGES[kind]

    return (events >= first) & (events < first + size)


def _last_index(mask):
    """(R, L): for each position, the index of the latest True at or
    before it in its row, else -1."""

    index = np.where(mask, np.arange(mask.shape[1]), -1)

    return np.maximum.accumulate(index, axis=1)


def decode_rows(tokens, starts, seconds):
    """Rows of generated tokens -> their notes, by the module docstring's
    rules.

    ``tokens``: (R, L) integer ids, a row a segment; ``starts``: (R,) each
    segment's start in seconds; ``seconds``: a segment's length. Returns
    ``(rows, pitches, onsets, offsets, velocities)``, one entry a note in
    the order of the notes' onset tokens within each row (the row of each
    note, its MIDI pitch, onset and offset in seconds, velocity), and the
    count of invalid and dropped tokens."""

    tokens = np.asarray(tokens, dtype=np.int32)
    starts = np.asarray(starts, dtype=np.float64)
    count, length = tokens.shape
    position = np.arange(length, dtype=np.int32)
    eos = tokens == EOS
    ends = np.where(eos.any(axis=1), eos.argmax(axis=1), length)
    live = position < ends[:, None]
    events = tokens - NUM_SPECIAL
    known = live & (events >= 0) & (events < NUM_EVENTS)
    invalid = int(np.sum(live & ~known))

    # The clock: each shift's run total since the last event, as a time
    shift = known & _in(events, 'shift')
    event = known & ~shift
    total = np.cumsum(np.where(shift, events, 0), axis=1, dtype=np.int32)
    # The total at the latest event: the running total never falls
    base = np.maximum.accumulate(np.where(event, total, 0), axis=1)
    shift_time = starts[:, None] + (total - base) / STEPS_PER_SECOND

    # A shift past the segment's end drops itself and the rest of the row
    late = shift & (shift_time > (starts + seconds)[:, None])
    cut = np.where(late.any(axis=1), late.argmax(axis=1), length)
    kept = position < cut[:, None]
    # (the dropped ids that are not events were counted above)
    invalid += int(np.sum(live & ~kept & known))
    event &= kept

    # Each event's time: its latest shift's, else the segment's start
    last_shift = _last_index(shift & kept)
    time = np.where(last_shift >= 0,
                    np.take_along_axis(shift_time, np.maximum(last_shift, 0),
                                       1),
                    starts[:, None])
    # Earlier than the latest event before it: invalid
    event_time = np.where(event, time, -np.inf)
    latest = np.maximum.accumulate(event_time, axis=1)
    before = np.concatenate([np.full((count, 1), -np.inf), latest[:, :-1]],
                            axis=1)
    timely = event & (time >= np.maximum(before, starts[:, None]))
    invalid += int(np.sum(event & ~timely))

    pitch = timely & _in(events, 'pitch')
    velocity = timely & _in(events, 'velocity')
    invalid += int(np.sum(timely & ~pitch & ~velocity))
    first_velocity = EVENT_RANGES['velocity'][0]
    last_velocity = _last_index(velocity)
    level = np.where(last_velocity >= 0,
                     np.take_along_axis(events, np.maximum(last_velocity, 0),
                                        1) - first_velocity,
                     DEFAULT_VELOCITY)

    # The pitch events of each (row, pitch), in order
    row_of, at = np.nonzero(pitch)
    key = events[row_of, at] - EVENT_RANGES['pitch'][0]
    order = np.lexsort((at, key, row_of))
    row_of, at, key = row_of[order], at[order], key[order]
    when = time[row_of, at]
    onset = level[row_of, at] > 0
    same = np.zeros(len(key), dtype=bool)
    same[1:] = (row_of[1:] == row_of[:-1]) & (key[1:] == key[:-1])
    # An offset closes the note the group's previous event opened
    opened = np.zeros(len(key), dtype=bool)
    opened[1:] = same[1:] & onset[:-1]
    invalid += int(np.sum(~onset & ~opened))

    # Each onset's note ends at its group's next event, else at the
    # segment's end
    closer = np.zeros(len(key), dtype=bool)
    closer[:-1] = same[1:]
    end = np.where(closer, np.append(when[1:], 0.0),
                   (starts + seconds)[row_of])
    notes = np.nonzero(onset)[0]
    notes = notes[np.lexsort((at[notes], row_of[notes]))]
    onsets = when[notes]

    return (row_of[notes], key[notes], onsets,
            np.maximum(end[notes], onsets + MIN_NOTE_DURATION),
            level[row_of[notes], at[notes]], invalid)
