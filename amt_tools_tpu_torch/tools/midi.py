"""Native Standard MIDI File reader and writer (host numpy, no mido).

Copy of ``amt_tools_tpu/tools/midi.py``: ``parse_midi_events`` (``:100``;
format 0 and 1, running status, tempo changes, SMPTE division),
``load_notes_midi`` (``:173``; note on/off pairing with the sustain pedal,
CC64: a note released while the pedal is down is held until the pedal lifts
or the same pitch is struck again) and ``write_notes_midi`` (``:251``;
format 0 on a tick grid). The notes and the files are the JAX package's,
bit for bit and byte for byte.
"""

import struct

import numpy as np

__all__ = [
    'parse_midi_events',
    'load_notes_midi',
    'write_notes_midi',
]

_DEFAULT_TEMPO = 500000  # microseconds per quarter note (120 bpm)


def _read_vlq(data, pos):
    """Read a MIDI variable-length quantity; returns (value, new_pos)."""

    value = 0
    while True:
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def _parse_track(data):
    """Parse one MTrk chunk body into a list of (abs_tick, event_dict)."""

    events = []
    pos = 0
    tick = 0
    running_status = None

    while pos < len(data):
        delta, pos = _read_vlq(data, pos)
        tick += delta

        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running_status = status
        else:
            # Running status: reuse the previous channel-message status byte
            if running_status is None:
                raise ValueError('MIDI running status without prior status byte')
            status = running_status

        if status == 0xFF:
            # Meta event
            meta_type = data[pos]
            pos += 1
            length, pos = _read_vlq(data, pos)
            payload = data[pos: pos + length]
            pos += length
            if meta_type == 0x51 and length == 3:
                tempo = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                events.append((tick, {'type': 'set_tempo', 'tempo': tempo}))
            elif meta_type == 0x2F:
                events.append((tick, {'type': 'end_of_track'}))
        elif status in (0xF0, 0xF7):
            # SysEx event
            length, pos = _read_vlq(data, pos)
            pos += length
        else:
            kind = status & 0xF0
            channel = status & 0x0F
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                d1, d2 = data[pos], data[pos + 1]
                pos += 2
                if kind == 0x90:
                    events.append((tick, {'type': 'note_on', 'note': d1,
                                          'velocity': d2, 'channel': channel}))
                elif kind == 0x80:
                    events.append((tick, {'type': 'note_off', 'note': d1,
                                          'velocity': d2, 'channel': channel}))
                elif kind == 0xB0:
                    events.append((tick, {'type': 'control_change', 'control': d1,
                                          'value': d2, 'channel': channel}))
            elif kind in (0xC0, 0xD0):
                pos += 1

    return events


def parse_midi_events(midi_path):
    """Parse a MIDI file into a time-ordered list of events with seconds.

    Returns a list of dicts with at least ``time`` (seconds) and ``type``
    (``note_on``/``note_off``/``control_change``/``set_tempo``); note events
    carry ``note`` and ``velocity``, control changes carry ``control`` and
    ``value``.
    """

    with open(midi_path, 'rb') as midi_file:
        data = midi_file.read()

    if data[:4] != b'MThd':
        raise ValueError(f'Not a MIDI file: {midi_path}')

    header_len = struct.unpack('>I', data[4:8])[0]
    _format, num_tracks, division = struct.unpack('>HHH', data[8:14])

    if division & 0x8000:
        # SMPTE time division: upper byte is the negative frame rate in
        # two's complement (-24/-25/-29/-30; -29 means 30 drop-frame =
        # 29.97 fps), lower byte is ticks per frame. Timing is absolute —
        # tempo meta events do not affect it.
        fps = 256 - (division >> 8)
        if fps == 29:
            fps = 29.97
        ticks_per_frame = division & 0xFF
        if ticks_per_frame == 0:
            raise ValueError(f'Malformed SMPTE time division '
                             f'0x{division:04x}: zero ticks per frame')
        seconds_per_tick = 1.0 / (fps * ticks_per_frame)
        ticks_per_beat = None
    else:
        ticks_per_beat = division
        seconds_per_tick = None

    # Collect (abs_tick, track_order, event) from every track chunk
    merged = []
    pos = 8 + header_len
    for _ in range(num_tracks):
        if data[pos: pos + 4] != b'MTrk':
            raise ValueError('Malformed MIDI file: expected MTrk chunk')
        length = struct.unpack('>I', data[pos + 4: pos + 8])[0]
        track_events = _parse_track(data[pos + 8: pos + 8 + length])
        merged.extend(track_events)
        pos += 8 + length

    # Stable sort by absolute tick merges tracks the way mido's iterator does
    merged.sort(key=lambda e: e[0])

    # Convert ticks to seconds: tempo map in stream order for PPQ division,
    # fixed tick duration for SMPTE division
    events = []
    tempo = _DEFAULT_TEMPO
    last_tick, last_time = 0, 0.0
    for tick, event in merged:
        if seconds_per_tick is not None:
            last_time += (tick - last_tick) * seconds_per_tick
        else:
            last_time += (tick - last_tick) * tempo / (ticks_per_beat * 1e6)
        last_tick = tick
        if event['type'] == 'set_tempo':
            tempo = event['tempo']
            continue
        if event['type'] == 'end_of_track':
            continue
        event = dict(event)
        event['time'] = last_time
        events.append(event)

    return events


def load_notes_midi(midi_path, sustain_control=64):
    """Extract notes (with sustain-pedal handling) from a MIDI file.

    Returns an (N x 4) array of rows ``[onset_sec, offset_sec, pitch, velocity]``
    in the order of their onsets' events.
    """

    raw_events = parse_midi_events(midi_path)

    # Build the flat event list the pairing algorithm operates on: note events
    # (with the sustain state at their time) and sustain on/off transitions
    events = []
    sustain_status = False
    for message in raw_events:
        if message['type'] == 'control_change' and message['control'] == sustain_control:
            sustain_on = message['value'] >= 64
            if sustain_on != sustain_status:
                sustain_status = sustain_on
                events.append({'time': message['time'],
                               'type': 'sustain_on' if sustain_on else 'sustain_off',
                               'note': None, 'velocity': 0, 'sustain': sustain_status})
        elif message['type'] in ('note_on', 'note_off'):
            velocity = message['velocity'] if message['type'] == 'note_on' else 0
            events.append({'time': message['time'], 'type': 'note',
                           'note': message['note'], 'velocity': velocity,
                           'sustain': sustain_status})

    num_events = len(events)
    if num_events == 0:
        return np.empty((0, 4))

    # Backward pass: for each event, index of the next note event with the
    # same pitch, and of the next sustain-off event (num_events if none)
    next_same_pitch = np.full(num_events, num_events, dtype=int)
    next_sustain_off = np.full(num_events + 1, num_events, dtype=int)
    last_seen = {}
    for i in range(num_events - 1, -1, -1):
        event = events[i]
        next_sustain_off[i] = i if event['type'] == 'sustain_off' else next_sustain_off[i + 1]
        if event['note'] is not None:
            next_same_pitch[i] = last_seen.get(event['note'], num_events)
            last_seen[event['note']] = i

    def _clip(idx):
        # With no match, the very last event ends the note
        return idx if idx < num_events else num_events - 1

    notes = []
    for i, onset in enumerate(events):
        if onset['velocity'] == 0:
            continue

        off_idx = _clip(next_same_pitch[i])
        offset = events[off_idx]

        # Extend through the sustain pedal: hold until pedal release or re-strike
        if offset.get('sustain', False) and off_idx != num_events - 1:
            ext_idx = _clip(min(next_sustain_off[off_idx + 1], next_same_pitch[off_idx]))
            offset = events[ext_idx]

        notes.append([onset['time'], offset['time'], onset['note'], onset['velocity']])

    return np.array(notes, dtype=np.float64) if notes else np.empty((0, 4))


def _write_vlq(value):
    """Encode a MIDI variable-length quantity."""

    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7

    return bytes(reversed(out))


def write_notes_midi(path, batched_notes, velocities=None,
                     ticks_per_beat=480, tempo=_DEFAULT_TEMPO):
    """Write (N, 3) batched notes [onset, offset, pitch] as a format-0 SMF.

    Round-trips with :func:`load_notes_midi`:
    times quantize to the tick grid (``tempo / 1e6 / ticks_per_beat`` seconds
    — ~1 ms at the defaults). ``velocities``: per-note MIDI velocities
    (1-127, default 64). Builds MAPS- and MAESTRO-layout corpora from
    synthesized tracks.
    """

    batched_notes = np.asarray(batched_notes, dtype=np.float64)
    count = batched_notes.shape[0]

    if velocities is None:
        velocities = np.full(count, 64, dtype=int)
    velocities = np.clip(np.asarray(velocities, dtype=int), 1, 127)

    sec_per_tick = tempo / 1e6 / ticks_per_beat

    # (tick, order, status, pitch, velocity): offs sort before ons at a tick
    # so a re-struck pitch re-pairs correctly
    messages = []
    for n in range(count):
        onset, offset, pitch = batched_notes[n]
        pitch = int(round(pitch))
        on_tick = int(round(onset / sec_per_tick))
        off_tick = max(int(round(offset / sec_per_tick)), on_tick + 1)
        messages.append((on_tick, 1, 0x90, pitch, int(velocities[n])))
        messages.append((off_tick, 0, 0x80, pitch, 0))

    messages.sort()

    body = _write_vlq(0) + b'\xff\x51\x03' + struct.pack('>I', tempo)[1:]
    prev_tick = 0
    for tick, _, status, pitch, velocity in messages:
        body += _write_vlq(tick - prev_tick) + bytes([status, pitch, velocity])
        prev_tick = tick
    body += _write_vlq(0) + b'\xff\x2f\x00'

    header = b'MThd' + struct.pack('>IHHH', 6, 0, 1, ticks_per_beat)
    chunk = b'MTrk' + struct.pack('>I', len(body)) + body

    import os
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)

    with open(path, 'wb') as f:
        f.write(header + chunk)
