"""Native JAMS (JSON Annotated Music Specification) reader and writer.

Copy of ``amt_tools_tpu/tools/jams_io.py``, every name of its ``__all__``:
the per-string ``note_midi`` and ``pitch_contour`` readers, the
nearest-observation ``resample_multipitch`` and the ``note_midi`` writer,
plain JSON without the ``jams`` package. The files written are the JAX
package's byte for byte.
"""

import json

import numpy as np

from . import constants, utils

__all__ = [
    'load_jams',
    'extract_duration_jams',
    'load_duration_jams',
    'extract_stacked_notes_jams',
    'load_stacked_notes_jams',
    'extract_notes_jams',
    'load_notes_jams',
    'extract_stacked_pitch_list_jams',
    'load_stacked_pitch_list_jams',
    'extract_pitch_list_jams',
    'load_pitch_list_jams',
    'resample_multipitch',
    'write_stacked_notes_jams',
]


def load_jams(jams_path):
    """Load a JAMS file as a plain (dict) JSON object."""

    with open(jams_path, 'r') as jams_file:
        return json.load(jams_file)


def _annotations_by_namespace(jam, namespace):
    """All annotations in a JAMS dict matching the given namespace."""

    return [a for a in jam.get('annotations', []) if a.get('namespace') == namespace]


def _string_label(annotation):
    """The per-string label stored in an annotation's metadata data_source."""

    return annotation.get('annotation_metadata', {}).get(constants.JAMS_STRING_IDX)


def extract_duration_jams(jam):
    """Duration (seconds) of the audio associated with the annotations."""

    return jam.get(constants.JAMS_METADATA, {}).get('duration')


def load_duration_jams(jams_path):
    """Load a JAMS file and extract the audio duration."""

    return extract_duration_jams(load_jams(jams_path))


def extract_stacked_notes_jams(jam):
    """Extract per-string MIDI notes into a stacked-notes dict.

    Slice keys are the per-annotation string labels (``data_source``).
    """

    stacked_notes = {}

    for slice_notes in _annotations_by_namespace(jam, constants.JAMS_NOTE_MIDI):
        string = _string_label(slice_notes)

        pitches, intervals = [], []
        for note in slice_notes.get('data', []):
            pitches.append(note['value'])
            intervals.append([note['time'], note['time'] + note['duration']])

        pitches = np.array(pitches) if pitches else np.empty(0)
        intervals = np.array(intervals) if intervals else np.empty((0, 2))

        stacked_notes.update(utils.notes_to_stacked_notes(pitches, intervals, string))

    return stacked_notes


def load_stacked_notes_jams(jams_path):
    """Load a JAMS file and extract the per-string stacked notes."""

    return extract_stacked_notes_jams(load_jams(jams_path))


def extract_notes_jams(jam):
    """Extract all MIDI notes in a JAMS file as loose note groups."""

    return utils.stacked_notes_to_notes(extract_stacked_notes_jams(jam))


def load_notes_jams(jams_path):
    """Load a JAMS file and extract all notes as loose groups."""

    return extract_notes_jams(load_jams(jams_path))


def resample_multipitch(times, pitch_list, target_times):
    """Resample a ragged pitch list onto new times by nearest observation.

    Equivalent to ``mir_eval.multipitch.resample_multipitch`` — target times
    outside the observed range yield empty observations.
    """

    times = np.asarray(times)
    target_times = np.asarray(target_times)

    if not len(times):
        return [np.array([])] * len(target_times)

    # Nearest observation index for each target time
    idcs = np.searchsorted(times, target_times)
    idcs = np.clip(idcs, 0, len(times) - 1)
    prev = np.clip(idcs - 1, 0, len(times) - 1)
    use_prev = np.abs(target_times - times[prev]) <= np.abs(times[idcs] - target_times)
    nearest = np.where(use_prev, prev, idcs)

    return [np.asarray(pitch_list[i]) for i in nearest]


def extract_stacked_pitch_list_jams(jam, times=None, uniform=True):
    """Extract per-string pitch contours into a stacked pitch list.

    Zero-frequency or unvoiced observations become empty entries. With
    ``uniform``, observations are snapped onto a uniform hop grid covering the
    file duration; with ``times``, contours are resampled onto those times.
    """

    stacked_pitch_list = {}

    for slice_pitches in _annotations_by_namespace(jam, constants.JAMS_PITCH_HZ):
        string = _string_label(slice_pitches)

        entry_times, slice_pitch_list = [], []
        for pitch in slice_pitches.get('data', []):
            value = pitch['value']
            freq = np.array([value['frequency']])

            if np.sum(freq) == 0 or not value.get('voiced', True):
                freq = np.empty(0)

            entry_times.append(pitch['time'])
            slice_pitch_list.append(freq)

        entry_times = np.array(entry_times)
        entry_times, slice_pitch_list = utils.sort_pitch_list(entry_times, slice_pitch_list)

        if uniform:
            entry_times, slice_pitch_list = utils.time_series_to_uniform(
                times=entry_times,
                values=slice_pitch_list,
                duration=extract_duration_jams(jam))

        if times is not None:
            slice_pitch_list = resample_multipitch(entry_times, slice_pitch_list, times)
            entry_times = times

        stacked_pitch_list.update(
            utils.pitch_list_to_stacked_pitch_list(entry_times, slice_pitch_list, string))

    return stacked_pitch_list


def load_stacked_pitch_list_jams(jams_path, times=None, uniform=True):
    """Load a JAMS file and extract the per-string stacked pitch list."""

    return extract_stacked_pitch_list_jams(load_jams(jams_path), times, uniform)


def extract_pitch_list_jams(jam, _times=None, uniform=True):
    """Extract a single merged pitch list from JAMS annotations."""

    stacked_pitch_list = extract_stacked_pitch_list_jams(jam, _times, uniform)

    return utils.stacked_pitch_list_to_pitch_list(stacked_pitch_list)


def load_pitch_list_jams(jams_path, _times=None, uniform=True):
    """Load a JAMS file and extract a merged pitch list."""

    return extract_pitch_list_jams(load_jams(jams_path), _times, uniform)


def write_stacked_notes_jams(stacked_notes, jams_path, duration=None):
    """Write per-string stacked notes as a ``note_midi`` JAMS file."""

    if duration is None:
        # Default duration to the latest note offset
        offsets = [np.max(np.asarray(i).reshape(-1, 2)[:, 1]) if len(p) else 0.0
                   for p, i in stacked_notes.values()]
        duration = float(max(offsets)) if offsets else 0.0

    annotations = []
    for string, (pitches, intervals) in stacked_notes.items():
        intervals = np.asarray(intervals).reshape(-1, 2)
        data = [{'time': float(i[0]),
                 'duration': float(i[1] - i[0]),
                 'value': float(p),
                 'confidence': None}
                for p, i in zip(np.atleast_1d(pitches), intervals)]
        annotations.append({
            'namespace': constants.JAMS_NOTE_MIDI,
            'annotation_metadata': {constants.JAMS_STRING_IDX: str(string)},
            'data': data,
            'sandbox': {},
            'time': 0,
            'duration': duration,
        })

    jam = {
        constants.JAMS_METADATA: {'duration': duration},
        'annotations': annotations,
        'sandbox': {},
    }

    with open(jams_path, 'w') as jams_file:
        json.dump(jam, jams_file)
