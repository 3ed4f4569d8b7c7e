"""Host helpers: notes, ground-truth maps, track dicts, device choice.

Copies of ``amt_tools_tpu/tools/utils.py`` (numpy, host side, bit for
bit): ``_is_array`` (``:101``), ``notes_to_batched_notes`` (``:113``),
``batched_notes_to_notes`` (``:126``), ``sort_notes`` (``:149``),
``slice_batched_notes`` (``:207``), ``filter_notes`` (``:254``),
``notes_to_multi_pitch`` (``:622``), ``notes_to_velocity`` (``:669``),
``notes_to_onsets`` (``:987``), ``notes_to_offsets`` (``:1037``),
``rms_norm`` (``:1086``), ``estimate_hop_length`` (``:1239``),
``dict_to_dtype`` (``:1348``), ``query_dict`` (``:1467``) and
``slice_track`` (``:1481``). For the estimators, evaluators and inference
entry points: the notes, pitch-list, multi-pitch, tablature and onset/offset
conversions (``:183-1075``), ``extract_note_velocities`` (``:728``),
``multi_pitch_to_notes`` (``:772``), ``framify_activations`` (``:1131``),
``inhibit_activations`` (``:1161``), and the dict plumbing
(``:1367-1479``): ``dict_to_array`` brings tensors (any device, bf16 as
float32) to host numpy, ``dict_to_tensor`` takes the place of
``dict_to_jax`` with a ``device``. For ``SyntheticGuitar`` and the feature
streams: ``stacked_multi_pitch_to_tablature`` (``:903``) and
``get_current_time`` (``:1567``). For the JAMS reader and the real-audio
datasets: ``slice_pitch_list`` (``:442``), ``sort_pitch_list`` (``:609``),
``get_resample_idcs`` (``:1225``), ``time_series_to_uniform``
(``:1260``), the stacked-representation plumbing (``:1303-1325``),
``save_dict_npz`` and ``load_dict_npz`` (``:1517-1548``; the npz files
are the JAX package's, so either package reads the other's cache) and
``seed_everything`` (``:1551``, which also seeds torch).
"""

import contextlib
import os
import random
import threading
import time
import warnings
from datetime import datetime

import numpy as np
import torch

from . import constants
from .instrument import midi_to_hz

__all__ = [
    'to_numpy',
    'notes_to_batched_notes',
    'batched_notes_to_notes',
    'sort_notes',
    'slice_batched_notes',
    'filter_notes',
    'notes_to_multi_pitch',
    'notes_to_velocity',
    'notes_to_onsets',
    'notes_to_offsets',
    'rms_norm',
    'estimate_hop_length',
    'dict_to_dtype',
    'query_dict',
    'slice_track',
    'notes_to_hz',
    'notes_to_stacked_notes',
    'stacked_notes_to_notes',
    'multi_pitch_to_pitch_list',
    'pitch_list_to_hz',
    'cat_pitch_list',
    'pitch_list_to_stacked_pitch_list',
    'stacked_pitch_list_to_pitch_list',
    'stacked_multi_pitch_to_stacked_pitch_list',
    'extract_note_velocities',
    'multi_pitch_to_notes',
    'stacked_multi_pitch_to_multi_pitch',
    'multi_pitch_to_stacked_multi_pitch',
    'stacked_notes_to_stacked_multi_pitch',
    'tablature_to_stacked_multi_pitch',
    'stacked_multi_pitch_to_tablature',
    'multi_pitch_to_onsets',
    'multi_pitch_to_offsets',
    'stacked_multi_pitch_to_stacked_onsets',
    'stacked_multi_pitch_to_stacked_offsets',
    'framify_activations',
    'inhibit_activations',
    'dict_to_array',
    'dict_to_tensor',
    'dict_squeeze',
    'dict_unsqueeze',
    'dict_append',
    'unpack_dict',
    'get_tag',
    'get_current_time',
    'resolve_device',
    'use_exact_fp32',
    'exact_fp32',
    'slice_pitch_list',
    'get_active_pitch_count',
    'unroll_pitch_list',
    'slice_stacked_pitch_list',
    'cat_stacked_pitch_list',
    'sort_pitch_list',
    'get_resample_idcs',
    'time_series_to_uniform',
    'apply_func_stacked_representation',
    'pack_stacked_representation',
    'unpack_stacked_representation',
    'save_dict_npz',
    'load_dict_npz',
    'seed_everything',
]


def to_numpy(data):
    """A host ``ndarray`` of a tensor (any device; bf16 widened to
    float32) or anything array-like."""

    if isinstance(data, np.ndarray):
        return data
    if isinstance(data, torch.Tensor):
        data = data.detach()
        if data.dtype == torch.bfloat16:
            data = data.float()
        return data.cpu().numpy()

    return np.asarray(data)


def _is_array(entry):
    """True for numpy arrays and anything with shape, dtype and
    ``__array__`` (CPU tensors)."""

    return isinstance(entry, np.ndarray) or (
        hasattr(entry, 'shape') and hasattr(entry, 'dtype') and
        hasattr(entry, '__array__'))


def notes_to_batched_notes(pitches, intervals):
    """Convert loose note groups into (N, 3) rows of [onset, offset, pitch]."""

    batched_notes = np.empty([0, 3])

    if len(pitches) > 0:
        batched_notes = np.concatenate(
            (np.asarray(intervals, dtype=np.float64).reshape(-1, 2),
             np.asarray(pitches, dtype=np.float64).reshape(-1, 1)), axis=-1)

    return batched_notes


def batched_notes_to_notes(batched_notes):
    """Convert (N, 3) batched notes back into (pitches, intervals)."""

    batched_notes = np.asarray(batched_notes).reshape(-1, 3)

    return batched_notes[..., 2], batched_notes[..., :2]


def sort_notes(pitches, intervals, by=0):
    """Stable-sort loose note groups by attribute (0 onset | 1 offset | 2 pitch)."""

    batched_notes = notes_to_batched_notes(pitches, intervals)
    order = np.argsort(batched_notes[..., by], kind='stable')

    return batched_notes_to_notes(batched_notes[order])


def slice_batched_notes(batched_notes, start_time, stop_time,
                        relative_times=False):
    """Drop notes outside a time window and clip intervals to its boundaries."""

    batched_notes = np.array(batched_notes, copy=True)

    batched_notes = batched_notes[batched_notes[:, 1] > start_time]
    batched_notes = batched_notes[batched_notes[:, 0] <= stop_time]

    batched_notes[:, 0] = np.maximum(batched_notes[:, 0], start_time)
    batched_notes[:, 1] = np.minimum(batched_notes[:, 1], stop_time)

    if relative_times:
        batched_notes[:, :2] -= start_time

    return batched_notes


def filter_notes(pitches, intervals, profile=None, min_time=-np.inf,
                 max_time=np.inf, suppress_warnings=True):
    """Remove notes with out-of-range nominal pitch or fully out-of-bounds
    intervals; unless ``suppress_warnings``, warn (``RuntimeWarning``) for
    each kind of note removed."""

    pitches = np.asarray(pitches)
    intervals = np.asarray(intervals).reshape(-1, 2)

    valid = np.logical_and(intervals[:, 0] <= max_time,
                           intervals[:, 1] >= min_time)

    if profile is not None:
        pitches_r = np.round(pitches)
        in_bounds = np.logical_and(pitches_r >= profile.low,
                                   pitches_r <= profile.high)
        if np.any(~in_bounds) and not suppress_warnings:
            warnings.warn('Ignoring notes with nominal pitch exceeding '
                          'supported boundaries.', category=RuntimeWarning)
        valid = np.logical_and(valid, in_bounds)

    if np.any(~valid) and not suppress_warnings:
        warnings.warn('Ignoring notes outside specified time boundaries.',
                      category=RuntimeWarning)

    return pitches[valid], intervals[valid]


def _frame_spans(intervals, _times, num_frames, include_offsets):
    """Onset frames and exclusive end frames of each note: the last frame
    beginning at or before each event."""

    onset_frames = np.clip(
        np.searchsorted(_times, intervals[:, 0], side='right') - 1,
        0, num_frames - 1)
    offset_frames = np.clip(
        np.searchsorted(_times, intervals[:, 1], side='right') - 1,
        0, num_frames - 1)
    ends = np.maximum(offset_frames + int(include_offsets), onset_frames + 1)

    return onset_frames, ends


def notes_to_multi_pitch(pitches, intervals, times, profile,
                         include_offsets=True):
    """Rasterize loose MIDI notes into an (F, T) activation map."""

    num_pitches = profile.get_range_len()
    times = np.asarray(times)
    num_frames = len(times)

    multi_pitch = np.zeros((num_pitches, num_frames))

    if num_frames == 0:
        return multi_pitch

    # Extend times by one hop to bound note offsets
    _times = np.append(times, times[-1] + estimate_hop_length(times))

    pitches, intervals = filter_notes(pitches, intervals, profile,
                                      min_time=np.min(_times),
                                      max_time=np.max(_times))

    if len(pitches) == 0:
        return multi_pitch

    pitch_rows = np.round(pitches - profile.low).astype(int)
    onset_frames, ends = _frame_spans(intervals, _times, num_frames,
                                      include_offsets)

    # Paint activation spans via a difference array, then a cumulative sum
    diff = np.zeros((num_pitches, num_frames + 1))
    np.add.at(diff, (pitch_rows, onset_frames), 1)
    np.add.at(diff, (pitch_rows, np.minimum(ends, num_frames)), -1)

    return (np.cumsum(diff[:, :-1], axis=1) > 0).astype(float)


def notes_to_velocity(pitches, intervals, velocities, times, profile,
                      include_offsets=True, midi_scale=None):
    """Rasterize per-note velocities into an (F, T) map in [0, 1].

    Each note's span carries its velocity; overlapping same-pitch notes
    keep the louder one. ``midi_scale=True`` divides by 127, ``False``
    takes the values as they are, ``None`` infers (max > 1 -> MIDI).
    """

    num_pitches = profile.get_range_len()
    times = np.asarray(times)
    num_frames = len(times)

    velocity = np.zeros((num_pitches, num_frames))

    if num_frames == 0 or len(np.atleast_1d(pitches)) == 0:
        return velocity

    _times = np.append(times, times[-1] + estimate_hop_length(times))

    pitches = np.asarray(pitches, dtype=float)
    intervals = np.asarray(intervals).reshape(-1, 2)
    velocities = np.asarray(velocities, dtype=float).reshape(-1)
    if midi_scale is None:
        midi_scale = bool(velocities.size and velocities.max() > 1.0)
    if midi_scale:
        velocities = velocities / 127.0

    # Same validity rule as filter_notes (keep velocities aligned)
    valid = np.logical_and(intervals[:, 0] <= np.max(_times),
                           intervals[:, 1] >= np.min(_times))
    rounded = np.round(pitches)
    valid &= np.logical_and(rounded >= profile.low, rounded <= profile.high)

    pitches, intervals = pitches[valid], intervals[valid]
    velocities = velocities[valid]
    if len(pitches) == 0:
        return velocity

    pitch_rows = np.round(pitches - profile.low).astype(int)
    onset_frames, ends = _frame_spans(intervals, _times, num_frames,
                                      include_offsets)
    ends = np.minimum(ends, num_frames)

    # Loudest-wins painting, quietest notes first
    for i in np.argsort(velocities, kind='stable'):
        velocity[pitch_rows[i], onset_frames[i]: ends[i]] = velocities[i]

    return velocity


def notes_to_onsets(pitches, intervals, times, profile, ambiguity=None):
    """Rasterize note onsets into an (F, T) map; with ``ambiguity``
    (seconds) each onset spans that window, truncated at the note's end."""

    intervals = np.asarray(intervals, dtype=float).reshape(-1, 2)
    onset_times = intervals[:, :1]

    if ambiguity is not None:
        durations = np.minimum(intervals[:, 1:] - onset_times, ambiguity)
        offset_times = onset_times + durations
    else:
        offset_times = onset_times.copy()

    truncated = np.concatenate((onset_times, offset_times), axis=-1)

    return notes_to_multi_pitch(pitches, truncated, times, profile)


def notes_to_offsets(pitches, intervals, times, profile, ambiguity=None):
    """Rasterize note offsets into an (F, T) activation map."""

    intervals = np.asarray(intervals, dtype=float).reshape(-1, 2)
    offset_times = intervals[:, 1:]

    if ambiguity is not None:
        onset_times = np.maximum(offset_times - ambiguity, intervals[:, :1])
    else:
        onset_times = offset_times.copy()

    truncated = np.concatenate((onset_times, offset_times), axis=-1)

    return notes_to_multi_pitch(pitches, truncated, times, profile)


##################################################
# NOTES, PITCH LISTS, MULTI PITCH, TABLATURE     #
##################################################


def notes_to_hz(pitches):
    """Convert note pitches from MIDI to Hz."""

    return midi_to_hz(pitches)


def notes_to_stacked_notes(pitches, intervals, key=0):
    """Wrap one collection of notes into a single-slice stacked-notes dict."""

    return {key: (pitches, intervals)}


def stacked_notes_to_notes(stacked_notes, sort_by=0):
    """Collapse a stacked-notes dict into one collection of loose notes."""

    all_pitches, all_intervals = [], []
    for pitches, intervals in stacked_notes.values():
        all_pitches.append(np.asarray(pitches, dtype=np.float64))
        all_intervals.append(np.asarray(intervals, dtype=np.float64).reshape(-1, 2))

    pitches = np.concatenate(all_pitches) if all_pitches else np.empty(0)
    intervals = (np.concatenate(all_intervals, axis=0)
                 if all_intervals else np.empty((0, 2)))

    if sort_by is not None:
        pitches, intervals = sort_notes(pitches, intervals, by=sort_by)

    return pitches, intervals


def multi_pitch_to_pitch_list(multi_pitch, profile):
    """Convert an (F, T) activation map into a ragged per-frame pitch list."""

    multi_pitch = to_numpy(multi_pitch)
    num_frames = multi_pitch.shape[-1]

    # Single pass: find active (pitch, frame) pairs, then split per frame
    active_pitch, active_frame = np.where(multi_pitch > 0)
    order = np.argsort(active_frame, kind='stable')
    active_pitch, active_frame = active_pitch[order], active_frame[order]

    counts = np.bincount(active_frame, minlength=num_frames)
    splits = np.cumsum(counts)[:-1]
    per_frame = np.split((profile.low + active_pitch).astype(float), splits)

    return [np.sort(p) for p in per_frame]


def pitch_list_to_hz(pitch_list):
    """Convert all pitch observations from MIDI to Hz."""

    return [midi_to_hz(p) if len(p) else p for p in pitch_list]


def cat_pitch_list(times, pitch_list, new_times, new_pitch_list, decimals=6):
    """Concatenate two pitch lists, merging observations at coincident times."""

    times_r = np.round(times, decimals)
    new_times_r = np.round(new_times, decimals)

    merged = {t: np.asarray(p) for t, p in zip(times_r, pitch_list)}
    for t, p in zip(new_times_r, new_pitch_list):
        if t in merged:
            merged[t] = np.unique(np.append(merged[t], p))
        else:
            merged[t] = np.asarray(p)

    out_times = np.sort(np.array(list(merged.keys())))
    out_pitch_list = [merged[t] for t in out_times]

    return out_times, out_pitch_list


def slice_pitch_list(times, pitch_list, start_time, stop_time):
    """Retain pitch observations within [start_time, stop_time]."""

    valid = np.logical_and(times >= start_time, times <= stop_time)
    idcs = np.where(valid)[0]

    return times[valid], [pitch_list[i] for i in idcs]


def get_active_pitch_count(pitch_list):
    """Count pitch observations at each frame of a pitch list."""

    return np.array([len(np.atleast_1d(p)) for p in pitch_list], dtype=int)


def unroll_pitch_list(times, pitch_list):
    """Flatten a pitch list into parallel (time, pitch) observation arrays."""

    counts = get_active_pitch_count(pitch_list)
    unrolled_times = np.repeat(times, counts)
    unrolled_pitches = (np.concatenate([np.atleast_1d(p) for p in pitch_list])
                        if len(pitch_list) else np.empty(0))

    return unrolled_times, unrolled_pitches


def slice_stacked_pitch_list(stacked_pitch_list, start_time, stop_time):
    """Slice each constituent pitch list to a time window."""

    return {k: slice_pitch_list(np.asarray(t), p, start_time, stop_time)
            for k, (t, p) in stacked_pitch_list.items()}


def cat_stacked_pitch_list(stacked_pitch_list, new_stacked_pitch_list):
    """Merge two stacked pitch lists slice-by-slice."""

    merged = dict(stacked_pitch_list)
    for key, (times, pitch_list) in new_stacked_pitch_list.items():
        if key in merged:
            merged[key] = cat_pitch_list(np.asarray(merged[key][0]),
                                         merged[key][1], np.asarray(times),
                                         pitch_list)
        else:
            merged[key] = (times, pitch_list)

    return merged


def sort_pitch_list(times, pitch_list):
    """Sort a pitch list by frame time."""

    order = np.argsort(times, kind='stable')

    return np.asarray(times)[order], [pitch_list[i] for i in order]


def pitch_list_to_stacked_pitch_list(times, pitch_list, i=0):
    """Wrap a single pitch list into a stacked-pitch-list dict."""

    return {i: (times, pitch_list)}


def stacked_pitch_list_to_pitch_list(stacked_pitch_list):
    """Collapse a stacked pitch list into a single (times, pitch_list) pair."""

    out_times, out_pitch_list = np.empty(0), []
    for times, pitch_list in stacked_pitch_list.values():
        out_times, out_pitch_list = cat_pitch_list(out_times, out_pitch_list,
                                                   np.asarray(times), pitch_list)

    return out_times, out_pitch_list


def stacked_multi_pitch_to_stacked_pitch_list(stacked_multi_pitch, times, profile):
    """Convert an (S, F, T) stack into a stacked pitch list."""

    stacked_pitch_list = {}
    for slc in range(len(stacked_multi_pitch)):
        pitch_list = multi_pitch_to_pitch_list(stacked_multi_pitch[slc], profile)
        stacked_pitch_list[slc] = (np.asarray(times), pitch_list)

    return stacked_pitch_list


def extract_note_velocities(batched_notes, velocity, times, profile,
                            window=1):
    """Read each note's velocity off an (F, T) velocity map at its onset.

    ``batched_notes`` is (N, 3); returns an (N,) array in [0, 1]. ``window``
    > 1 averages the map over the first ``window`` frames of each note
    (clipped to the note's own span).
    """

    batched_notes = np.asarray(batched_notes).reshape(-1, 3)
    velocity = to_numpy(velocity)
    times = np.asarray(times)

    if len(batched_notes) == 0:
        return np.empty(0)

    _times = np.append(times, times[-1] + estimate_hop_length(times))

    num_frames = velocity.shape[1]
    rows = np.clip(np.round(batched_notes[:, 2] - profile.low).astype(int),
                   0, velocity.shape[0] - 1)
    frames = np.clip(np.searchsorted(_times, batched_notes[:, 0], side='right') - 1,
                     0, num_frames - 1)

    if window <= 1:
        return velocity[rows, frames]

    # Last frame each note still occupies (its span's inclusive end)
    ends = np.clip(np.searchsorted(_times, batched_notes[:, 1], side='right') - 1,
                   frames, num_frames - 1)

    values = np.zeros(len(batched_notes))
    counts = np.zeros(len(batched_notes))
    for offset in range(window):
        cols = frames + offset
        valid = (cols <= ends) & (cols < num_frames)
        values += np.where(valid, velocity[rows, np.minimum(cols, num_frames - 1)], 0.0)
        counts += valid

    return values / np.maximum(counts, 1)


def multi_pitch_to_notes(multi_pitch, times, profile, onsets=None, offsets=None):
    """Decode an (F, T) activation map into loose MIDI note groups.

    Vectorized suffix scans: a note starting at an onset impulse extends
    until the first frame where the pitch deactivates or a new onset occurs.
    """

    multi_pitch = to_numpy(multi_pitch)
    times = np.asarray(times)

    if onsets is None:
        onsets = multi_pitch_to_onsets(multi_pitch)
    else:
        onsets = to_numpy(onsets)

    # Ensure all onsets have corresponding pitch activations
    active = np.logical_or(onsets > 0, multi_pitch > 0)

    # Collapse onset spans to impulses at their starting frame
    onset_impulses = multi_pitch_to_onsets(onsets) > 0

    num_pitches, num_frames = active.shape[-2:]

    if num_frames == 0 or not np.any(onset_impulses):
        return np.empty(0), np.empty((0, 2))

    # Bound final offsets by one hop past the last frame
    times_ext = np.append(times, times[-1] + estimate_hop_length(times))

    frame_idx = np.arange(num_frames)

    # next_inactive[p, t] : smallest t' >= t with active[p, t'] == 0 (else T)
    cand = np.where(~active, frame_idx[None, :], num_frames)
    next_inactive = np.minimum.accumulate(cand[:, ::-1], axis=1)[:, ::-1]

    # next_onset[p, t] : smallest t' >= t with an onset impulse (else T)
    cand = np.where(onset_impulses, frame_idx[None, :], num_frames)
    next_onset = np.minimum.accumulate(cand[:, ::-1], axis=1)[:, ::-1]

    # Shift by one so the search starts strictly after the onset frame
    pad = np.full((num_pitches, 1), num_frames)
    next_inactive = np.concatenate([next_inactive[:, 1:], pad], axis=1)
    next_onset = np.concatenate([next_onset[:, 1:], pad], axis=1)

    end_frames = np.minimum(next_inactive, next_onset)

    pitch_rows, onset_frames = np.nonzero(onset_impulses)
    offset_frames = end_frames[pitch_rows, onset_frames]

    pitches = pitch_rows + profile.low
    intervals = np.stack([times[onset_frames], times_ext[offset_frames]], axis=-1)

    return sort_notes(pitches.astype(float), intervals)


def stacked_multi_pitch_to_multi_pitch(stacked_multi_pitch):
    """Collapse an (..., S, F, T) stack into (..., F, T) via max."""

    return np.max(to_numpy(stacked_multi_pitch), axis=-3)


def multi_pitch_to_stacked_multi_pitch(multi_pitch):
    """Add a singleton stack dimension to an (F, T) activation map."""

    return np.expand_dims(multi_pitch, axis=-3)


def stacked_notes_to_stacked_multi_pitch(stacked_notes, times, profile, include_offsets=True):
    """Rasterize each slice of stacked notes into an (S, F, T) stack."""

    stack = [notes_to_multi_pitch(p, i, times, profile, include_offsets)
             for p, i in stacked_notes.values()]

    return np.stack(stack, axis=-3)


def tablature_to_stacked_multi_pitch(tablature, profile):
    """Expand (..., S, T) tablature class indices into an (..., S, F, T) stack."""

    tablature = to_numpy(tablature).astype(int)
    num_dofs, num_frames = tablature.shape[-2:]
    num_pitches = profile.get_range_len()

    stacked_multi_pitch = np.zeros(tablature.shape[:-2] + (num_dofs, num_pitches, num_frames))

    tuning = np.asarray(profile.get_midi_tuning())
    dof_start = np.expand_dims(tuning - profile.low, -1)

    non_silent = tablature >= 0
    pitch_idcs = (tablature + dof_start)[non_silent].astype(int)

    idcs = np.nonzero(non_silent)
    stacked_multi_pitch[idcs[:-1] + (pitch_idcs, idcs[-1])] = 1

    return stacked_multi_pitch


def stacked_multi_pitch_to_tablature(stacked_multi_pitch, profile):
    """Collapse an (..., S, F, T) stack into (..., S, T) class indices
    (-1 = silence): on each string, the lowest active fret of its range."""

    stacked_multi_pitch = to_numpy(stacked_multi_pitch)
    tuning = profile.get_midi_tuning()

    tablature = []
    for dof in range(stacked_multi_pitch.shape[-3]):
        lo = tuning[dof] - profile.low
        multi_pitch = stacked_multi_pitch[..., dof,
                                          lo: lo + profile.num_pitches, :]

        silent = np.sum(multi_pitch, axis=-2) == 0
        highest = np.argmax(multi_pitch, axis=-2)
        highest = np.where(silent, -1, highest)

        tablature.append(np.expand_dims(highest, axis=-2))

    return np.concatenate(tablature, axis=-2)


def multi_pitch_to_onsets(multi_pitch):
    """Edge-detect where pitch activity begins (first frame counts as onset)."""

    multi_pitch = to_numpy(multi_pitch)

    first_frame = multi_pitch[..., :1]
    adjacent_diff = multi_pitch[..., 1:] - multi_pitch[..., :-1]

    onsets = np.concatenate([first_frame, adjacent_diff], axis=-1)

    return np.where(onsets > 0, onsets, 0)


def multi_pitch_to_offsets(multi_pitch):
    """Edge-detect where pitch activity ceases (last frame counts as offset)."""

    multi_pitch = to_numpy(multi_pitch)

    last_frame = multi_pitch[..., -1:]
    adjacent_diff = -1 * (multi_pitch[..., 1:] - multi_pitch[..., :-1])

    offsets = np.concatenate([adjacent_diff, last_frame], axis=-1)

    return np.where(offsets > 0, offsets, 0)


def stacked_multi_pitch_to_stacked_onsets(stacked_multi_pitch):
    """Edge-detect onsets independently on each slice of a stack."""

    return multi_pitch_to_onsets(stacked_multi_pitch)


def stacked_multi_pitch_to_stacked_offsets(stacked_multi_pitch):
    """Edge-detect offsets independently on each slice of a stack."""

    return multi_pitch_to_offsets(stacked_multi_pitch)


def framify_activations(activations, win_length, hop_length=1, pad=True):
    """Chunk activations into overlapping windows along the last axis:
    (..., T', win_length), the chunk axis at -2."""

    activations = to_numpy(activations)
    num_frames = activations.shape[-1]
    pad_length = win_length // 2

    if pad:
        target = num_frames + 2 * pad_length
    else:
        target = max(win_length, num_frames)

    # Center-pad with zeros along the last axis
    lpad = (target - num_frames) // 2
    rpad = target - num_frames - lpad
    padding = [(0, 0)] * (activations.ndim - 1) + [(lpad, rpad)]
    activations = np.pad(activations, padding)

    num_hops = (target - 2 * pad_length) // hop_length

    windows = np.lib.stride_tricks.sliding_window_view(activations, win_length, axis=-1)
    windows = windows[..., ::hop_length, :][..., :num_hops, :]

    return np.ascontiguousarray(windows)


def inhibit_activations(activations, times, window_length):
    """Suppress activations within a time window after a kept activation
    (a row-wise greedy pass over the non-zeros)."""

    activations = np.array(to_numpy(activations), copy=True)
    times = np.asarray(times)

    pitch_idcs, frame_idcs = activations.nonzero()

    out = np.zeros_like(activations)

    # Non-zeros arrive row-major (sorted by pitch, then frame)
    for pitch in np.unique(pitch_idcs):
        frames = frame_idcs[pitch_idcs == pitch]
        last_kept_time = -np.inf
        for frame in frames:
            if times[frame] >= last_kept_time + window_length:
                out[pitch, frame] = 1
                last_kept_time = times[frame]

    return out


def rms_norm(audio):
    """Normalize audio so its root-mean-square energy is 1."""

    audio = np.asarray(audio, dtype=np.float64)
    rms = np.sqrt(np.mean(audio ** 2))

    if rms > 0:
        return (audio / rms).astype(constants.FLOAT32)

    return audio.astype(constants.FLOAT32)


def estimate_hop_length(times):
    """Estimate the hop of a semi-regular time grid (median of regular diffs)."""

    if not len(times):
        raise ValueError('Cannot estimate hop length from an empty time array.')

    times = np.sort(np.asarray(times))

    if len(times) == 1:
        raise ValueError('Cannot estimate hop length from a single time.')

    non_gaps = np.append([False], np.isclose(np.diff(times, n=2), 0))

    if not np.sum(non_gaps):
        if len(times) == 2:
            return times[1] - times[0]
        raise ValueError('Time observations are too irregular.')

    return float(np.median(np.diff(times)[non_gaps]))


def get_resample_idcs(times, target_times):
    """Indices resampling a time grid onto target times (nearest observation)."""

    times = np.asarray(times)
    target_times = np.asarray(target_times)

    if not len(times):
        return None

    idcs = np.searchsorted(times, target_times, side='right') - 1

    return np.clip(idcs, 0, len(times) - 1)


def time_series_to_uniform(times, values, hop_length=None, duration=None,
                           suppress_warnings=True):
    """Snap a semi-regular ragged time series onto a uniform hop grid."""

    if not len(times) or not len(values):
        return np.array([]), []

    if hop_length is None:
        if not suppress_warnings:
            warnings.warn('Estimating hop length from irregular observation times.',
                          category=RuntimeWarning)
        hop_length = estimate_hop_length(times)

    if duration is None:
        duration = times[-1]

    num_entries = int(np.ceil(duration / hop_length)) + 1

    new_values = [np.array([])] * num_entries
    new_times = hop_length * np.arange(num_entries)

    idcs = np.round(np.asarray(times) / hop_length).astype(int)

    for i in range(len(idcs)):
        if times[i] <= duration:
            new_values[idcs[i]] = values[i]

    return new_times, new_values


def apply_func_stacked_representation(stacked_representation, func, **kwargs):
    """Apply a function to each slice of a stacked-representation dict."""

    return {k: func(v, **kwargs) for k, v in stacked_representation.items()}


def pack_stacked_representation(stacked_representation):
    """Pack a stacked-representation dict into an npz-friendly object array."""

    keys = np.array(list(stacked_representation.keys()), dtype=object)
    values = np.empty(len(keys), dtype=object)
    for i, k in enumerate(stacked_representation.keys()):
        values[i] = stacked_representation[k]

    return np.array([keys, values], dtype=object)


def unpack_stacked_representation(packed_stacked_representation):
    """Invert :func:`pack_stacked_representation`."""

    keys, values = packed_stacked_representation

    return {k: v for k, v in zip(keys, values)}


def _map_dict(track, fn):
    """Apply ``fn`` to array entries of a (possibly nested) dictionary."""

    out = {}
    for key, entry in track.items():
        if isinstance(entry, dict):
            out[key] = _map_dict(entry, fn)
        elif _is_array(entry):
            out[key] = fn(entry)
        else:
            out[key] = entry

    return out


def dict_to_dtype(track, dtype, copy=True):
    """Cast all array entries of a track dictionary to a dtype
    (``copy=False`` passes matching arrays through)."""

    return _map_dict(track, lambda a: np.asarray(a).astype(dtype, copy=copy))


def dict_to_array(track):
    """Bring all array entries of a track dictionary back to host numpy."""

    return _map_dict(track, to_numpy)


def dict_to_tensor(track, device):
    """All array entries of a track dictionary as tensors on ``device``."""

    return _map_dict(track, lambda a: torch.as_tensor(
        a if isinstance(a, torch.Tensor) else np.asarray(a)).to(device))


def dict_squeeze(track, dim=None):
    """Squeeze a dimension of all array entries of a track dictionary."""

    def _squeeze(a):
        if dim is None:
            return a.squeeze()
        if a.ndim > abs(dim if dim >= 0 else dim + 1) and a.shape[dim] == 1:
            return a.squeeze(dim)
        return a

    return _map_dict(track, _squeeze)


def dict_unsqueeze(track, dim=0):
    """Add a (batch) dimension to all array entries of a track dictionary."""

    return _map_dict(track, lambda a: np.expand_dims(a, dim)
                     if isinstance(a, np.ndarray) else a[None] if dim == 0 else a)


def dict_append(track, additions, dim=-1):
    """Append array entries of ``additions`` to matching entries of ``track``."""

    track = dict(track)
    for key, entry in additions.items():
        if key not in track or track[key] is None:
            track[key] = entry
        elif isinstance(entry, dict):
            track[key] = dict_append(track[key], entry, dim)
        elif _is_array(entry):
            track[key] = np.concatenate((to_numpy(track[key]), to_numpy(entry)), axis=dim)
        elif isinstance(entry, list):
            track[key] = list(track[key]) + entry
        else:
            track[key] = entry

    return track


def unpack_dict(data, key):
    """Fetch ``data[key]`` if present, else None."""

    if isinstance(data, dict) and key in data.keys():
        return data[key]

    return None


def get_tag(tag=None):
    """Default a file tag to the current date and time."""

    date_time = datetime.now().strftime('%m_%d_%Y_%H_%M_%S')

    return date_time if tag is None else tag


def get_current_time(decimals=3):
    """Current system time in seconds."""

    return round(time.time(), decimals)


def query_dict(dictionary, key):
    """Whether a dictionary holds ``key`` with a value other than None."""

    return isinstance(dictionary, dict) and dictionary.get(key) is not None


def slice_track(track, start, stop, skip=None, pad=True):
    """Slice all array entries of a track dict along the last axis.

    Entries shorter than the window are zero-padded (tablature with -1).
    Sliced arrays are fresh copies; skipped and non-array entries pass
    through by reference.
    """

    skip = skip or []
    out = dict(track)

    for key in out.keys():
        if key not in skip and _is_array(out[key]):
            entry = np.asarray(out[key])[..., start: stop]

            num_missing = max(0, (stop - start) - entry.shape[-1]) if pad else 0
            if num_missing:
                fill = -1 if key == constants.KEY_TABLATURE else 0
                padding = [(0, 0)] * (entry.ndim - 1) + [(0, num_missing)]
                entry = np.pad(entry, padding, constant_values=fill)
            else:
                entry = np.array(entry)

            out[key] = entry

    return out


def save_dict_npz(path, d):
    """Save a flat dictionary to an npz file (object entries pickled).

    Atomic: written under a temporary name that carries the process and the
    thread, then renamed, so concurrent writers of one cache path (loader
    threads, other processes) never leave a truncated file behind.
    """

    path = str(path)
    if not path.endswith('.npz'):
        # np.savez appends .npz when missing; pin it so the rename matches
        path += '.npz'

    tmp = f'{path}.tmp.{os.getpid()}.{threading.get_ident()}'
    try:
        np.savez_compressed(tmp, **d)
        # np.savez appended .npz to the temporary name too
        os.replace(f'{tmp}.npz', path)
    finally:
        if os.path.exists(f'{tmp}.npz'):
            os.remove(f'{tmp}.npz')


def load_dict_npz(path):
    """Load a dictionary previously saved with :func:`save_dict_npz`."""

    with np.load(path, allow_pickle=True) as data:
        return {k: data[k] for k in data.files}


def seed_everything(seed):
    """Seed Python's, numpy's and torch's global generators; the port's
    dropout and crops draw from explicit generators seeded apart."""

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    return seed


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device named and no CUDA device present this raises: the port
    never moves to the CPU on its own. ``device='cpu'`` runs every kernel's
    plain PyTorch version.
    """

    if device is not None:
        return torch.device(device)

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")

    return torch.device('cuda', torch.cuda.current_device())


def use_exact_fp32():
    """Turn TF32 off, process-wide, for float32 matmuls and cuDNN convs.

    cuDNN convolutions default to TF32 (``torch.backends.cudnn.allow_tf32``),
    which keeps about three decimal digits; the JAX reference computes the
    float32 path in full precision. bf16 work is unaffected. The serving
    entry points call this once, where they are built.
    """

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def exact_fp32():
    """:func:`use_exact_fp32` for the duration of a block, for tests and
    measurements; the previous flags are restored on exit."""

    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
