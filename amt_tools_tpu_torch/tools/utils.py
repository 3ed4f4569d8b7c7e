"""Host helpers: notes, ground-truth maps, track dicts, device choice.

Copies of ``amt_tools_tpu/tools/utils.py`` (numpy, host side, bit for
bit): ``_is_array`` (``:101``), ``notes_to_batched_notes`` (``:113``),
``batched_notes_to_notes`` (``:126``), ``sort_notes`` (``:149``),
``slice_batched_notes`` (``:207``), ``filter_notes`` (``:254``),
``notes_to_multi_pitch`` (``:622``), ``notes_to_velocity`` (``:669``),
``notes_to_onsets`` (``:987``), ``notes_to_offsets`` (``:1037``),
``rms_norm`` (``:1086``), ``estimate_hop_length`` (``:1239``),
``dict_to_dtype`` (``:1348``), ``query_dict`` (``:1467``) and
``slice_track`` (``:1481``).
"""

import contextlib

import numpy as np
import torch

from . import constants

__all__ = [
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
    'resolve_device',
    'use_exact_fp32',
    'exact_fp32',
]


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
                 max_time=np.inf):
    """Remove notes with out-of-range nominal pitch or fully out-of-bounds
    intervals."""

    pitches = np.asarray(pitches)
    intervals = np.asarray(intervals).reshape(-1, 2)

    valid = np.logical_and(intervals[:, 0] <= max_time,
                           intervals[:, 1] >= min_time)

    if profile is not None:
        pitches_r = np.round(pitches)
        valid = np.logical_and(valid, np.logical_and(
            pitches_r >= profile.low, pitches_r <= profile.high))

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
