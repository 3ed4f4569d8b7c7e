"""Device-side note and tablature decode on tensors, and its host
finalization.

Counterparts of ``amt_tools_tpu/ops/decode.py``: ``threshold`` (``:29``),
``pack_bits`` (``:35``, on the device) and ``unpack_bits`` (``:52``, on the
host),
``multi_pitch_to_onsets`` (``:62``), ``multi_pitch_to_offsets`` (``:72``),
the tablature conversions (``:82-172``), ``note_segments`` (``:175``),
``notes_on_device`` (``:246``) and ``notes_from_device`` (``:315``). The
device functions take any number of leading batch axes where the JAX
functions are vmapped, and produce the same values bit for bit, including
``count > capacity`` overflow reports. Class ids are int64 here (torch's
index type) where JAX gives int32.

The regression decode of the High-resolution Piano Transcription model
(Kong et al., 2021; the published ``RegressionPostProcessor``), which the
JAX package lacks, is split the same way: :func:`regression_peaks` and
:func:`regression_events_on_device` find the peaks of the regressed onset
and offset curves, their fractional shifts, the onsets' velocities and the
frame curve's first drop after each onset, over (B, K, T) maps on the
device, and compact them into fixed-capacity buffers;
:func:`regression_notes_from_device` assembles one clip's notes from them
on the host, with numpy over its events.
"""

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..tools import utils

__all__ = [
    'sigmoid',
    'threshold',
    'pack_bits',
    'unpack_bits',
    'multi_pitch_to_onsets',
    'multi_pitch_to_offsets',
    'logistic_to_tablature',
    'tablature_to_stacked_multi_pitch',
    'tablature_to_local_multi_pitch',
    'stacked_multi_pitch_to_tablature',
    'stacked_multi_pitch_to_multi_pitch',
    'stacked_multi_pitch_to_logistic',
    'note_segments',
    'notes_on_device',
    'notes_from_device',
    'regression_peaks',
    'regression_events_on_device',
    'regression_notes_from_device',
    'NOTE_TILE_W',
    'NOTE_TILE_CAP',
]

# Tile geometry for the two-level note compaction: onset impulses are rising
# edges of a binary map, so no two adjacent frames are both impulses and a
# 128-frame tile holds at most 64 notes; the cap is exact for every input.
NOTE_TILE_W = 128
NOTE_TILE_CAP = 64


def sigmoid(x):
    """Logistic function as ``jax.nn.sigmoid`` computes it: ``1 / (1 +
    exp(-x))``, each op rounded in x's dtype.

    In bf16 this differs from ``torch.sigmoid`` (one rounding of the exact
    value): ``1 + exp(-x)`` rounds to 2 for |x| below about 0.0117, so those
    cells come out at exactly 0.5 and pass a 0.5 threshold. Following the
    op sequence keeps thresholded bf16 maps equal to the JAX pipeline's.
    """

    return 1.0 / (1.0 + torch.exp(-x))


def threshold(activations, thr=0.5):
    """Binarize activations at a threshold -> float32 {0, 1}, comparing in
    the activations' dtype."""

    return torch.where(activations >= thr, 1.0, 0.0)


def pack_bits(x):
    """Pack binary (..., T) activations into (..., ceil(T/8)) uint8 on the
    tensor's device: 8x smaller device-to-host transfers for thresholded
    maps (little-endian bit order; invert with :func:`unpack_bits` or
    ``np.unpackbits(..., bitorder='little')``)."""

    x = F.pad(x.to(torch.uint8), (0, (-x.shape[-1]) % 8))
    x = x.reshape(x.shape[:-1] + (-1, 8))
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=x.device)

    return (x * weights).sum(-1).to(torch.uint8)


def unpack_bits(packed, num_frames):
    """Host-side inverse of :func:`pack_bits` -> float32 binary
    activations."""

    bits = np.unpackbits(utils.to_numpy(packed), axis=-1, bitorder='little')

    return bits[..., :num_frames].astype(np.float32)


def multi_pitch_to_onsets(multi_pitch):
    """Edge-detect activation starts along the last axis."""

    first = multi_pitch[..., :1]
    diff = multi_pitch[..., 1:] - multi_pitch[..., :-1]
    onsets = torch.cat([first, diff], dim=-1)

    return torch.where(onsets > 0, onsets, 0.0)


def multi_pitch_to_offsets(multi_pitch):
    """Edge-detect activation ends along the last axis."""

    last = multi_pitch[..., -1:]
    diff = -(multi_pitch[..., 1:] - multi_pitch[..., :-1])
    offsets = torch.cat([diff, last], dim=-1)

    return torch.where(offsets > 0, offsets, 0.0)


def logistic_to_tablature(logistic, profile, silence, silence_thr=0.05):
    """(..., N, T) flattened string/fret activations -> (..., S, T) class ids."""

    num_dofs = profile.get_num_dofs()
    group = profile.num_pitches + int(silence)
    lead = logistic.shape[:-2]

    # (..., S, group, T) view of the flattened activations
    acts = logistic.reshape(lead + (num_dofs, group, logistic.shape[-1]))

    max_acts = torch.amax(acts, dim=-2)
    highest = torch.argmax(acts, dim=-2)

    if silence:
        return highest - 1

    return torch.where(max_acts <= silence_thr, -1, highest)


def tablature_to_stacked_multi_pitch(tablature, profile):
    """(..., S, T) class ids -> (..., S, F, T) one-hot pitch activations."""

    num_pitches = profile.get_range_len()
    tuning = torch.as_tensor(profile.get_midi_tuning(), device=tablature.device)

    # Absolute pitch row per (string, frame); silence maps out of range
    pitch_idx = tablature + (tuning - profile.low)[..., :, None]
    pitch_idx = torch.where(tablature >= 0, pitch_idx, num_pitches)

    rows = torch.arange(num_pitches, device=tablature.device)
    one_hot = rows[:, None] == pitch_idx[..., None, :]

    return one_hot.float()


def tablature_to_local_multi_pitch(tablature, num_classes):
    """(..., S, T) class ids -> (..., S, num_classes, T) LOCAL one-hot.

    Fret-space variant of :func:`tablature_to_stacked_multi_pitch`: row f is
    "fret f active on this string", so each string's map has
    ``num_classes`` rows instead of the instrument's pitch range. Map a
    decoded row back to MIDI with ``row + tuning[string]``.
    """

    rows = torch.arange(num_classes, device=tablature.device)
    one_hot = rows[:, None] == tablature[..., None, :]

    return one_hot.float()


def stacked_multi_pitch_to_tablature(stacked_multi_pitch, profile):
    """(..., S, F, T) stack -> (..., S, T) class ids (-1 = silence)."""

    tuning = profile.get_midi_tuning()
    num_pitches = profile.num_pitches

    tabs = []
    for dof in range(stacked_multi_pitch.shape[-3]):
        lo = int(tuning[dof]) - profile.low
        mp = stacked_multi_pitch[..., dof, lo: lo + num_pitches, :]
        silent = torch.sum(mp, dim=-2) == 0
        highest = torch.argmax(mp, dim=-2)
        tabs.append(torch.where(silent, -1, highest)[..., None, :])

    return torch.cat(tabs, dim=-2)


def stacked_multi_pitch_to_multi_pitch(stacked_multi_pitch):
    """Collapse (..., S, F, T) -> (..., F, T) by max."""

    return torch.amax(stacked_multi_pitch, dim=-3)


def stacked_multi_pitch_to_logistic(stacked_multi_pitch, profile,
                                    silence=False):
    """(..., S, F, T) stack -> (..., N, T) flattened string/fret activations."""

    tuning = profile.get_midi_tuning()
    num_pitches = profile.num_pitches

    parts = []
    for dof in range(stacked_multi_pitch.shape[-3]):
        lo = int(tuning[dof]) - profile.low
        mp = stacked_multi_pitch[..., dof, lo: lo + num_pitches, :]
        if silence:
            silent = (torch.sum(mp, dim=-2, keepdim=True) == 0).to(mp.dtype)
            mp = torch.cat([silent, mp], dim=-2)
        parts.append(mp)

    return torch.cat(parts, dim=-2)


def _reverse_cummin(x):
    """Cumulative minimum from the right along the last axis."""

    return torch.flip(torch.cummin(torch.flip(x, (-1,)), dim=-1).values, (-1,))


def note_segments(multi_pitch, onsets=None):
    """Per-cell note boundaries of (..., F, T) activation maps.

    Returns ``(onset_impulses, end_frames)``: a bool map of note starts and,
    for a note starting at frame t, its exclusive end frame (the first frame
    after t where the pitch deactivates or re-onsets; T at the edge), int32.
    """

    if onsets is None:
        onsets = multi_pitch_to_onsets(multi_pitch)

    active = (onsets > 0) | (multi_pitch > 0)

    # Binarize before edge detection so rising edges are never adjacent
    # (what makes NOTE_TILE_CAP exact)
    onset_impulses = multi_pitch_to_onsets((onsets > 0).float()) > 0

    num_frames = active.shape[-1]
    frame_idx = torch.arange(num_frames, dtype=torch.int32,
                             device=active.device)

    next_inactive = _reverse_cummin(torch.where(~active, frame_idx, num_frames))
    next_onset = _reverse_cummin(torch.where(onset_impulses, frame_idx,
                                             num_frames))

    # Shift by one: the search starts strictly after the onset frame
    pad = torch.full(active.shape[:-1] + (1,), num_frames, dtype=torch.int32,
                     device=active.device)
    next_inactive = torch.cat([next_inactive[..., 1:], pad], dim=-1)
    next_onset = torch.cat([next_onset[..., 1:], pad], dim=-1)

    end_frames = torch.minimum(next_inactive, next_onset).to(torch.int32)

    return onset_impulses, end_frames


def notes_on_device(multi_pitch, onsets=None, capacity=1024):
    """Full note decode into fixed-capacity compact buffers.

    For (..., F, T) activation maps returns ``(pitch_rows, onset_frames,
    offset_frames, count)``: int32 (..., capacity) note lists in row-major
    (pitch-major) order, zero past ``count``, and the true note count per
    map (``count > capacity`` signals overflow). No host synchronisation.

    The impulse map compacts with a two-level cumsum, as in the JAX
    package, but the two compare-reductions it fuses on XLA
    (``#(csum <= j)`` and ``#(offsets <= slot)``) are binary searches here:
    both sequences are nondecreasing, so ``searchsorted(..., right=True)``
    gives the same counts without materializing the comparisons.
    """

    impulses, end_frames = note_segments(multi_pitch, onsets)

    lead = impulses.shape[:-2]
    num_rows, num_frames = impulses.shape[-2:]
    impulses = impulses.reshape((-1, num_rows, num_frames))
    end_frames = end_frames.reshape((-1, num_rows * num_frames))
    batch = impulses.shape[0]
    device = impulses.device

    num_tiles = -(-num_frames // NOTE_TILE_W)
    imp = F.pad(impulses.to(torch.int32),
                (0, num_tiles * NOTE_TILE_W - num_frames))
    imp = imp.reshape(batch, num_rows * num_tiles, NOTE_TILE_W)

    # Within-tile ranks: the j-th impulse of a tile sits at #(w: csum[w] <= j)
    csum = torch.cumsum(imp, dim=-1, dtype=torch.int32)
    j_idx = torch.arange(NOTE_TILE_CAP, dtype=torch.int32, device=device)
    tile_pos = torch.searchsorted(
        csum, j_idx.expand(batch, num_rows * num_tiles, NOTE_TILE_CAP)
        .contiguous(), right=True, out_int32=True)

    # Row-major tile offsets into the output slots
    counts = csum[..., -1]
    offsets = torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts
    total = torch.sum(counts, dim=-1, dtype=torch.int32)

    slots = torch.arange(capacity, dtype=torch.int32, device=device)
    slots = slots.expand(batch, capacity).contiguous()
    tile_id = torch.searchsorted(offsets, slots, right=True,
                                 out_int32=True) - 1
    j = slots - torch.gather(offsets, 1, tile_id.long())
    live = slots < torch.clamp_max(total, capacity)[:, None]

    tile_id = torch.where(live, tile_id, 0)
    j = torch.where(live, j, 0)

    pos = torch.gather(tile_pos.reshape(batch, -1), 1,
                       (tile_id * NOTE_TILE_CAP + j).long())
    t_on = (tile_id % num_tiles) * NOTE_TILE_W + pos
    row = tile_id // num_tiles

    flat_idx = torch.where(live, row * num_frames + t_on, 0)
    pitch_rows = torch.where(live, row, 0).to(torch.int32)
    onset_frames = torch.where(live, t_on, 0).to(torch.int32)
    offset_frames = torch.where(
        live, torch.gather(end_frames, 1, flat_idx.long()), 0).to(torch.int32)

    return (pitch_rows.reshape(lead + (capacity,)),
            onset_frames.reshape(lead + (capacity,)),
            offset_frames.reshape(lead + (capacity,)),
            total.reshape(lead))


def notes_from_device(pitch_rows, onset_frames, offset_frames, count,
                      times, profile, low=None):
    """Host finalization of one map's :func:`notes_on_device` buffers.

    Numpy in, ``(pitches, intervals)`` out, sorted by onset; O(count).
    ``low`` overrides the row -> MIDI offset (default ``profile.low``).
    """

    capacity = len(pitch_rows)
    count = int(count)
    if count > capacity:
        warnings.warn(f'notes_on_device overflow: {count} notes > capacity '
                      f'{capacity}; {count - capacity} notes dropped.')
        count = capacity

    if count == 0:
        return np.empty(0), np.empty((0, 2))

    rows = np.asarray(pitch_rows[:count])
    on = np.asarray(onset_frames[:count])
    off = np.asarray(offset_frames[:count])

    times = np.asarray(times)
    times_ext = np.append(times, times[-1] + utils.estimate_hop_length(times))

    pitches = rows + (profile.low if low is None else low)
    intervals = np.stack([times[on], times_ext[off]], axis=-1)

    return utils.sort_notes(pitches.astype(float), intervals)


##################################################
# REGRESSION DECODE                              #
##################################################


def regression_peaks(x, threshold, neighbour=2):
    """(..., T) regressed curves -> a bool map of their peaks: frames t in
    [``neighbour``, T - ``neighbour``) above ``threshold`` that rise
    strictly over the ``neighbour`` frames before them and fall strictly
    over the ``neighbour`` after. Compared in x's dtype."""

    frames = x.shape[-1]
    peaks = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if frames < 2 * neighbour + 1:
        return peaks

    def at(offset):
        return x[..., neighbour + offset:frames - neighbour + offset]

    found = at(0) > threshold
    for i in range(neighbour):
        found &= at(-i - 1) < at(-i)
        found &= at(i + 1) < at(i)
    peaks[..., neighbour:frames - neighbour] = found

    return peaks


def _compact(mask, capacity):
    """(B, N) bool -> the flat indices of its first ``capacity`` true
    entries a row, in order, (B, capacity) int64 (0 past the count), whether
    each slot holds one, and the true count (B,) int32."""

    csum = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    count = csum[:, -1] if mask.shape[-1] else torch.zeros(
        mask.shape[0], dtype=torch.int32, device=mask.device)
    slots = torch.arange(1, capacity + 1, dtype=torch.int32,
                         device=mask.device).expand(mask.shape[0], capacity)
    # The j-th true entry is where the running count first reaches j
    index = torch.searchsorted(csum, slots.contiguous())
    live = slots <= count[:, None]

    return torch.where(live, index, 0), live, count


def _shifts(x, keys, frames):
    """The fractional shift of each peak (``keys``, ``frames``: (B, n)) of
    (B, K, T) curves, from the three frames around it: ``(x[t+1] -
    x[t-1]) / (x[t] - min(x[t-1], x[t+1])) / 2`` in float32."""

    flat = x.reshape(x.shape[0], -1)
    at = keys * x.shape[-1] + frames
    before, centre, after = (torch.gather(flat, 1, at + d).float()
                             for d in (-1, 0, 1))

    return (after - before) / (centre - torch.minimum(before, after)) / 2


def regression_events_on_device(frame, onset, offset, velocity, capacity,
                                onset_threshold=0.3, offset_threshold=0.3,
                                frame_threshold=0.1, neighbour=2):
    """The device stage of the regression decode over (B, K, T) sigmoid
    maps (frame, regressed onset and offset, velocity): no host
    synchronisation.

    Returns ``(onset_keys, onset_frames, onset_shifts, velocities, drops,
    offset_keys, offset_frames, offset_shifts, counts)``: the onset peaks,
    key-major and in frame order within a key, in (B, capacity) buffers
    (int32 keys and frames, float32 shifts and velocities, int32 ``drops``:
    the first frame after the onset where the frame curve is at or below
    ``frame_threshold``, T where there is none), the offset peaks likewise,
    and (B, 2) int32 true counts of the onset and offset peaks (a count
    above ``capacity`` signals overflow). Zero past each count."""

    batch, keys, frames = frame.shape
    device = frame.device

    def events(curve, threshold):
        index, live, count = _compact(
            regression_peaks(curve, threshold, neighbour).reshape(batch, -1),
            capacity)
        key, at = index // frames, index % frames
        # A dead slot reads frame 0's neighbours, clamped, and is zeroed
        shift = _shifts(curve, key, torch.where(live, at, 1).clamp(
            1, max(1, frames - 2)))
        return key, at, torch.where(live, shift, 0.0), live, index, count

    on_key, on_frame, on_shift, on_live, on_index, on_count = events(
        onset, onset_threshold)
    off_key, off_frame, off_shift, off_live, _, off_count = events(
        offset, offset_threshold)

    # The first frame after each onset where the frame curve drops
    step = torch.arange(frames, dtype=torch.int32, device=device)
    low = torch.where(frame <= frame_threshold, step, frames)
    after = torch.flip(torch.cummin(torch.flip(low, (-1,)), dim=-1).values,
                       (-1,))
    after = F.pad(after[..., 1:], (0, 1), value=frames)
    drops = torch.gather(after.reshape(batch, -1), 1, on_index)
    velocities = torch.gather(velocity.reshape(batch, -1), 1,
                              on_index).float()

    def ints(x, live):
        return torch.where(live, x, 0).to(torch.int32)

    return (ints(on_key, on_live), ints(on_frame, on_live), on_shift,
            torch.where(on_live, velocities, 0.0), ints(drops, on_live),
            ints(off_key, off_live), ints(off_frame, off_live), off_shift,
            torch.stack([on_count, off_count], dim=-1))


def regression_notes_from_device(onset_keys, onset_frames, onset_shifts,
                                 velocities, drops, offset_keys, offset_frames,
                                 offset_shifts, counts, num_frames,
                                 frame_seconds, low, max_frames=600,
                                 velocity_scale=128):
    """The host stage of the regression decode: one clip's buffers of
    :func:`regression_events_on_device` (numpy) -> ``(pitches, intervals,
    velocities)``, sorted by onset, then pitch.

    The published ``note_detection_with_onset_offset_regress`` a key, over
    the clip's events: a note opens at each onset peak; the key's next
    onset closes it a frame before (offset shift 0); else it closes at the
    first frame where the frame curve drops to the threshold or below, at
    the key's first offset peak after the onset instead if that lies at or
    before the drop and ``offset - onset > drop - offset``; else at
    ``max_frames`` after the onset, or at the clip's last frame. Times are
    ``(frame + shift) * frame_seconds``, with the offset shift of the frame
    the note closes at (0 where it is no offset peak); velocities are
    ``int(velocity * velocity_scale)``. ``low`` is the first key's MIDI
    pitch. O(events log events)."""

    capacity = len(onset_keys)
    counts = [int(c) for c in counts]
    if max(counts) > capacity:
        warnings.warn(f'regression_events_on_device overflow: {max(counts)} '
                      f'peaks > capacity {capacity}; the rest dropped.')
    n_on, n_off = (min(c, capacity) for c in counts)
    if n_on == 0:
        return np.empty(0), np.empty((0, 2)), np.empty(0, dtype=np.int64)

    keys = np.asarray(onset_keys[:n_on], dtype=np.int64)
    begin = np.asarray(onset_frames[:n_on], dtype=np.int64)
    drop = np.asarray(drops[:n_on], dtype=np.int64)
    stride = num_frames + 1
    never = np.int64(1) << 40
    # The offset peaks by global index key * stride + frame, ascending, and
    # a sentinel past every key
    off_at = np.append(np.asarray(offset_keys[:n_off], dtype=np.int64) *
                       stride + np.asarray(offset_frames[:n_off],
                                           dtype=np.int64), never * stride)
    off_shift = np.append(np.asarray(offset_shifts[:n_off]), 0.0)

    # The key's next onset, and its first offset peak after the onset
    following = np.full(n_on, never)
    following[:-1] = np.where(keys[1:] == keys[:-1], begin[1:], never)
    first = off_at[np.searchsorted(off_at, keys * stride + begin,
                                   side='right')]
    offset = np.where(first // stride == keys, first % stride, never)

    limit = np.minimum(begin + max_frames, num_frames - 1)
    by_onset = following <= np.minimum(drop, limit)
    by_drop = ~by_onset & (drop <= limit)
    at_offset = (offset <= drop) & (offset - begin > drop - offset)
    end = np.where(by_onset, following - 1,
                   np.where(by_drop, np.where(at_offset, offset, drop),
                            limit))

    # The offset shift of the frame the note closes at: 0 where it is no
    # offset peak, or where the next onset closed the note
    slot = np.searchsorted(off_at, keys * stride + end)
    end_shift = np.where((off_at[slot] == keys * stride + end) & ~by_onset,
                         off_shift[slot], 0.0)

    onsets = (begin + np.asarray(onset_shifts[:n_on], dtype=np.float64)) * (
        frame_seconds)
    offsets = (end + end_shift.astype(np.float64)) * frame_seconds
    levels = (np.asarray(velocities[:n_on], dtype=np.float32) *
              np.float32(velocity_scale)).astype(np.int64)
    pitches = (keys + low).astype(float)

    order = np.lexsort((pitches, onsets))

    return (pitches[order], np.stack([onsets, offsets], axis=-1)[order],
            levels[order])
