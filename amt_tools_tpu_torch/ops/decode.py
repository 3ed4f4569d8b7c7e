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
