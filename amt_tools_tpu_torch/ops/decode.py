"""Device-side note decode on tensors, and its host finalization.

Counterparts of ``amt_tools_tpu/ops/decode.py``: ``threshold`` (``:29``),
``multi_pitch_to_onsets`` (``:62``), ``note_segments`` (``:175``),
``notes_on_device`` (``:246``) and ``notes_from_device`` (``:315``). The
device functions take any number of leading batch axes where the JAX
functions are vmapped, and produce the same int32 buffers bit for bit,
including ``count > capacity`` overflow reports.
"""

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..tools import utils

__all__ = [
    'sigmoid',
    'threshold',
    'multi_pitch_to_onsets',
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


def multi_pitch_to_onsets(multi_pitch):
    """Edge-detect activation starts along the last axis."""

    first = multi_pitch[..., :1]
    diff = multi_pitch[..., 1:] - multi_pitch[..., :-1]
    onsets = torch.cat([first, diff], dim=-1)

    return torch.where(onsets > 0, onsets, 0.0)


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
