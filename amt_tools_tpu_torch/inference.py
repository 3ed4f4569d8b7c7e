"""Offline and mock-real-time (online) inference entry points.

Counterpart of ``amt_tools_tpu/inference.py`` ``run_offline``,
``run_offline_batched``, ``run_single_frame``, ``run_online`` and
``run_online_stateful`` (``:35-289``). The model holds its parameters, so no ``variables`` are
passed; each entry point takes ``device`` (the card unless the caller names
one, through ``tools.resolve_device``), moves the model there and runs its
forward under ``torch.no_grad()``. Predictions come back as host numpy
(``tools.dict_to_array``; bf16 widened to float32).

With ``bucket`` > 0 a track's frame-aligned entries are padded to the next
multiple of ``bucket`` frames and ``tools.KEY_VALID_FRAMES`` carries its
true length into the model's masked forward (kernel B with lengths on the
card), so the valid frames equal an unpadded run's bit for bit; the padded
tail is trimmed. As in the JAX package, loss terms are averaged over the
padded frames too. ``run_online_stateful`` feeds a carry-threading model
(``OnsetsFramesOnline``) one frame a step: each of its recurrences runs
kernel B at T = 1 from the previous step's carry.
"""

import numpy as np
import torch

from . import tools
from .models.common import run_on_batch

__all__ = [
    'run_offline',
    'run_offline_batched',
    'run_single_frame',
    'run_online',
    'run_online_stateful',
]


def _forward(model, batch, device):
    """The model pipeline on a host batch, on ``device``; host numpy out."""

    with torch.no_grad():
        output = run_on_batch(model, tools.dict_to_tensor(batch, device),
                              train=False)

    return tools.dict_to_array(output)


def _arrays(track_data):
    """The array entries of a track, float32 (as the JAX package casts
    them before the forward)."""

    track_data = tools.dict_to_dtype(track_data, dtype=tools.FLOAT32)

    return {k: v for k, v in track_data.items() if tools.utils._is_array(v)}


def _padded_frames(num_frames, bucket):
    return -(-num_frames // bucket) * bucket


def _pad_frames(value, key, num_frames, padded):
    """A frame-aligned entry zero-padded to ``padded`` frames (tablature
    with -1, the ``slice_track`` convention)."""

    fill = -1 if key == tools.KEY_TABLATURE else 0
    pad = [(0, 0)] * (value.ndim - 1) + [(0, padded - num_frames)]

    return np.pad(value, pad, constant_values=fill)


def run_offline(track_data, model, estimator=None, bucket=0, device=None):
    """Whole-track inference: features -> predictions -> (estimates).

    With ``bucket`` > 0 the features and every frame-aligned entry
    (labels, times) are padded along time to the next multiple of
    ``bucket`` frames and the valid-frame count is threaded into the
    model's masked forward; predictions are trimmed back to the true
    length. Monitoring loss terms are then averaged over padded and valid
    frames, so use ``bucket=0`` where exact loss values matter.
    """

    device = tools.resolve_device(device)
    model.to(device)

    track_id = tools.unpack_dict(track_data, tools.KEY_TRACK)
    arrays = _arrays(track_data)

    num_frames = padded = None
    if bucket and tools.query_dict(arrays, tools.KEY_FEATS):
        num_frames = np.asarray(arrays[tools.KEY_FEATS]).shape[-1]
        padded = _padded_frames(num_frames, bucket)
        if padded != num_frames:
            for key, value in list(arrays.items()):
                value = np.asarray(value)
                if value.ndim >= 1 and value.shape[-1] == num_frames:
                    arrays[key] = _pad_frames(value, key, num_frames, padded)
        arrays[tools.KEY_VALID_FRAMES] = np.asarray(num_frames)

    # Treat the track as a batch of one
    predictions = tools.dict_squeeze(
        _forward(model, tools.dict_unsqueeze(arrays), device), dim=0)

    if num_frames is not None:
        # Trim every frame-aligned entry back to the true length
        predictions = {
            k: (v[..., :num_frames]
                if tools.utils._is_array(v) and getattr(v, 'ndim', 0) >= 1
                and v.shape[-1] == padded else v)
            for k, v in predictions.items()}
        predictions.pop(tools.KEY_VALID_FRAMES, None)

    if estimator is not None:
        predictions.update(estimator.process_track(predictions, track_id))

    return predictions


def run_offline_batched(track_datas, model, estimator=None, bucket=128,
                        device=None):
    """Whole-track inference on several tracks in one forward.

    Every track is padded to the group's bucketed frame count, the
    frame-aligned entries that every track has are stacked into one batch
    (audio and ragged notes or pitch lists are left out) and one masked
    forward serves them all; each track's predictions are trimmed to its
    true length. Returns one predictions dict per track. Loss terms are
    the batch's (the same for every track of the group).
    """

    if not track_datas:
        return []

    device = tools.resolve_device(device)
    model.to(device)

    track_ids = [tools.unpack_dict(t, tools.KEY_TRACK) for t in track_datas]

    prepared = [_arrays(track_data) for track_data in track_datas]
    frame_counts = [np.asarray(arrays[tools.KEY_FEATS]).shape[-1]
                    for arrays in prepared]
    padded = _padded_frames(max(frame_counts), bucket)

    # Keys every track provides with a frame-aligned last axis
    keys = set(prepared[0])
    for arrays in prepared[1:]:
        keys &= set(arrays)
    keys = [k for k in sorted(keys)
            if all(np.asarray(a[k]).ndim >= 1 and
                   np.asarray(a[k]).shape[-1] == n
                   for a, n in zip(prepared, frame_counts))]

    batch = {key: np.stack([_pad_frames(np.asarray(arrays[key]), key,
                                        num_frames, padded)
                            for arrays, num_frames in zip(prepared,
                                                          frame_counts)])
             for key in keys}
    batch[tools.KEY_VALID_FRAMES] = np.asarray(frame_counts)

    output = _forward(model, batch, device)

    all_predictions = []
    for index, (track_id, num_frames) in enumerate(zip(track_ids,
                                                       frame_counts)):
        predictions = {}
        for key, value in output.items():
            if tools.utils._is_array(value) and getattr(value, 'ndim', 0) >= 1 \
                    and value.shape[0] == len(track_ids):
                entry = value[index]
                if getattr(entry, 'ndim', 0) >= 1 and entry.shape[-1] == padded:
                    entry = entry[..., :num_frames]
                predictions[key] = entry
            else:
                predictions[key] = value
        predictions.pop(tools.KEY_VALID_FRAMES, None)

        if estimator is not None:
            predictions.update(estimator.process_track(predictions, track_id))

        all_predictions.append(predictions)

    return all_predictions


def run_single_frame(track_data, model, estimator=None, device=None):
    """Inference on a single (batched) frame group."""

    device = tools.resolve_device(device)
    model.to(device)

    track_id = tools.unpack_dict(track_data, tools.KEY_TRACK)

    new_predictions = tools.dict_squeeze(
        _forward(model, _arrays(track_data), device), dim=0)

    if estimator is not None:
        new_predictions.update(estimator.process_track(new_predictions,
                                                       track_id))

    return new_predictions


def run_online(track_data, model, estimator=None, device=None):
    """Mock-real-time inference: feed one frame group at a time.

    Features are windowed by the model's ``frame_width`` and each window is
    processed independently (stateful estimators such as
    ``IterativeNoteTranscriber`` accumulate notes across calls).
    """

    device = tools.resolve_device(device)

    features = tools.unpack_dict(track_data, tools.KEY_FEATS)
    times = tools.unpack_dict(track_data, tools.KEY_TIMES)

    num_frame_groups = features.shape[-1]

    # Window the features to mimic real-time operation
    features = tools.framify_activations(np.asarray(features),
                                         model.frame_width)

    predictions = {}
    note_chunks = []

    for i in range(num_frame_groups):
        batch = tools.dict_unsqueeze({
            tools.KEY_FEATS: features[..., i, :],
            tools.KEY_TIMES: times[..., i: i + 1],
        })

        new_predictions = run_single_frame(batch, model, estimator, device)

        # Accumulate notes separately: they are ragged (N, 3) collections
        if tools.query_dict(new_predictions, tools.KEY_NOTES):
            note_chunks.append(np.asarray(
                new_predictions.pop(tools.KEY_NOTES)).reshape(-1, 3))

        predictions = tools.dict_append(predictions, new_predictions)

    if note_chunks:
        predictions[tools.KEY_NOTES] = np.concatenate(note_chunks, axis=0)

    if estimator is not None:
        # Reset streaming state for the next track
        estimator.reset_state()

    return predictions


def run_online_stateful(track_data, model, estimator=None, device=None):
    """Frame-at-a-time inference for a carry-threading streaming model.

    For models with ``init_carries`` and ``forward(feats, carries=...)``
    (``OnsetsFramesOnline``): each frame runs the eval-mode forward under
    ``torch.no_grad()`` with the carries of the previous frame, so it keeps
    its full recurrent context, and its predictions come back to the host
    before the next frame. ``device`` is the card unless the caller names
    one. Notes from a stateful estimator are gathered across frames.
    """

    device = tools.resolve_device(device)
    model.to(device)
    model.eval()

    features = np.asarray(tools.unpack_dict(track_data, tools.KEY_FEATS),
                          dtype=np.float32)
    times = np.asarray(tools.unpack_dict(track_data, tools.KEY_TIMES))
    track_id = tools.unpack_dict(track_data, tools.KEY_TRACK)

    carries = model.init_carries(1, device)

    predictions = {}
    note_chunks = []

    for i in range(features.shape[-1]):
        frame = torch.from_numpy(features[None, ..., i: i + 1]).to(device)

        with torch.no_grad():
            feats = model.pre_proc({tools.KEY_FEATS: frame})[tools.KEY_FEATS]
            raw, carries = model(feats, carries=carries)
            batch = {tools.KEY_OUTPUT: raw,
                     tools.KEY_TIMES: times[i: i + 1][None]}
            output = model.post_proc(batch)
        output[tools.KEY_TIMES] = batch[tools.KEY_TIMES]

        new_predictions = tools.dict_squeeze(tools.dict_to_array(output),
                                             dim=0)

        if estimator is not None:
            new_predictions.update(estimator.process_track(new_predictions,
                                                           track_id))

        if tools.query_dict(new_predictions, tools.KEY_NOTES):
            note_chunks.append(np.asarray(
                new_predictions.pop(tools.KEY_NOTES)).reshape(-1, 3))

        predictions = tools.dict_append(predictions, new_predictions)

    if note_chunks:
        predictions[tools.KEY_NOTES] = np.concatenate(note_chunks, axis=0)

    if estimator is not None:
        estimator.reset_state()

    return predictions
