"""Transcription metrics: the JAX package's native matcher (host numpy).

A copy of ``amt_tools_tpu/metrics.py`` (``:30-210``), which reproduces
``mir_eval``'s definitions without it:

- :func:`match_notes` / :func:`precision_recall_f1_overlap`: note-level
  matching with onset (50 ms), pitch (50 cents) and optional offset
  criteria, by maximum bipartite matching (scipy's Hopcroft-Karp), as in
  ``mir_eval.transcription``;
- :func:`multipitch_metrics`: frame-level multi-F0 precision, recall and
  accuracy with a bipartite matching per frame in cents, as in
  ``mir_eval.multipitch``.
"""

import sys

import numpy as np

__all__ = [
    'match_notes',
    'precision_recall_f1_overlap',
    'multipitch_metrics',
    'f_measure',
]

EPSILON = sys.float_info.epsilon


def f_measure(precision, recall, beta=1.0):
    """(1 + beta^2) * P * R / (beta^2 * P + R), 0 when both are 0."""

    precision = np.asarray(precision, dtype=float)
    recall = np.asarray(recall, dtype=float)

    denom = beta ** 2 * precision + recall

    with np.errstate(invalid='ignore', divide='ignore'):
        f = np.where(denom > 0, (1 + beta ** 2) * precision * recall / np.maximum(denom, EPSILON), 0.0)

    return float(f) if f.ndim == 0 else f


def _maximum_bipartite_matching(hits):
    """Maximum matching of a boolean (n_ref, n_est) adjacency matrix.

    Returns a list of (ref_idx, est_idx) pairs. Uses scipy's Hopcroft-Karp.
    """

    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    n_ref, n_est = hits.shape
    if n_ref == 0 or n_est == 0 or not hits.any():
        return []

    graph = csr_matrix(hits)
    # perm[j] = ref index matched to est column j (or -1)
    perm = maximum_bipartite_matching(graph, perm_type='row')

    return [(int(perm[j]), j) for j in range(n_est) if perm[j] != -1]


def match_notes(ref_intervals, ref_pitches, est_intervals, est_pitches,
                onset_tolerance=0.05, pitch_tolerance=50.0,
                offset_ratio=None, offset_min_tolerance=0.05):
    """Find the maximum matching between reference and estimated notes.

    A pair matches when onsets are within ``onset_tolerance`` seconds,
    pitches are within ``pitch_tolerance`` cents, and (when ``offset_ratio``
    is given) offsets are within ``max(offset_min_tolerance, offset_ratio *
    ref_duration)`` seconds. Pitches are in Hz.
    """

    ref_intervals = np.asarray(ref_intervals, dtype=float).reshape(-1, 2)
    est_intervals = np.asarray(est_intervals, dtype=float).reshape(-1, 2)
    ref_pitches = np.atleast_1d(np.asarray(ref_pitches, dtype=float))
    est_pitches = np.atleast_1d(np.asarray(est_pitches, dtype=float))

    if len(ref_pitches) == 0 or len(est_pitches) == 0:
        return []

    onset_hit = np.abs(ref_intervals[:, 0][:, None] -
                       est_intervals[:, 0][None, :]) <= onset_tolerance

    with np.errstate(divide='ignore', invalid='ignore'):
        cent_diff = 1200.0 * np.abs(np.log2(est_pitches[None, :] /
                                            ref_pitches[:, None]))
    pitch_hit = cent_diff <= pitch_tolerance

    hits = np.logical_and(onset_hit, pitch_hit)

    if offset_ratio is not None:
        durations = ref_intervals[:, 1] - ref_intervals[:, 0]
        offset_tol = np.maximum(offset_min_tolerance, offset_ratio * durations)
        offset_hit = np.abs(ref_intervals[:, 1][:, None] -
                            est_intervals[:, 1][None, :]) <= offset_tol[:, None]
        hits = np.logical_and(hits, offset_hit)

    return _maximum_bipartite_matching(hits)


def precision_recall_f1_overlap(ref_intervals, ref_pitches, est_intervals,
                                est_pitches, onset_tolerance=0.05,
                                pitch_tolerance=50.0, offset_ratio=None,
                                offset_min_tolerance=0.05, beta=1.0):
    """Note-level precision, recall, F-measure, and average overlap ratio.

    Equivalent to ``mir_eval.transcription.precision_recall_f1_overlap``.
    """

    ref_intervals = np.asarray(ref_intervals, dtype=float).reshape(-1, 2)
    est_intervals = np.asarray(est_intervals, dtype=float).reshape(-1, 2)
    ref_pitches = np.atleast_1d(np.asarray(ref_pitches, dtype=float))
    est_pitches = np.atleast_1d(np.asarray(est_pitches, dtype=float))

    if len(ref_pitches) == 0 or len(est_pitches) == 0:
        return 0.0, 0.0, 0.0, 0.0

    matching = match_notes(ref_intervals, ref_pitches, est_intervals,
                           est_pitches, onset_tolerance, pitch_tolerance,
                           offset_ratio, offset_min_tolerance)

    precision = len(matching) / len(est_pitches)
    recall = len(matching) / len(ref_pitches)
    f = f_measure(precision, recall, beta)

    if matching:
        ratios = []
        for ref_i, est_i in matching:
            lo = max(ref_intervals[ref_i, 0], est_intervals[est_i, 0])
            hi = min(ref_intervals[ref_i, 1], est_intervals[est_i, 1])
            union_lo = min(ref_intervals[ref_i, 0], est_intervals[est_i, 0])
            union_hi = max(ref_intervals[ref_i, 1], est_intervals[est_i, 1])
            denom = union_hi - union_lo
            ratios.append((hi - lo) / denom if denom > 0 else 1.0)
        avg_overlap_ratio = float(np.mean(ratios))
    else:
        avg_overlap_ratio = 0.0

    return precision, recall, f, avg_overlap_ratio


def _freqs_to_cents(freqs):
    """Hz -> cents above 10 Hz (mir_eval convention); zeros stay zero."""

    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    cents = np.zeros_like(freqs)
    positive = freqs > 0
    cents[positive] = 1200.0 * np.log2(freqs[positive] / 10.0)

    return cents


def _resample_pitch_list(times, pitch_list, target_times):
    """Resample ragged per-frame frequency lists onto new times (nearest)."""

    times = np.asarray(times, dtype=float)
    target_times = np.asarray(target_times, dtype=float)

    if not len(times):
        return [np.array([])] * len(target_times)

    idcs = np.searchsorted(times, target_times)
    idcs = np.clip(idcs, 0, len(times) - 1)
    prev = np.clip(idcs - 1, 0, len(times) - 1)
    use_prev = np.abs(target_times - times[prev]) <= np.abs(times[idcs] - target_times)
    nearest = np.where(use_prev, prev, idcs)

    return [np.atleast_1d(pitch_list[i]) for i in nearest]


def multipitch_metrics(ref_time, ref_freqs, est_time, est_freqs, window=50.0):
    """Frame-level multi-F0 metrics (``mir_eval.multipitch``-style).

    ``ref_freqs`` / ``est_freqs`` are ragged lists of per-frame frequency
    arrays (Hz). Estimates are resampled onto the reference time grid, then
    matched per frame by maximum bipartite matching within ``window`` cents.
    Returns a dict with ``Precision``, ``Recall``, and ``Accuracy``.
    """

    ref_time = np.asarray(ref_time, dtype=float)
    est_time = np.asarray(est_time, dtype=float)

    if len(ref_time) == 0:
        return {'Precision': 0.0, 'Recall': 0.0, 'Accuracy': 0.0}

    if len(est_time) != len(ref_time) or not np.allclose(est_time, ref_time):
        est_freqs = _resample_pitch_list(est_time, est_freqs, ref_time)

    n_ref_total, n_est_total, n_tp = 0, 0, 0

    for ref_frame, est_frame in zip(ref_freqs, est_freqs):
        ref_cents = _freqs_to_cents(ref_frame)
        est_cents = _freqs_to_cents(est_frame)

        n_ref, n_est = len(ref_cents), len(est_cents)
        n_ref_total += n_ref
        n_est_total += n_est

        if n_ref and n_est:
            hits = np.abs(ref_cents[:, None] - est_cents[None, :]) <= window
            n_tp += len(_maximum_bipartite_matching(hits))

    precision = n_tp / n_est_total if n_est_total else 0.0
    recall = n_tp / n_ref_total if n_ref_total else 0.0
    denom = n_est_total + n_ref_total - n_tp
    accuracy = n_tp / denom if denom else 0.0

    return {'Precision': precision, 'Recall': recall, 'Accuracy': accuracy}
