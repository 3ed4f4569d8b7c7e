"""The port's native transcription metrics vs the JAX package's
(``amt_tools_tpu.metrics``), on host numpy.

Both are the same numpy and scipy arithmetic, so the match lists must be
equal and the floats within 1e-12 (the tolerance leaves room for nothing
but a changed summation order, which neither side has).
"""

import numpy as np
import pytest

from amt_tools_tpu import metrics as jax_metrics

from amt_tools_tpu_torch import metrics

FLOAT_TOL = 1e-12


def _notes(rng, count, duration=4.0, low=40, high=52):
    onsets = np.sort(rng.uniform(0, duration, count))
    offsets = onsets + rng.uniform(0.02, 0.6, count)
    pitches = 440.0 * 2.0 ** ((rng.randint(low, high, count) - 69) / 12)
    return np.stack([onsets, offsets], axis=1), pitches


def _jitter(rng, intervals, pitches, onset_sd=0.03, cents_sd=30.0):
    shifted = intervals + rng.normal(0, onset_sd, intervals.shape)
    shifted[:, 1] = np.maximum(shifted[:, 1], shifted[:, 0] + 0.01)
    return shifted, pitches * 2.0 ** (rng.normal(0, cents_sd, len(pitches))
                                      / 1200.0)


def _cases():
    rng = np.random.RandomState(0)
    ref_i, ref_p = _notes(rng, 30)
    est_i, est_p = _jitter(rng, ref_i, ref_p)
    empty_i, empty_p = np.empty((0, 2)), np.empty(0)

    # Onsets exactly at the 50 ms tolerance and pitches exactly at 50 cents
    # (both sides of the edge), and offsets at the 20% / 50 ms bound
    edge_ref_i = np.array([[1.0, 2.0], [3.0, 3.1], [5.0, 6.0], [7.0, 8.0]])
    edge_ref_p = np.array([220.0, 330.0, 440.0, 550.0])
    edge_est_i = np.array([[1.05, 2.2], [2.95, 3.15], [5.0500001, 6.0],
                           [7.0, 8.2000001]])
    edge_est_p = np.array([220.0 * 2 ** (50 / 1200), 330.0,
                           440.0, 550.0 * 2 ** (50.0001 / 1200)])

    # Many-to-many candidates: a greedy first-fit matches 2 of 3, the
    # maximum matching 3 of 3
    mm_ref_i = np.array([[0.00, 1.0], [0.04, 1.0], [0.08, 1.0]])
    mm_ref_p = np.full(3, 261.63)
    mm_est_i = np.array([[0.03, 1.0], [0.00, 1.0], [0.11, 1.0]])
    mm_est_p = np.full(3, 261.63)

    return {
        'random': (ref_i, ref_p, est_i, est_p),
        'empty_reference': (empty_i, empty_p, est_i, est_p),
        'empty_estimate': (ref_i, ref_p, empty_i, empty_p),
        'tolerance_edges': (edge_ref_i, edge_ref_p, edge_est_i, edge_est_p),
        'many_to_many': (mm_ref_i, mm_ref_p, mm_est_i, mm_est_p),
    }


CASES = _cases()


@pytest.mark.parametrize('offset_ratio', [None, 0.2])
@pytest.mark.parametrize('case', sorted(CASES))
def test_match_notes_and_scores_match_jax(case, offset_ratio):
    ref_i, ref_p, est_i, est_p = CASES[case]

    got = metrics.match_notes(ref_i, ref_p, est_i, est_p,
                              offset_ratio=offset_ratio)
    want = jax_metrics.match_notes(ref_i, ref_p, est_i, est_p,
                                   offset_ratio=offset_ratio)
    assert got == want

    scores = metrics.precision_recall_f1_overlap(
        ref_i, ref_p, est_i, est_p, offset_ratio=offset_ratio)
    ref_scores = jax_metrics.precision_recall_f1_overlap(
        ref_i, ref_p, est_i, est_p, offset_ratio=offset_ratio)
    np.testing.assert_allclose(scores, ref_scores, atol=FLOAT_TOL, rtol=0)


def test_bipartite_matching_beats_greedy():
    ref_i, ref_p, est_i, est_p = CASES['many_to_many']

    assert len(metrics.match_notes(ref_i, ref_p, est_i, est_p)) == 3


def _pitch_lists(rng, frames, max_voices=4):
    return [440.0 * 2.0 ** ((rng.randint(40, 60, rng.randint(0, max_voices))
                             - 69) / 12) for _ in range(frames)]


@pytest.mark.parametrize('window', [50.0, 100.0])
@pytest.mark.parametrize('resample', [False, True])
def test_multipitch_metrics_match_jax(window, resample):
    rng = np.random.RandomState(3)
    ref_time = np.arange(60) * 0.032
    ref_freqs = _pitch_lists(rng, 60)
    if resample:
        est_time = np.arange(45) * 0.043
        est_freqs = _pitch_lists(rng, 45)
    else:
        est_time = ref_time
        est_freqs = [f * 2.0 ** (rng.normal(0, 40, len(f)) / 1200.0)
                     for f in ref_freqs]

    got = metrics.multipitch_metrics(ref_time, ref_freqs, est_time,
                                     est_freqs, window=window)
    want = jax_metrics.multipitch_metrics(ref_time, ref_freqs, est_time,
                                          est_freqs, window=window)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=FLOAT_TOL,
                                   rtol=0)


def test_multipitch_metrics_empty_reference():
    assert (metrics.multipitch_metrics([], [], [0.0], [np.array([440.0])]) ==
            jax_metrics.multipitch_metrics([], [], [0.0],
                                           [np.array([440.0])]))


@pytest.mark.parametrize('precision,recall', [(0.0, 0.0), (0.5, 0.25),
                                              (1.0, 1.0)])
def test_f_measure_matches_jax(precision, recall):
    assert metrics.f_measure(precision, recall) == \
        jax_metrics.f_measure(precision, recall)
    assert metrics.EPSILON == jax_metrics.EPSILON
