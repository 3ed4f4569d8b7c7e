"""The port's synthetic piano dataset, loader and feature entry point against
the JAX package's, on the CPU.

Tracks, ground truth, crops and loader batches are host numpy and must be
bit for bit equal; only the features differ, by the mel tolerance 4e-4 on
the [0, 1] scale (``amt_tools_tpu/ops/pallas_stft.py:30``): the port's
float32 STFT sums in another order than XLA's.
"""

import numpy as np
import pytest

from amt_tools_tpu import datasets as jdatasets
from amt_tools_tpu import features as jfeatures

from amt_tools_tpu_torch import datasets, features, tools

MEL_TOL = 4e-4


def _pair(**kwargs):
    jax_set = jdatasets.SyntheticPiano(
        data_proc=jfeatures.MelSpec(n_mels=32, htk=True), **kwargs)
    port_set = datasets.SyntheticPiano(
        data_proc=features.MelSpec(n_mels=32, htk=True), device='cpu',
        **kwargs)
    return jax_set, port_set


def _assert_batches_equal(ref, got):
    assert sorted(ref) == sorted(got)
    for key in ref:
        if key == tools.KEY_FEATS:
            assert got[key].dtype == ref[key].dtype == np.float32
            assert got[key].shape == ref[key].shape
            assert np.abs(got[key] - ref[key]).max() <= MEL_TOL
        elif isinstance(ref[key], np.ndarray):
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            assert got[key] == ref[key], key


def test_tracks_and_ground_truth_are_equal():
    jax_set, port_set = _pair(num_tracks=2, track_duration=2.0, seed=1,
                              velocity_range=(0.3, 1.0), timbre_jitter=0.2,
                              noise_snr_db=30.0, reverb_time=0.05)
    assert port_set.tracks == jax_set.tracks
    for track in jax_set.tracks:
        ref, got = jax_set.data[track], port_set.data[track]
        assert sorted(got) == sorted(ref)
        for key, value in ref.items():
            if isinstance(value, np.ndarray):
                assert got[key].dtype == value.dtype, key
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key


@pytest.mark.parametrize('num_workers', [0, 2])
def test_loader_batches_are_equal(num_workers):
    jax_set, port_set = _pair(num_tracks=5, track_duration=3.0, num_frames=40,
                              seed=2)
    jax_loader = jdatasets.DataLoader(jax_set, batch_size=2, seed=3,
                                      num_workers=num_workers)
    port_loader = datasets.DataLoader(port_set, batch_size=2, seed=3,
                                      num_workers=num_workers)

    for _ in range(2):  # two passes: the shuffle and crop RNGs advance
        ref, got = list(jax_loader), list(port_loader)
        assert len(got) == len(ref) == 3
        for a, b in zip(ref, got):
            assert a[tools.KEY_FEATS].shape == (len(a[tools.KEY_TRACK]), 1,
                                                32, 40)
            _assert_batches_equal(a, b)


def test_crops_are_equal():
    jax_set, port_set = _pair(num_tracks=1, track_duration=3.0, num_frames=25,
                              seed=4)
    track = jax_set.tracks[0]
    for start in (0, 777, 20000):
        ref = jax_set.get_track_data(track, sample_start=start)
        got = port_set.get_track_data(track, sample_start=start)
        np.testing.assert_array_equal(got[tools.KEY_NOTES],
                                      ref[tools.KEY_NOTES])
        ref.pop(tools.KEY_NOTES), got.pop(tools.KEY_NOTES)
        _assert_batches_equal(ref, got)


@pytest.mark.parametrize('num_frames', [0, 1, 2, 625])
def test_sample_range_is_equal(num_frames):
    ref = jfeatures.MelSpec().get_sample_range(num_frames)
    got = features.MelSpec().get_sample_range(num_frames)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('num_samples', [16000, 23456, 0])
def test_process_audio_matches_jax(num_samples):
    audio = np.random.RandomState(5).randn(num_samples).astype(np.float32)
    ref = jfeatures.MelSpec(n_mels=229, htk=True).process_audio(audio)
    got = features.MelSpec(n_mels=229, htk=True).process_audio(audio,
                                                               device='cpu')

    assert got.dtype == np.float32 and got.shape == ref.shape
    if num_samples:
        assert np.abs(got - ref).max() <= MEL_TOL


def test_save_data_cache_is_not_ported(tmp_path):
    """The npz feature cache is ported now (the name is the one the test
    had when ``save_data`` raised): each package writes the same files,
    whose features agree within the mel tolerance."""

    kwargs = dict(num_tracks=1, track_duration=1.0, save_data=True)
    jax_set, port_set = (
        jdatasets.SyntheticPiano(data_proc=jfeatures.MelSpec(n_mels=32),
                                 save_loc=str(tmp_path / 'jax'), **kwargs),
        datasets.SyntheticPiano(data_proc=features.MelSpec(n_mels=32),
                                save_loc=str(tmp_path / 'port'),
                                device='cpu', **kwargs))
    for dataset in (jax_set, port_set):
        dataset.get_track_data(dataset.tracks[0])
    cached = [tools.load_dict_npz(str(tmp_path / name / 'SyntheticPiano' /
                                      'MelSpec' / 'train_000.npz'))
              for name in ('jax', 'port')]
    assert sorted(cached[1]) == sorted(cached[0])
    assert np.abs(cached[1][tools.KEY_FEATS] -
                  cached[0][tools.KEY_FEATS]).max() <= MEL_TOL
