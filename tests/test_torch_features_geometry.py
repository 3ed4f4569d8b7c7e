"""The port's frame geometry against the JAX package's, on the CPU.

``get_sample_range``, ``get_num_samples_required``, ``divisor_pad`` and
``frame_pad`` are integer contracts: equal values, centred and uncentred.
JAX's arithmetic is ported as it is, also where it disagrees with itself
(at N = 2148 uncentred, ``get_expected_frames`` says 2 frames and the STFT
makes 1). A ``SyntheticPiano`` crop on uncentred mel features takes JAX's
crop length; its audio and ground truth are bit for bit equal, its
features within the mel tolerance 4e-4 (``ops/pallas_stft.py:30``).
"""

import numpy as np
import pytest
import torch

from amt_tools_tpu import datasets as jdatasets
from amt_tools_tpu import features as jfeatures
from amt_tools_tpu.features.waveform import \
    WaveformWrapper as JaxWaveformWrapper

from amt_tools_tpu_torch import datasets, features, tools

MEL_TOL = 4e-4
FRAMES = (0, 1, 2, 3, 10, 100)
SAMPLES = (1, 2047, 2048, 2148, 3584, 5000)


def _pairs(center):
    """(JAX module, port module) with n_fft 2048 and hop 512."""

    return [(jfeatures.MelSpec(center=center), features.MelSpec(center=center)),
            (jfeatures.STFT(center=center), features.STFT(center=center)),
            (JaxWaveformWrapper(hop_length=512, win_length=2048,
                                center=center),
             features.WaveformWrapper(hop_length=512, win_length=2048,
                                      center=center))]


@pytest.mark.parametrize('center', [True, False])
@pytest.mark.parametrize('num_frames', FRAMES)
def test_sample_range_matches_jax(center, num_frames):
    for ref, got in _pairs(center):
        np.testing.assert_array_equal(got.get_sample_range(num_frames),
                                      ref.get_sample_range(num_frames))
        assert (got.get_num_samples_required() ==
                ref.get_num_samples_required())


def test_uncentred_sample_range_values():
    """The values the centred algebra got wrong: [1, 2048], [2561, 3072]
    and [6145, 6656] at 1, 3 and 10 frames."""

    mel = features.MelSpec(center=False)
    for num_frames, (low, high) in {1: (1, 2048), 3: (2561, 3072),
                                    10: (6145, 6656)}.items():
        span = mel.get_sample_range(num_frames)
        assert (span[0], span[-1]) == (low, high)


@pytest.mark.parametrize('center', [True, False])
@pytest.mark.parametrize('num_samples', SAMPLES)
def test_frame_pad_and_divisor_pad_match_jax(center, num_samples):
    audio = np.random.RandomState(num_samples).randn(num_samples).astype(
        np.float32)
    for ref, got in _pairs(center):
        want = ref.frame_pad(audio)
        padded = got.frame_pad(audio)
        assert padded.dtype == want.dtype
        np.testing.assert_array_equal(padded, want)
        # A tensor pads on its own device to the same values
        np.testing.assert_array_equal(
            got.frame_pad(torch.from_numpy(audio)).numpy(), want)
        assert got.get_expected_frames(audio) == ref.get_expected_frames(audio)

        for divisor in (512, 2048, 7):
            np.testing.assert_array_equal(
                got.divisor_pad(audio, divisor),
                ref.divisor_pad(audio, divisor))


@pytest.mark.parametrize('num_samples', SAMPLES)
def test_uncentred_framing_matches_jax(num_samples):
    """The raw framed features: uncentred audio is padded to whole frames
    first, as JAX's ``process_jax`` does."""

    audio = np.random.RandomState(7).randn(num_samples).astype(np.float32)
    for center in (True, False):
        ref = JaxWaveformWrapper(hop_length=512, win_length=2048,
                                 center=center)
        got = features.WaveformWrapper(hop_length=512, win_length=2048,
                                       center=center)
        want = np.asarray(ref.process_jax(audio))
        frames = got.process(torch.from_numpy(audio)).numpy()
        assert frames.shape == want.shape
        np.testing.assert_array_equal(frames, want)


def test_null_features_match_jax():
    for center in (True, False):
        for ref, got in _pairs(center):
            want = ref.get_null_features()
            assert got.get_null_features().shape == want.shape
            assert got.get_null_features().dtype == want.dtype
    assert features.MelSpec().process_audio(
        np.zeros(0, np.float32)).shape == (1, 229, 0)


def test_synthetic_piano_crops_uncentred_features_as_jax():
    kwargs = dict(num_tracks=1, track_duration=3.0, num_frames=10, seed=4)
    jax_set = jdatasets.SyntheticPiano(
        data_proc=jfeatures.MelSpec(n_mels=32, htk=True, center=False),
        **kwargs)
    port_set = datasets.SyntheticPiano(
        data_proc=features.MelSpec(n_mels=32, htk=True, center=False),
        device='cpu', **kwargs)

    # The longest audio that gives 10 uncentred frames
    assert port_set.seq_length == jax_set.seq_length == 6656

    track = jax_set.tracks[0]
    for start in (0, 777, 20000):
        ref = jax_set.get_track_data(track, sample_start=start)
        got = port_set.get_track_data(track, sample_start=start)
        assert sorted(got) == sorted(ref)
        assert got[tools.KEY_AUDIO].shape == (6656,)
        for key, value in ref.items():
            if key == tools.KEY_FEATS:
                assert got[key].shape == value.shape
                assert np.abs(got[key] - value).max() <= MEL_TOL
            elif isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key
