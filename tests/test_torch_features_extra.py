"""The port's remaining features against the JAX package's, on the CPU.

``HVQT``/``HCQT``, ``SignalPower`` and ``FeatureCombo`` through
:meth:`process` on CPU tensors (the kernels' plain versions) against
``process_jax``, with their frame algebra (sample ranges, frame counts,
times, ``features_name``) equal; and ``AudioFileStream`` against JAX's over
the same WAV. Tolerances on the [0, 1] features: 2e-4 for the constant-Q
transforms (``amt_tools_tpu/features/cqt.py:29``), 4e-4 for the mel
spectrogram (``amt_tools_tpu/ops/pallas_stft.py:30``); 1e-4 dB for the
signal power, a float32 sum of squares in another order. The stream's frames
are held to JAX's unbucketed function, as in ``tests/test_torch_online.py``
(JAX's ``process_audio`` pads a one-frame clip to its length bucket, which
moves a centred frame's dB reference).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amt_tools_tpu import features as jfeatures
from amt_tools_tpu import tools as jtools
from amt_tools_tpu.features import stream as jstream

from amt_tools_tpu_torch import features, tools
from amt_tools_tpu_torch.features import stream

CQT_TOL = 2e-4
MEL_TOL = 4e-4
POWER_DB_TOL = 1e-4


def _audio(count, seconds, fs, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * fs)) / fs
    freqs = rng.uniform(60, 2000, (count, 3, 1))
    tones = (0.3 * np.sin(2 * np.pi * freqs * t)).sum(1)
    return (tones + 0.01 * rng.randn(count, len(t))).astype(np.float32)


def _port(module, audio):
    with torch.inference_mode():
        return module.process(torch.from_numpy(audio)).numpy()


def _same_algebra(jax_module, port_module, audio):
    assert port_module.features_name() == jax_module.features_name()
    assert port_module.get_num_channels() == jax_module.get_num_channels()
    assert port_module.get_feature_size() == jax_module.get_feature_size()
    assert (port_module.get_expected_frames(audio) ==
            jax_module.get_expected_frames(audio))
    for frames in (1, 2, 7):
        try:
            ref = jax_module.get_sample_range(frames)
        except ValueError:
            # Modules whose sample ranges do not meet
            with pytest.raises(ValueError, match='incompatible'):
                port_module.get_sample_range(frames)
            continue
        np.testing.assert_array_equal(port_module.get_sample_range(frames),
                                      ref)
    np.testing.assert_array_equal(port_module.get_times(audio),
                                  jax_module.get_times(audio))


@pytest.mark.parametrize('name,kwargs', [
    ('HCQT', {}),
    ('HCQT', {'harmonics': [2, 0.5, 1], 'decibels': False}),
    ('HVQT', {'gamma': None}),
    ('HVQT', {'gamma': 3.0, 'harmonics': [1, 3]})])
def test_harmonic_transforms_match_jax(name, kwargs):
    common = dict(sample_rate=22050, hop_length=512, fmin=65.4, n_bins=24,
                  bins_per_octave=12)
    if name == 'HCQT':
        kwargs.pop('gamma', None)
    jax_module = getattr(jfeatures, name)(**common, **kwargs)
    port_module = getattr(features, name)(**common, **kwargs)
    audio = _audio(2, 0.4, 22050)

    assert port_module.harmonics == jax_module.harmonics
    assert [m.fmin for m in port_module.modules] == [
        m.fmin for m in jax_module.modules]
    _same_algebra(jax_module, port_module, audio)
    np.testing.assert_array_equal(port_module.get_times(audio, at_start=True),
                                  jax_module.get_times(audio, at_start=True))

    ref = np.asarray(jax_module.process_jax(jnp.asarray(audio)))
    got = _port(port_module, audio)
    assert got.shape == ref.shape == (2, len(port_module.harmonics), 24,
                                      1 + audio.shape[-1] // 512)
    if kwargs.get('decibels', True):
        np.testing.assert_allclose(got, ref, rtol=0, atol=CQT_TOL)
    else:
        peak = ref.max(axis=(-2, -1), keepdims=True)
        np.testing.assert_allclose(got / peak, ref / peak, rtol=0, atol=1e-5)

    # The host entry point gives the same features as the tensor function
    np.testing.assert_array_equal(port_module.process_audio(audio[0],
                                                            device='cpu'),
                                  got[0])


def test_hcqt_default_harmonics_and_kernel_settings():
    """DeepSalience's harmonics, each a full-bank float32 VQT (kernel C on
    its FFMA route on the card), as the JAX class's VQT defaults."""

    module = features.HCQT(n_bins=12)
    assert module.harmonics == [0.5, 1, 2, 3, 4, 5]
    assert module.get_num_channels() == 6
    assert all(m.exact is True and m._groups is None for m in module.modules)
    assert module.features_name() == jfeatures.HCQT.features_name()


@pytest.mark.parametrize('kwargs', [
    {}, {'win_length': 1024}, {'center': False},
    {'center': False, 'win_length': 700, 'hop_length': 256},
    {'decibels': False}])
def test_signal_power_matches_jax(kwargs):
    jax_module = jfeatures.SignalPower(sample_rate=16000, **kwargs)
    port_module = features.SignalPower(sample_rate=16000, **kwargs)
    audio = _audio(3, 0.5, 16000, seed=1)
    audio[1] *= 0.01  # each track its own dB reference
    if not kwargs.get('center', True):
        # JAX pads uncentred audio on the host as one track
        audio = audio[1]

    _same_algebra(jax_module, port_module, audio)
    ref = np.asarray(jax_module.process_jax(jnp.asarray(audio)))
    got = _port(port_module, audio)
    assert got.shape == ref.shape == audio.shape[:-1] + (
        port_module.get_expected_frames(audio),)
    if kwargs.get('decibels', True):
        np.testing.assert_allclose(got, ref, rtol=0, atol=POWER_DB_TOL)
        assert np.allclose(got.max(axis=-1), 0.0)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    assert port_module.get_null_features().shape == (0,)
    assert port_module.process_audio(np.zeros(0), device='cpu').shape == (0,)


def test_feature_combo_matches_jax():
    def combos(package):
        return [
            # Centred and uncentred: the uncentred module has fewer frames,
            # and no crop length suits both
            package.FeatureCombo([
                package.MelSpec(n_mels=32),
                package.MelSpec(n_mels=32, htk=True, center=False)]),
            package.FeatureCombo([
                package.CQT(sample_rate=16000, n_bins=32, fmin=65.4),
                package.HCQT(sample_rate=16000, n_bins=32, fmin=65.4,
                             harmonics=[1, 2])])]

    audio = _audio(1, 0.5, 16000, seed=2)[0]
    for jax_module, port_module, tol in zip(combos(jfeatures),
                                            combos(features),
                                            (MEL_TOL, CQT_TOL)):
        _same_algebra(jax_module, port_module, audio)
        ref = np.asarray(jax_module.process_jax(jnp.asarray(audio)))
        got = _port(port_module, audio)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)

    mel_combo = combos(features)[0]
    assert mel_combo.features_name() == 'MelSpec+MelSpec'
    frames = [_port(m, audio).shape[-1] for m in mel_combo.modules]
    assert frames[1] < frames[0]
    assert _port(mel_combo, audio).shape[-1] == frames[1]

    with pytest.raises(ValueError, match='feature size'):
        features.FeatureCombo([features.MelSpec(n_mels=32),
                               features.MelSpec(n_mels=16)])
    with pytest.raises(ValueError, match='sample rate'):
        features.FeatureCombo([features.MelSpec(n_mels=32),
                               features.MelSpec(n_mels=32, sample_rate=8000)])
    with pytest.raises(ValueError):
        features.FeatureCombo([])


def test_feature_combo_keys_the_dataset_cache(tmp_path):
    from amt_tools_tpu_torch.datasets import SyntheticPiano

    combo = features.FeatureCombo([features.MelSpec(n_mels=16),
                                   features.MelSpec(n_mels=16, htk=True)])
    dataset = SyntheticPiano(data_proc=combo, num_tracks=1,
                             track_duration=1.0, save_data=True,
                             save_loc=str(tmp_path), device='cpu')
    data = dataset.get_track_data(dataset.tracks[0])
    assert data[tools.KEY_FEATS].shape == (2, 16, 32)
    assert (tmp_path / 'SyntheticPiano' / 'MelSpec+MelSpec' /
            'train_000.npz').exists()


class _Unbucketed:
    """A JAX feature module whose ``process_audio`` runs ``process_jax`` on
    the audio as it is, without the length bucket."""

    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        return getattr(self.module, name)

    def process_audio(self, audio):
        return np.asarray(self.module.process_jax(jnp.asarray(audio)))


def test_audio_file_stream_matches_jax(tmp_path):
    """A 22.05 kHz WAV streamed at 16 kHz: the same resampled, normalized
    audio as JAX's stream, and the same frames one hop apart."""

    path = str(tmp_path / 'clip.wav')
    tools.write_wav(path, _audio(1, 0.4, 22050, seed=3)[0], 22050)

    ref_stream = jstream.AudioFileStream(
        _Unbucketed(jfeatures.MelSpec(n_mels=32)), frame_buffer_size=2,
        audio_path=path)
    got_stream = stream.AudioFileStream(
        features.MelSpec(n_mels=32), frame_buffer_size=2, audio_path=path,
        feature_device='cpu')
    np.testing.assert_array_equal(got_stream.original_audio,
                                  ref_stream.original_audio)
    expected, _ = tools.load_normalize_audio(path, fs=16000)
    np.testing.assert_array_equal(got_stream.audio, expected)

    for s in (ref_stream, got_stream):
        s.start_streaming()
    count = 0
    while not got_stream.query_finished():
        assert not ref_stream.query_finished()
        ref = ref_stream.extract_frame_features()
        got = got_stream.extract_frame_features()
        assert got.shape == ref.shape == (1, 32, 1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=MEL_TOL)
        count += 1
    assert ref_stream.query_finished()
    assert count == 1 + len(expected) // 512

    # Another normalization reaches the audio
    peak = stream.AudioFileStream(features.MelSpec(n_mels=32),
                                  audio_path=path, audio_norm=None,
                                  feature_device='cpu')
    np.testing.assert_array_equal(
        peak.audio, jtools.load_normalize_audio(path, fs=16000, norm=None)[0])
