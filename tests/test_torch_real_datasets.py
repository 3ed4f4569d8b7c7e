"""The port's real-corpus datasets against the JAX package's, on the CPU.

MAPS, MAESTRO V3, GuitarSet and ``DatasetCombo`` over the miniature
corpora of ``tests/fixtures/corpora.py`` (built once for the module with
the JAX package's writers), each package with its own ``save_loc``. Track
lists, ground truth, crops and written caches are host numpy in both
packages and held bit for bit; only the features differ, by the tolerance
of their transform on the [0, 1] scale: 4e-4 for the mel features
(``amt_tools_tpu/ops/pallas_stft.py:30``) and 2e-4 for the CQT
(``amt_tools_tpu/features/cqt.py:29``), float32 sums in another order.
Also: a second construction reads the npz caches instead of computing, and
the download chains run against a server on 127.0.0.1.
"""

import http.server
import os
import sys
import threading
import zipfile
from pathlib import Path

import numpy as np
import pytest

from amt_tools_tpu import datasets as jdatasets
from amt_tools_tpu import features as jfeatures
from amt_tools_tpu import tools as jtools

from amt_tools_tpu_torch import datasets, features, tools

sys.path.insert(0, str(Path(__file__).resolve().parent / 'fixtures'))
from corpora import (make_guitarset_corpus, make_maestro_corpus,  # noqa: E402
                     make_maps_corpus)

MEL_TOL = 4e-4
CQT_TOL = 2e-4


@pytest.fixture(scope='module')
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp('corpora')
    return {'maps': make_maps_corpus(str(root / 'MAPS')),
            'gset': make_guitarset_corpus(str(root / 'GuitarSet')),
            'maestro': make_maestro_corpus(str(root / 'MAESTRO_V3'))}


def _mel(port):
    module = features if port else jfeatures
    return module.MelSpec(n_mels=32, htk=True)


def _cqt(port):
    module = features if port else jfeatures
    return module.CQT(n_bins=36, bins_per_octave=12, fmin=82.41)


def _pair(port_cls, jax_cls, tmp_path, data_proc, **kwargs):
    """The same dataset in both packages, each with its own cache."""

    jax_set = jax_cls(data_proc=data_proc(False),
                      save_loc=str(tmp_path / 'jax'), **kwargs)
    port_set = port_cls(data_proc=data_proc(True),
                        save_loc=str(tmp_path / 'port'), device='cpu',
                        **kwargs)
    return jax_set, port_set


def _assert_track_equal(ref, got, feature_tol):
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        if key == tools.KEY_FEATS:
            assert got[key].dtype == value.dtype and got[key].shape == value.shape
            assert np.abs(got[key] - value).max() <= feature_tol
        elif isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        elif isinstance(value, dict):
            assert list(got[key]) == list(value), key
            for k in value:
                for r, g in zip(value[k], got[key][k]):
                    np.testing.assert_array_equal(g, r, err_msg=f'{key} {k}')
        else:
            assert type(got[key]) is type(value) and got[key] == value, key


def test_maps_tracks_ground_truth_and_features_equal_jax(corpora, tmp_path):
    splits = ['AkPnBcht', 'ENSTDkAm', 'SptkBGCl']
    jax_set, port_set = _pair(datasets.MAPS, jdatasets.MAPS, tmp_path, _mel,
                              base_dir=corpora['maps'], splits=splits)
    assert port_set.tracks == jax_set.tracks
    assert len(port_set.tracks) == 5

    for track in jax_set.tracks:
        # The RAM cache: ground truth as loaded (and written to the npz)
        _assert_track_equal(jax_set.data[track], port_set.data[track], 0)
        notes = port_set.data[track][tools.KEY_NOTES]
        assert notes.shape[1] == 3 and len(notes)
        assert port_set.data[track][tools.KEY_VELOCITY].max() <= 1.0

    track = jax_set.tracks[1]
    _assert_track_equal(jax_set.get_track_data(track),
                        port_set.get_track_data(track), MEL_TOL)
    for port in (False, True):
        gt = tmp_path / ('port' if port else 'jax') / 'MAPS'
        assert sorted(p.name for p in (gt / 'ground_truth').iterdir()) == [
            f'{t}.npz' for t in sorted(jax_set.tracks)]
        assert sorted(p.name for p in (gt / 'MelSpec').iterdir()) == [
            f'{track}.npz']

    remaining = {}
    for name, dataset in (('jax', jax_set), ('port', port_set)):
        dataset.remove_overlapping(['ENSTDkAm'])
        remaining[name] = (list(dataset.tracks), sorted(dataset.data))
    assert remaining['port'] == remaining['jax']
    assert not any('common' in t for t in remaining['port'][0])
    assert len(remaining['port'][0]) == 2

    with pytest.raises(RuntimeError, match='manually'):
        datasets.MAPS.download(str(tmp_path / 'nowhere'))


def test_maestro_track_lists_ground_truth_and_crops_equal_jax(corpora,
                                                              tmp_path):
    for split in ('train', 'validation', 'test'):
        jax_set, port_set = _pair(datasets.MAESTRO_V3, jdatasets.MAESTRO_V3,
                                  tmp_path / split, _mel,
                                  base_dir=corpora['maestro'], splits=[split],
                                  save_data=False)
        assert port_set.tracks == jax_set.tracks and len(port_set.tracks) == 2

    # Each split's tracks sorted, the splits in their order
    jax_set, port_set = _pair(datasets.MAESTRO_V3, jdatasets.MAESTRO_V3,
                              tmp_path / 'all', _mel,
                              base_dir=corpora['maestro'], num_frames=20,
                              seed=3)
    assert port_set.tracks == jax_set.tracks
    assert [t.split('_')[-2] for t in port_set.tracks[::2]] == [
        'train', 'validation', 'test']
    assert port_set.get_midi_path(port_set.tracks[0]).endswith('.midi')

    for track in jax_set.tracks[:2]:
        _assert_track_equal(jax_set.load(track), port_set.load(track), 0)

    # Seeded crops at the same seed: the dataset's own stream, then the
    # loader's per-item generators
    for index in (0, 3, 5, 0):
        _assert_track_equal(jax_set[index], port_set[index], MEL_TOL)
    for seed in (11, 12):
        _assert_track_equal(
            jax_set.get_item(2, rng=np.random.RandomState(seed)),
            port_set.get_item(2, rng=np.random.RandomState(seed)), MEL_TOL)

    with pytest.raises(NotImplementedError):
        port_set.remove_overlapping(['test'])


def test_guitarset_tracks_tablature_and_features_equal_jax(corpora,
                                                           tmp_path):
    jax_all, port_all = _pair(datasets.GuitarSet, jdatasets.GuitarSet,
                              tmp_path / 'all', _cqt, base_dir=corpora['gset'],
                              sample_rate=22050, store_data=False,
                              save_data=False)
    assert port_all.tracks == jax_all.tracks and len(port_all.tracks) == 360
    for split in port_all.available_splits():
        assert (port_all.get_tracks(split) == jax_all.get_tracks(split) ==
                port_all.tracks[int(split) * 60: int(split) * 60 + 60])

    jax_set, port_set = _pair(datasets.GuitarSet, jdatasets.GuitarSet,
                              tmp_path, _cqt, base_dir=corpora['gset'],
                              splits=['03'], sample_rate=22050, num_frames=8,
                              seed=5, preload_workers=4)
    assert port_set.tracks == jax_set.tracks
    for track in jax_set.tracks:
        _assert_track_equal(jax_set.data[track], port_set.data[track], 0)
    tablature = port_set.data[port_set.tracks[0]][tools.KEY_TABLATURE]
    assert tablature.shape[0] == 6 and (tablature >= 0).any()

    for track in jax_set.tracks[:3]:
        _assert_track_equal(jax_set.get_track_data(track),
                            port_set.get_track_data(track), CQT_TOL)
    for seed in (1, 2):
        _assert_track_equal(
            jax_set.get_item(7, rng=np.random.RandomState(seed)),
            port_set.get_item(7, rng=np.random.RandomState(seed)), CQT_TOL)


def test_dataset_combo_equals_jax(corpora, tmp_path):
    def combo(port):
        package = datasets if port else jdatasets
        extra = {'device': 'cpu'} if port else {}
        save_loc = str(tmp_path / ('port' if port else 'jax'))
        maps = package.MAPS(base_dir=corpora['maps'], splits=['StbgTGd2'],
                            data_proc=_mel(port), num_frames=12,
                            save_loc=save_loc, **extra)
        maestro = package.MAESTRO_V3(base_dir=corpora['maestro'],
                                     splits=['test'], data_proc=_mel(port),
                                     num_frames=12, save_loc=save_loc,
                                     **extra)
        return package.DatasetCombo([maps, maestro])

    jax_combo, port_combo = combo(False), combo(True)
    assert port_combo.tracks == jax_combo.tracks and len(port_combo) == 3
    assert port_combo.dataset_name() == 'DatasetCombo'
    for index in range(3):
        _assert_track_equal(
            jax_combo.get_item(index, rng=np.random.RandomState(index)),
            port_combo.get_item(index, rng=np.random.RandomState(index)),
            MEL_TOL)
        track = jax_combo.tracks[index]
        assert (port_combo.get_track_frames(track) ==
                jax_combo.get_track_frames(track))
    with pytest.raises(KeyError):
        port_combo.get_track_data('missing')
    with pytest.raises(ValueError):
        datasets.DatasetCombo([])

    batch = next(iter(datasets.DataLoader(port_combo, batch_size=3, seed=0,
                                          num_workers=2)))
    assert batch[tools.KEY_FEATS].shape == (3, 1, 32, 12)


def test_second_construction_reads_the_npz_caches(corpora, tmp_path,
                                                  monkeypatch):
    mel = _mel(True)
    computed, wavs = [], []
    process_audio = mel.process_audio
    monkeypatch.setattr(mel, 'process_audio',
                        lambda *a, **k: computed.append(1) or
                        process_audio(*a, **k))
    load_normalize_audio = tools.load_normalize_audio
    monkeypatch.setattr(tools, 'load_normalize_audio',
                        lambda *a, **k: wavs.append(1) or
                        load_normalize_audio(*a, **k))

    def construct(**kwargs):
        return datasets.MAESTRO_V3(base_dir=corpora['maestro'],
                                   splits=['train', 'test'], data_proc=mel,
                                   save_loc=str(tmp_path), store_data=True,
                                   device='cpu', **kwargs)

    cold = construct()
    first = {t: cold.get_track_data(t) for t in cold.tracks}
    assert len(wavs) == len(computed) == 4
    feats_dir = Path(cold.get_feats_dir())
    assert feats_dir == tmp_path / 'MAESTRO_V3' / 'MelSpec'
    assert len(list(feats_dir.rglob('*.npz'))) == 4

    warm = construct()
    for track in warm.tracks:
        again = warm.get_track_data(track)
        for key in (tools.KEY_FEATS, tools.KEY_AUDIO, tools.KEY_MULTIPITCH,
                    tools.KEY_NOTES, tools.KEY_VELOCITY):
            assert again[key].dtype == first[track][key].dtype
            np.testing.assert_array_equal(again[key], first[track][key])
    assert len(wavs) == len(computed) == 4, 'the warm pass read no WAV ' \
                                            'and computed no features'

    # The JAX package reads the port's caches: one cache serves both
    jax_mel = _mel(False)
    jax_warm = jdatasets.MAESTRO_V3(base_dir=corpora['maestro'],
                                    splits=['test'], data_proc=jax_mel,
                                    save_loc=str(tmp_path), store_data=True)
    jax_mel.process_jax = None  # would raise if it computed features
    track = jax_warm.tracks[0]
    np.testing.assert_array_equal(jax_warm.get_track_data(track)[
        tools.KEY_FEATS], first[track][tools.KEY_FEATS])

    construct(reset_data=True).get_track_data(cold.tracks[0])
    assert len(wavs) == 8 and len(computed) == 5
    assert len(list(feats_dir.rglob('*.npz'))) == 1


def test_feature_cache_warns_on_another_hop(corpora, tmp_path):
    def construct(hop):
        return datasets.MAESTRO_V3(base_dir=corpora['maestro'],
                                   splits=['test'],
                                   data_proc=features.MelSpec(
                                       n_mels=32, htk=True, hop_length=hop),
                                   hop_length=512, save_loc=str(tmp_path),
                                   device='cpu')

    construct(512).get_track_data(construct(512).tracks[0])
    dataset = construct(256)
    with pytest.warns(RuntimeWarning, match='hop length'):
        dataset.calculate_feats(dataset.load(dataset.tracks[1]))


class _StackedMixin:
    """A GuitarSet whose tracks also carry stacked notes and a stacked
    pitch list, so crops slice both."""

    def load(self, track):
        data = super().load(track)
        package = self._tools
        stacked = package.load_stacked_notes_jams(self.get_jams_path(track))
        times = self.data_proc.get_times(data[package.KEY_AUDIO])
        data[package.KEY_NOTES] = stacked
        data[package.KEY_PITCHLIST] = {
            k: (times, [np.array([p[0]]) if i % 3 else np.array([])
                        for i in range(len(times))])
            for k, (p, _) in stacked.items() if len(p)}
        return data


class _PortStacked(_StackedMixin, datasets.GuitarSet):
    _tools = tools


class _JaxStacked(_StackedMixin, jdatasets.GuitarSet):
    _tools = jtools


def test_crops_slice_stacked_notes_and_pitch_lists_as_jax(corpora, tmp_path):
    jax_set, port_set = _pair(_PortStacked, _JaxStacked, tmp_path, _cqt,
                              base_dir=corpora['gset'], splits=['01'],
                              sample_rate=22050, num_frames=10,
                              save_data=False)
    for track in jax_set.tracks[:4]:
        for start in (0, 2048, 4096):
            ref = jax_set.get_track_data(track, sample_start=start)
            got = port_set.get_track_data(track, sample_start=start)
            for key in (tools.KEY_NOTES, tools.KEY_PITCHLIST):
                assert list(got[key]) == list(ref[key])
                for string in ref[key]:
                    for r, g in zip(ref[key][string], got[key][string]):
                        if isinstance(r, list):
                            assert len(g) == len(r)
                            for rr, gg in zip(r, g):
                                np.testing.assert_array_equal(gg, rr)
                        else:
                            assert g.dtype == r.dtype
                            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(got[tools.KEY_TABLATURE],
                                          ref[tools.KEY_TABLATURE])


# Downloads against a local server

@pytest.fixture()
def fixture_server(tmp_path):
    """Serve ``tmp_path / 'www'`` on an ephemeral 127.0.0.1 port."""

    www = tmp_path / 'www'
    www.mkdir()

    def handler(*args, **kwargs):
        return http.server.SimpleHTTPRequestHandler(*args, directory=str(www),
                                                    **kwargs)

    server = http.server.ThreadingHTTPServer(('127.0.0.1', 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield www, f'http://127.0.0.1:{server.server_address[1]}'
    finally:
        server.shutdown()
        thread.join(timeout=5)


def _make_zip(zip_path, entries):
    os.makedirs(os.path.dirname(str(zip_path)), exist_ok=True)
    with zipfile.ZipFile(zip_path, 'w') as archive:
        for name, payload in entries.items():
            archive.writestr(name, payload)


def test_stream_url_resource_streams_in_chunks_and_raises(fixture_server,
                                                          tmp_path):
    www, base_url = fixture_server
    payload = np.random.RandomState(0).bytes(3 * 1024 * 1024 + 17)
    (www / 'blob.bin').write_bytes(payload)

    tools.stream_url_resource(f'{base_url}/blob.bin', str(tmp_path / 'a'),
                              chunk_size=64 * 1024)
    assert (tmp_path / 'a').read_bytes() == payload

    with pytest.raises(Exception):
        tools.stream_url_resource(f'{base_url}/missing.zip',
                                  str(tmp_path / 'b'))
    assert not (tmp_path / 'b').exists()


def test_maestro_download_reroots_the_version_directory(fixture_server,
                                                        tmp_path,
                                                        monkeypatch):
    www, base_url = fixture_server
    version = datasets.MAESTRO_V3.url_version()
    assert version == jdatasets.MAESTRO_V3.url_version()
    assert datasets.MAESTRO_V1.url_version() == 'maestro-v1.0.0'
    assert datasets.MAESTRO_V2.url_version() == 'maestro-v2.0.0'
    assert datasets.MAESTRO_V3.GCS_BASE == jdatasets.MAESTRO_V3.GCS_BASE

    _make_zip(www / version / f'{version}.zip', {
        f'{version}/{version}.csv':
            b'canonical_title,split,audio_filename\n'
            b'"Sonata, Op. 1",test,2004/perf.wav\n',
        f'{version}/2004/perf.midi': b'MThd fake'})
    monkeypatch.setattr(datasets.MAESTRO_V3, 'GCS_BASE', base_url)

    # A stale directory is cleared first
    save_dir = tmp_path / 'maestro'
    (save_dir / 'stale').mkdir(parents=True)
    datasets.MAESTRO_V3.download(str(save_dir))

    assert sorted(p.name for p in save_dir.iterdir()) == ['2004',
                                                          f'{version}.csv']
    dataset = datasets.MAESTRO_V3(base_dir=str(save_dir), splits=['test'],
                                  data_proc=_mel(True), save_data=False,
                                  device='cpu')
    assert dataset.tracks == ['2004/perf']


def test_guitarset_downloads_on_a_missing_directory(fixture_server, tmp_path,
                                                    monkeypatch):
    www, base_url = fixture_server
    assert datasets.GuitarSet.ZENODO_FILES == jdatasets.GuitarSet.ZENODO_FILES
    assert datasets.GuitarSet.ZENODO_URL == jdatasets.GuitarSet.ZENODO_URL
    _make_zip(www / 'annotation.zip',
              {'00_BN1-129-Eb_comp.jams': b'{"annotations": []}'})
    _make_zip(www / 'audio_mono-mic.zip',
              {'00_BN1-129-Eb_comp_mic.wav': b'RIFF fake'})
    monkeypatch.setattr(datasets.GuitarSet, 'ZENODO_URL', base_url)

    base_dir = tmp_path / 'GuitarSet'
    with pytest.warns(RuntimeWarning, match='Attempting to download'):
        dataset = datasets.GuitarSet(base_dir=str(base_dir), splits=['00'],
                                     data_proc=_cqt(True), store_data=False,
                                     save_data=False, device='cpu')

    assert dataset.tracks == ['00_BN1-129-Eb_comp']
    assert (base_dir / 'audio_mono-mic' / '00_BN1-129-Eb_comp_mic.wav').exists()
    assert not (base_dir / 'annotation.zip').exists()


def test_default_directories_are_the_jax_packages(tmp_path):
    dataset = datasets.MAESTRO_V3(base_dir=str(tmp_path), splits=[],
                                  data_proc=_mel(True), save_data=False,
                                  device='cpu')
    assert dataset.save_loc == jtools.DEFAULT_FEATURES_GT_DIR
    assert dataset.get_gt_dir('a/b') == os.path.join(
        jtools.DEFAULT_FEATURES_GT_DIR, 'MAESTRO_V3', 'ground_truth', 'a/b.npz')
    with pytest.warns(RuntimeWarning, match='Attempting to download'):
        with pytest.raises(RuntimeError, match='manually'):
            datasets.MAPS(splits=[], data_proc=_mel(True), device='cpu')


def test_a_feature_failure_in_a_loader_thread_reaches_the_caller(tmp_path):
    """No loader thread swallows a kernel's failure: the exception of the
    thread that computed the features comes out of the loader's
    iteration, and no feature file is left for it."""

    mel = _mel(True)

    def fail(*_, **__):
        raise RuntimeError('stft_power kernel launch failed')

    mel.process_audio = fail
    dataset = datasets.SyntheticPiano(num_tracks=4, track_duration=1.0,
                                      num_frames=8, data_proc=mel,
                                      store_data=False, save_data=True,
                                      save_loc=str(tmp_path), device='cpu')
    loader = datasets.DataLoader(dataset, batch_size=2, num_workers=2)
    with pytest.raises(RuntimeError, match='kernel launch failed'):
        list(loader)
    assert not list((tmp_path / 'SyntheticPiano' / 'MelSpec').iterdir())


@pytest.mark.parametrize('name', ['MAPS', 'MAESTRO_V1', 'MAESTRO_V2',
                                  'MAESTRO_V3', 'GuitarSet'])
def test_dataset_signatures_are_jaxs_with_a_device(name):
    import inspect

    def parameters(cls):
        return [(p.name, p.default) for p in
                inspect.signature(cls.__init__).parameters.values()]

    assert parameters(getattr(datasets, name)) == parameters(
        getattr(jdatasets, name)) + [('device', None)]
