"""The port's file I/O against the JAX package's, on the CPU.

Everything here is host numpy and scipy in both packages, so nothing has a
tolerance: audio, notes, events and extracted annotations are held bit for
bit, and the files each package writes byte for byte. Also the two things
of the port that have no JAX counterpart to compare with: kernel loading
from many threads at once (``ops/cuda_build.py``, with ``nvcc`` and
``ctypes.CDLL`` replaced by fakes) and the absence of ``pandas`` and
``requests`` from the port's imports.
"""

import ast
import json
import os
import struct
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from amt_tools_tpu import tools as jtools

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / 'tests' / 'fixtures'


def _assert_same(ref, got, path='value'):
    """Recursive bit-for-bit equality of nested dicts, lists and arrays."""

    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for key in ref:
            _assert_same(ref[key], got[key], f'{path}[{key!r}]')
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _assert_same(r, g, f'{path}[{i}]')
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert type(got) is type(ref) and got == ref, path


def _tone(num_samples, fs, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / fs
    audio = 0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.randn(num_samples)
    return audio.astype(np.float32)


# WAV

@pytest.mark.parametrize('fs,target', [(16000, None), (22050, 16000),
                                       (44100, 22050), (16000, 44100)])
def test_wav_round_trip_and_resampling_equal_jax(tmp_path, fs, target):
    audio = _tone(fs // 3 + 17, fs)
    # Beyond full scale too: both writers clip
    audio[:5] = [1.5, -1.5, 1.0, -1.0, 0.0]
    port_path, jax_path = tmp_path / 'port.wav', tmp_path / 'jax.wav'
    tools.write_wav(str(port_path), audio, fs)
    jtools.write_wav(str(jax_path), audio, fs)
    assert port_path.read_bytes() == jax_path.read_bytes()

    got, got_fs = tools.load_audio(str(port_path), fs=target)
    ref, ref_fs = jtools.load_audio(str(port_path), fs=target)
    assert got_fs == ref_fs == (target or fs)
    _assert_same(ref, got)

    for norm in (-1, 2, None):
        got, _ = tools.load_normalize_audio(str(port_path), fs=target,
                                            norm=norm)
        ref, _ = jtools.load_normalize_audio(str(port_path), fs=target,
                                             norm=norm)
        _assert_same(ref, got)

    if target is not None:
        _assert_same(jtools.resample_audio(audio, fs, target),
                     tools.resample_audio(audio, fs, target))


def test_load_audio_reads_other_pcm_formats_as_jax(tmp_path):
    from scipy.io import wavfile

    rng = np.random.RandomState(3)
    cases = {'int32': (rng.randint(-2**31, 2**31 - 1, (800, 2))
                       .astype(np.int32)),
             'uint8': rng.randint(0, 256, 800).astype(np.uint8),
             'float32': rng.uniform(-1, 1, (800, 2)).astype(np.float32)}
    for name, data in cases.items():
        path = str(tmp_path / f'{name}.wav')
        wavfile.write(path, 8000, data)
        _assert_same(jtools.load_audio(path, fs=16000),
                     tools.load_audio(path, fs=16000))


# MIDI

def _vlq(value):
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _midi_file(path, events, ticks_per_beat=480):
    """A format-0 file of (delta ticks, raw bytes) events."""

    track = b''.join(_vlq(delta) + message for delta, message in events)
    track += _vlq(0) + b'\xff\x2f\x00'
    path.write_bytes(b'MThd' + struct.pack('>IHHH', 6, 0, 1, ticks_per_beat) +
                     b'MTrk' + struct.pack('>I', len(track)) + track)
    return path


_MIDI_CASES = {
    'tempo_change': [
        (0, b'\xff\x51\x03' + struct.pack('>I', 1000000)[1:]),
        (0, bytes([0x90, 60, 100])), (480, bytes([0x80, 60, 0])),
        (0, b'\xff\x51\x03' + struct.pack('>I', 250000)[1:]),
        (0, bytes([0x90, 62, 90])), (480, bytes([0x80, 62, 0]))],
    'running_status': [
        (0, bytes([0x90, 60, 100])), (10, bytes([62, 100])),
        (10, bytes([60, 0])), (10, bytes([62, 0]))],
    'sustain': [
        (0, bytes([0xB0, 64, 127])), (0, bytes([0x90, 60, 100])),
        (480, bytes([0x80, 60, 0])), (480, bytes([0xB0, 64, 0])),
        (0, bytes([0x90, 72, 50])), (480, bytes([0x80, 72, 0]))],
    'restrike': [
        (0, bytes([0xB0, 64, 127])), (0, bytes([0x90, 60, 100])),
        (240, bytes([0x80, 60, 0])), (240, bytes([0x90, 60, 80])),
        (240, bytes([0x80, 60, 0])), (240, bytes([0xB0, 64, 0]))],
    'unmatched_and_sysex': [
        (0, bytes([0xF0, 3, 1, 2, 0xF7])), (0, bytes([0xC0, 5])),
        (0, bytes([0x90, 65, 70])), (100, bytes([0xE0, 0, 64])),
        (100, bytes([0x90, 67, 80]))],
}


@pytest.mark.parametrize('name', sorted(_MIDI_CASES) + [
    'format1_interleaved.mid', 'smpte_25fps.mid'])
def test_midi_events_and_notes_equal_jax(tmp_path, name):
    if name.endswith('.mid'):
        path = str(FIXTURES / name)
    else:
        path = str(_midi_file(tmp_path / f'{name}.mid', _MIDI_CASES[name]))

    _assert_same(jtools.parse_midi_events(path), tools.parse_midi_events(path))
    ref = jtools.load_notes_midi(path)
    got = tools.load_notes_midi(path)
    _assert_same(ref, got)
    assert len(got), 'the case has notes'


def test_midi_sustain_cases_hold_their_meaning(tmp_path):
    """Not only equal to JAX: the pedal holds a released note to its
    lifting, and a restrike cuts the held note."""

    sustain = tools.load_notes_midi(str(_midi_file(
        tmp_path / 's.mid', _MIDI_CASES['sustain'])))
    np.testing.assert_allclose(sustain, [[0.0, 1.0, 60, 100],
                                         [1.0, 1.5, 72, 50]], atol=1e-9)
    restrike = tools.load_notes_midi(str(_midi_file(
        tmp_path / 'r.mid', _MIDI_CASES['restrike'])))
    np.testing.assert_allclose(restrike[:, :2], [[0.0, 0.5], [0.5, 1.0]],
                               atol=1e-9)


def test_written_files_equal_jax_byte_for_byte(tmp_path):
    rng = np.random.RandomState(7)
    onsets = np.sort(rng.uniform(0, 5, 12))
    batched = np.stack([onsets, onsets + rng.uniform(0.05, 1.0, 12),
                        rng.randint(21, 109, 12)], axis=-1)
    # A restruck pitch whose next onset is its offset's tick
    batched[3, 2] = batched[4, 2]
    velocities = rng.randint(1, 128, 12)
    for kwargs in ({}, {'velocities': velocities},
                   {'velocities': velocities, 'ticks_per_beat': 96,
                    'tempo': 400000}):
        port, ref = tmp_path / 'port' / 'a.mid', tmp_path / 'jax' / 'a.mid'
        tools.write_notes_midi(str(port), batched, **kwargs)
        jtools.write_notes_midi(str(ref), batched, **kwargs)
        assert port.read_bytes() == ref.read_bytes()
        _assert_same(jtools.load_notes_midi(str(ref)),
                     tools.load_notes_midi(str(port)))

    stacked = {'E': (np.array([40.0, 41.0]), np.array([[0.0, 1.0],
                                                       [1.5, 2.25]])),
               3: (np.array([45.0]), np.array([[0.5, 1.2]])),
               'e': (np.empty(0), np.empty((0, 2)))}
    for duration in (None, 3.0):
        port, ref = tmp_path / 'port.jams', tmp_path / 'jax.jams'
        tools.write_stacked_notes_jams(stacked, str(port), duration=duration)
        jtools.write_stacked_notes_jams(stacked, str(ref), duration=duration)
        assert port.read_bytes() == ref.read_bytes()

    lines = ['a', 3, 4.5, 'last']
    tools.write_list(lines, str(tmp_path / 'p' / 'list.txt'))
    jtools.write_list(lines, str(tmp_path / 'j' / 'list.txt'))
    assert ((tmp_path / 'p' / 'list.txt').read_bytes() ==
            (tmp_path / 'j' / 'list.txt').read_bytes())


# JAMS

def _guitar_jams(tmp_path):
    """The GuitarSet-style fixture plus a pitch contour with an unvoiced,
    a zero-frequency and an out-of-order observation."""

    jam = json.loads((FIXTURES / 'guitarset_style.jams').read_text())
    jam['annotations'].append({
        'namespace': 'pitch_contour',
        'annotation_metadata': {'data_source': 'extra'},
        'data': [{'time': t, 'duration': 0.0,
                  'value': {'frequency': f, 'voiced': v, 'index': 0}}
                 for t, f, v in ((0.0232, 200.0, True), (0.0, 196.0, True),
                                 (0.0116, 0.0, True), (0.0348, 210.0, False),
                                 (0.0464, 220.0, True))]})
    path = tmp_path / 'guitar.jams'
    path.write_text(json.dumps(jam))
    return str(path)


def test_every_jams_extractor_equals_jax(tmp_path):
    path = _guitar_jams(tmp_path)
    jam_port, jam_ref = tools.load_jams(path), jtools.load_jams(path)
    _assert_same(jam_ref, jam_port)

    _assert_same(jtools.extract_duration_jams(jam_ref),
                 tools.extract_duration_jams(jam_port))
    _assert_same(jtools.load_duration_jams(path),
                 tools.load_duration_jams(path))
    for name in ('extract_stacked_notes_jams', 'extract_notes_jams'):
        _assert_same(getattr(jtools, name)(jam_ref),
                     getattr(tools, name)(jam_port), name)
    for name in ('load_stacked_notes_jams', 'load_notes_jams'):
        _assert_same(getattr(jtools, name)(path), getattr(tools, name)(path),
                     name)
    stacked = tools.load_stacked_notes_jams(path)
    assert sum(len(p) for p, _ in stacked.values()) == 3

    times = np.linspace(-0.01, 0.08, 11)
    for kwargs in ({}, {'uniform': False}, {'times': times},
                   {'times': times, 'uniform': False}):
        _assert_same(jtools.extract_stacked_pitch_list_jams(jam_ref, **kwargs),
                     tools.extract_stacked_pitch_list_jams(jam_port, **kwargs),
                     str(kwargs))
        _assert_same(jtools.load_stacked_pitch_list_jams(path, **kwargs),
                     tools.load_stacked_pitch_list_jams(path, **kwargs))
        args = (kwargs.get('times'), kwargs.get('uniform', True))
        _assert_same(jtools.extract_pitch_list_jams(jam_ref, *args),
                     tools.extract_pitch_list_jams(jam_port, *args))
        _assert_same(jtools.load_pitch_list_jams(path, *args),
                     tools.load_pitch_list_jams(path, *args))

    observed = np.array([0.0, 0.01, 0.02, 0.03])
    pitch_list = [np.array([100.0]), np.array([]), np.array([101.0, 150.0]),
                  np.array([99.0])]
    _assert_same(jtools.resample_multipitch(observed, pitch_list, times),
                 tools.resample_multipitch(observed, pitch_list, times))
    _assert_same(jtools.resample_multipitch([], [], times),
                 tools.resample_multipitch([], [], times))


def test_pitch_list_helpers_equal_jax():
    rng = np.random.RandomState(2)
    times = np.round(np.sort(rng.uniform(0, 1, 40)) / 0.01) * 0.01
    times = np.unique(times)
    values = [rng.uniform(80, 400, rng.randint(0, 3)) for _ in times]
    shuffled = rng.permutation(len(times))
    for name, args in (
            ('slice_pitch_list', (times, values, 0.2, 0.6)),
            ('sort_pitch_list', (times[shuffled],
                                 [values[i] for i in shuffled])),
            ('get_resample_idcs', (times, np.linspace(-0.1, 1.1, 30))),
            ('get_resample_idcs', ([], [0.5])),
            ('time_series_to_uniform', (times, values)),
            ('time_series_to_uniform', (times, values, 0.005, 0.5)),
            ('time_series_to_uniform', ([], []))):
        _assert_same(getattr(jtools, name)(*args), getattr(tools, name)(*args),
                     name)


# npz caches

def test_npz_written_by_one_package_reads_in_the_other(tmp_path):
    stacked = {'E': (np.array([40.0]), np.array([[0.0, 1.0]])),
               'A': (np.array([45.0, 47.0]), np.array([[0.5, 1.2],
                                                       [1.4, 2.0]]))}
    data = {tools.KEY_TRACK: 'piece_01', tools.KEY_FS: 22050,
            tools.KEY_AUDIO: _tone(4000, 22050),
            tools.KEY_TABLATURE: np.random.RandomState(0).randint(
                -1, 20, (6, 9)),
            tools.KEY_NOTES: tools.pack_stacked_representation(stacked)}

    tools.save_dict_npz(str(tmp_path / 'port'), data)
    jtools.save_dict_npz(str(tmp_path / 'jax'), data)
    assert sorted(p.name for p in tmp_path.iterdir()) == ['jax.npz',
                                                          'port.npz']
    for writer in ('port', 'jax'):
        path = str(tmp_path / f'{writer}.npz')
        ref, got = jtools.load_dict_npz(path), tools.load_dict_npz(path)
        assert list(got) == list(data)
        for key in data:
            if key == tools.KEY_NOTES:
                _assert_same(jtools.unpack_stacked_representation(ref[key]),
                             tools.unpack_stacked_representation(got[key]))
            else:
                _assert_same(ref[key], got[key])
        assert got[tools.KEY_FS].item() == 22050
        np.testing.assert_array_equal(got[tools.KEY_AUDIO],
                                      data[tools.KEY_AUDIO])


def test_save_dict_npz_from_threads_leaves_one_whole_file(tmp_path):
    """Eight threads writing one cache path at once: every temporary name
    differs, and the file left is whole."""

    path = str(tmp_path / 'cache.npz')
    audio = _tone(50000, 16000)
    _, errors = _from_threads(
        lambda: tools.save_dict_npz(path, {tools.KEY_AUDIO: audio}))
    assert not errors
    assert [p.name for p in tmp_path.iterdir()] == ['cache.npz']
    np.testing.assert_array_equal(tools.load_dict_npz(path)[tools.KEY_AUDIO],
                                  audio)


def test_stacked_representation_and_seed_helpers_equal_jax():
    stacked = {0: (np.array([1.0]), np.array([[0.0, 1.0]])), 'b': 3}
    _assert_same(jtools.pack_stacked_representation(stacked).tolist(),
                 tools.pack_stacked_representation(stacked).tolist())
    _assert_same(jtools.apply_func_stacked_representation(
                     stacked, lambda v, k: (v, k), k=2),
                 tools.apply_func_stacked_representation(
                     stacked, lambda v, k: (v, k), k=2))

    assert tools.seed_everything(5) == 5
    port = np.random.rand(3)
    jtools.seed_everything(5)
    np.testing.assert_array_equal(np.random.rand(3), port)


def test_file_management_equals_jax(tmp_path):
    names = ['model-1500.ckpt', 'model-500.ckpt', 'model-50.ckpt', 'a']
    assert (sorted(names, key=tools.file_sort) ==
            sorted(names, key=jtools.file_sort))

    source = tmp_path / 'src'
    (source / 'sub').mkdir(parents=True)
    (source / 'a.txt').write_bytes(b'alpha')
    (source / 'sub' / 'b.txt').write_bytes(b'beta')
    tools.zip_and_save(str(source), str(tmp_path / 'bundle.zip'))
    tools.unzip_and_remove(str(tmp_path / 'bundle.zip'), str(tmp_path / 'out'))
    assert not (tmp_path / 'bundle.zip').exists()
    assert (tmp_path / 'out' / 'sub' / 'b.txt').read_bytes() == b'beta'

    (tmp_path / 'new').mkdir()
    tools.change_base_dir(str(tmp_path / 'new'), str(tmp_path / 'out'))
    assert not (tmp_path / 'out').exists()
    assert (tmp_path / 'new' / 'a.txt').read_bytes() == b'alpha'


# Kernel loading from loader threads

@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """``nvcc`` and ``ctypes.CDLL`` replaced by fakes that count their
    calls; the build directory is a temporary one."""

    calls = {'nvcc': [], 'load': []}
    lock = threading.Lock()

    class FakeNvcc:
        def __init__(self, cmd, **_):
            self.partial = cmd[cmd.index('-o') + 1]
            with lock:
                calls['nvcc'].append((self.partial, threading.get_ident()))
            self.returncode = 0

        def communicate(self):
            # Slow enough that every thread arrives while it builds
            threading.Event().wait(0.2)
            Path(self.partial).write_bytes(b'so')
            return 'ptxas info', ''

    class FakeLibrary:
        def __init__(self, path):
            with lock:
                calls['load'].append(path)
            self.kernel = type('Fn', (), {})()

    monkeypatch.setattr(cuda_build, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(cuda_build, '_loaded', {})
    monkeypatch.setattr(cuda_build, '_nvcc', lambda: 'nvcc')
    monkeypatch.setattr(cuda_build.subprocess, 'Popen', FakeNvcc)
    monkeypatch.setattr(cuda_build.ctypes, 'CDLL', FakeLibrary)
    return calls


def _from_threads(fn, count=8):
    """``fn`` from ``count`` threads released at once, with the
    interpreter switching threads as often as it can: (results, errors)."""

    barrier = threading.Barrier(count)
    results, errors = [], []

    def run():
        barrier.wait()
        try:
            results.append(fn())
        except Exception as error:  # collected for the caller
            errors.append(error)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(count)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    return results, errors


def test_library_from_8_threads_builds_and_loads_once(fake_toolchain):
    results, errors = _from_threads(
        lambda: cuda_build.library('stft_power', {'kernel': []}))
    assert not errors
    assert len(fake_toolchain['nvcc']) == 1
    assert len(fake_toolchain['load']) == 1
    assert len(results) == 8 and all(r is results[0] for r in results)
    # The compiler wrote under a name with the process and the thread
    partial, thread = fake_toolchain['nvcc'][0]
    stem = cuda_build._library_path('stft_power').stem
    assert Path(partial).name == f'{stem}.{os.getpid()}.{thread}.partial.so'
    built = sorted(p.name for p in cuda_build.BUILD_DIR.iterdir())
    assert built == [cuda_build._library_path('stft_power').name]


def test_build_from_8_threads_compiles_each_source_once(fake_toolchain):
    _, errors = _from_threads(lambda: cuda_build.build(
        ('stft_power', 'cqt_mag')))
    assert not errors
    assert len(fake_toolchain['nvcc']) == 2


def test_a_failed_build_raises_in_every_thread(fake_toolchain, monkeypatch):
    class FailingNvcc:
        def __init__(self, cmd, **_):
            fake_toolchain['nvcc'].append(cmd)
            self.returncode = 1

        def communicate(self):
            return '', 'error: no such instruction'

    monkeypatch.setattr(cuda_build.subprocess, 'Popen', FailingNvcc)
    results, errors = _from_threads(
        lambda: cuda_build.library('lstm_scan', {'kernel': []}))
    assert not results and len(errors) == 8
    assert all('no such instruction' in str(e) for e in errors)
    assert not fake_toolchain['load']
    assert 'lstm_scan' not in cuda_build._loaded


def test_launch_counts_and_caches_hold_under_threads():
    """Unlocked, a read-modify-write of the counters loses most of these
    updates at this switch interval."""

    class Wrapper:
        launches = 0
        fft_launches = 0

    _, errors = _from_threads(lambda: [cuda_build.count(
        Wrapper, 'launches', 'fft_launches') for _ in range(2000)])
    assert not errors
    assert Wrapper.launches == Wrapper.fft_launches == 16000

    cache, made = {}, []

    def make():
        made.append(1)
        threading.Event().wait(0.05)
        return object()

    results, _ = _from_threads(lambda: cuda_build.cached(cache, 'k', make))
    assert len(made) == 1 and all(r is cache['k'] for r in results)


def test_port_imports_neither_pandas_nor_requests():
    """The GPU machine has neither: MAESTRO's CSV goes through ``csv`` and
    downloads through ``urllib.request``."""

    sources = sorted((REPO / 'amt_tools_tpu_torch').rglob('*.py'))
    sources.append(REPO / 'chip_smoke.py')
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split('.')[0] not in ('pandas', 'requests'), (
                    f'{path.relative_to(REPO)} imports {name}')


def test_tools_io_names_match_jax():
    from amt_tools_tpu.tools import io as jio, jams_io as jjams, midi as jmidi
    from amt_tools_tpu_torch.tools import io, jams_io, midi

    assert io.__all__ == jio.__all__
    assert jams_io.__all__ == jjams.__all__
    assert midi.__all__ == jmidi.__all__
    for name in ('DEFAULT_DATASETS_DIR', 'DEFAULT_FEATURES_GT_DIR',
                 'GROUND_TRUTH_DIR', 'WAV_EXT', 'MID_EXT', 'MIDI_EXT',
                 'JAMS_EXT', 'NPZ_EXT', 'CSV_EXT', 'JAMS_NOTE_MIDI',
                 'JAMS_PITCH_HZ', 'JAMS_STRING_IDX', 'JAMS_METADATA',
                 'MIDI_SUSTAIN_CONTROL_NUM'):
        assert getattr(tools, name) == getattr(jtools, name), name
