"""The port's estimators and evaluators vs the JAX package's, on the same
predictions and references (host numpy).

Every estimator of the two paper recipes (``examples/papers/of_2.py``:
``NoteTranscriber`` and ``PitchListWrapper``; ``examples/papers/tabcnn.py``:
``TablatureWrapper`` and ``StackedMultiPitchCollapser``), the other
estimators of ``transcribe.__all__``, and every evaluator (the recipes'
``LossWrapper``, ``MultipitchEvaluator``, ``NoteEvaluator``,
``TablatureEvaluator``, ``SoftmaxAccuracy``, plus ``VelocityEvaluator``,
the stacked and pitch-list evaluators and the combos) run on both sides.
Both are the same numpy arithmetic, so estimates and results agree within
1e-9 (room for nothing but a changed order of a sum), and the files their
``save_dir`` writes are byte for byte equal.
"""

import os

import numpy as np
import pytest
import torch

from amt_tools_tpu import evaluate as jev
from amt_tools_tpu import tools as jtools
from amt_tools_tpu import transcribe as jtr

from amt_tools_tpu_torch import evaluate as ev
from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch import transcribe as tr

TOL = 1e-9
FRAMES = 60
HOP_S = 0.032


def _assert_same(got, want, path='estimate'):
    """Nested dicts, tuples and lists of arrays and numbers: the same
    structure, arrays of one shape within ``TOL``."""

    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            _assert_same(got[key], want[key], f'{path}/{key}')
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f'{path}[{i}]')
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got.astype(float), want.astype(float),
                                   atol=TOL, rtol=0, err_msg=path)


def _piano_track(seed):
    """Reference notes, their maps, and estimated maps (the reference's
    with frames flipped at random), on a float32 frame grid."""

    profile = jtools.PianoProfile()
    rng = np.random.RandomState(seed)
    times = (np.arange(FRAMES) * HOP_S).astype(np.float32)
    count = 12
    onsets = np.sort(rng.uniform(0, FRAMES * HOP_S * 0.9, count))
    intervals = np.stack([onsets, onsets + rng.uniform(0.05, 0.5, count)], 1)
    pitches = rng.randint(40, 80, count).astype(float)

    multi_pitch = jtools.notes_to_multi_pitch(pitches, intervals, times,
                                              profile)
    flips = rng.rand(*multi_pitch.shape) < 0.02
    estimate = np.where(flips, 1 - multi_pitch, multi_pitch)

    reference = {
        tools.KEY_TRACK: f'piano_{seed}',
        tools.KEY_TIMES: times,
        tools.KEY_MULTIPITCH: multi_pitch,
        tools.KEY_NOTES: jtools.notes_to_batched_notes(pitches, intervals),
        tools.KEY_PITCHLIST: (times, jtools.multi_pitch_to_pitch_list(
            multi_pitch, profile)),
        tools.KEY_VELOCITY: multi_pitch * rng.uniform(0.2, 1.0, (88, 1)),
    }
    predictions = {
        tools.KEY_TIMES: times,
        tools.KEY_MULTIPITCH: estimate.astype(np.float32),
        tools.KEY_ONSETS: jtools.multi_pitch_to_onsets(estimate).astype(
            np.float32),
        tools.KEY_OFFSETS: rng.rand(88, FRAMES).astype(np.float32),
        tools.KEY_VELOCITY: rng.rand(88, FRAMES).astype(np.float32),
        tools.KEY_LOSS: {tools.KEY_LOSS_TOTAL: np.float32(rng.rand()),
                         tools.KEY_LOSS_PITCH: np.float32(rng.rand())},
    }

    return predictions, reference


def _guitar_track(seed):
    """Reference and estimated tablature (S, T), -1 for silence."""

    rng = np.random.RandomState(seed)
    reference = rng.randint(-1, 20, (6, FRAMES))
    estimate = np.where(rng.rand(6, FRAMES) < 0.2,
                        rng.randint(-1, 20, (6, FRAMES)), reference)
    times = (np.arange(FRAMES) * HOP_S).astype(np.float32)
    profile = jtools.GuitarProfile(num_frets=19)
    stacked = jtools.tablature_to_stacked_multi_pitch(reference, profile)

    predictions = {tools.KEY_TIMES: times, tools.KEY_TABLATURE: estimate,
                   tools.KEY_LOSS: {tools.KEY_LOSS_TOTAL: np.float32(0.5)}}
    reference = {tools.KEY_TRACK: f'guitar_{seed}', tools.KEY_TIMES: times,
                 tools.KEY_TABLATURE: reference,
                 tools.KEY_MULTIPITCH:
                     jtools.stacked_multi_pitch_to_multi_pitch(stacked)}

    return predictions, reference


def _profiles(kind):
    if kind == 'piano':
        return jtools.PianoProfile(), tools.PianoProfile()
    return (jtools.GuitarProfile(num_frets=19),
            tools.GuitarProfile(num_frets=19))


def _stacked_piano(predictions):
    """Piano maps as a 2-slice stack (for the stacked estimators)."""

    stacked = dict(predictions)
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS, tools.KEY_OFFSETS):
        if key not in predictions:
            continue
        stacked[key] = np.stack([predictions[key],
                                 np.roll(predictions[key], 3, axis=-1)])
    return stacked


# name -> (instrument, keyword arguments, how the input is prepared)
ESTIMATORS = {
    'NoteTranscriber': ('piano', {}, None),
    'NoteTranscriber_inhibit': ('piano', {'inhibition_window': 0.1,
                                          'minimum_duration': 0.06}, None),
    'PitchListWrapper': ('piano', {}, None),
    'MultiPitchWrapper': ('piano', {}, None),
    'StackedNoteTranscriber': ('piano', {'inhibition_window': 0.05},
                               _stacked_piano),
    'StackedPitchListWrapper': ('piano', {}, _stacked_piano),
    'StackedMultiPitchCollapser': ('piano', {}, _stacked_piano),
    'StackedOnsetsWrapper': ('piano', {}, _stacked_piano),
    'StackedOffsetsWrapper': ('piano', {}, _stacked_piano),
    'TablatureWrapper': ('guitar', {}, None),
}


def _make(module, name, profile, kwargs, save_dir=None):
    cls = getattr(module, name.split('_')[0])
    return cls(profile=profile, save_dir=save_dir, **kwargs)


def _prepare(kind, prepare, seed=0):
    predictions, _ = (_piano_track if kind == 'piano' else
                      _guitar_track)(seed)
    return prepare(predictions) if prepare else predictions


@pytest.mark.parametrize('name', sorted(ESTIMATORS))
def test_estimator_matches_jax(name, tmp_path):
    kind, kwargs, prepare = ESTIMATORS[name]
    jprofile, profile = _profiles(kind)
    predictions = _prepare(kind, prepare)

    jax_dir, port_dir = tmp_path / 'jax', tmp_path / 'port'
    want = _make(jtr, name, jprofile, kwargs, str(jax_dir)).process_track(
        dict(predictions), 'track')
    got = _make(tr, name, profile, kwargs, str(port_dir)).process_track(
        dict(predictions), 'track')

    _assert_same(got, want)
    _assert_same_files(port_dir, jax_dir)


def _assert_same_files(port_dir, jax_dir):
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    for file_name in names:
        assert ((port_dir / file_name).read_bytes() ==
                (jax_dir / file_name).read_bytes()), file_name


def _refined(predictions, profile_module, profile, stacked):
    """Predictions plus the notes a transcriber decodes from them."""

    module = jtr if profile_module is jtools else tr
    cls = module.StackedNoteTranscriber if stacked else module.NoteTranscriber
    out = dict(predictions)
    out.update(cls(profile=profile).process_track(dict(predictions)))
    return out


@pytest.mark.parametrize('stacked', [False, True])
def test_refiners_and_note_collapser_match_jax(stacked):
    jprofile, profile = _profiles('piano')
    predictions, _ = _piano_track(1)
    if stacked:
        predictions = _stacked_piano(predictions)

    jax_in = _refined(predictions, jtools, jprofile, stacked)
    port_in = _refined(predictions, tools, profile, stacked)
    _assert_same(port_in[tools.KEY_NOTES], jax_in[tools.KEY_NOTES])

    names = (['StackedMultiPitchRefiner', 'StackedNotesCollapser']
             if stacked else ['MultiPitchRefiner'])
    for name in names:
        want = getattr(jtr, name)(profile=jprofile).process_track(
            dict(jax_in))
        got = getattr(tr, name)(profile=profile).process_track(dict(port_in))
        _assert_same(got, want, name)


def test_pitch_list_collapser_matches_jax():
    jprofile, profile = _profiles('piano')
    predictions = _stacked_piano(_piano_track(2)[0])

    jax_in = dict(predictions)
    jax_in.update(jtr.StackedPitchListWrapper(profile=jprofile).process_track(
        dict(predictions)))
    port_in = dict(predictions)
    port_in.update(tr.StackedPitchListWrapper(profile=profile).process_track(
        dict(predictions)))

    want = jtr.StackedPitchListCollapser(profile=jprofile).process_track(
        jax_in)
    got = tr.StackedPitchListCollapser(profile=profile).process_track(port_in)
    _assert_same(got, want)


def test_iterative_note_transcriber_matches_jax():
    """Frame by frame through the stateful transcriber, then a reset."""

    jprofile, profile = _profiles('piano')
    predictions, _ = _piano_track(3)
    estimators = (jtr.IterativeNoteTranscriber(profile=jprofile),
                  tr.IterativeNoteTranscriber(profile=profile))

    for frame in range(FRAMES):
        step = {key: predictions[key][..., frame: frame + 1]
                for key in (tools.KEY_MULTIPITCH, tools.KEY_TIMES)}
        want, got = (e.process_track(dict(step)) for e in estimators)
        _assert_same(got, want, f'frame {frame}')

    _assert_same(estimators[1].get_active_stacked_notes(1.0),
                 estimators[0].get_active_stacked_notes(1.0))
    for estimator in estimators:
        estimator.reset_state()
    _assert_same(estimators[1].active_pitches, estimators[0].active_pitches)


@pytest.mark.parametrize('minimum_duration', [None, 0.05])
@pytest.mark.parametrize('with_onsets', [False, True])
def test_device_note_transcriber_matches_jax(with_onsets, minimum_duration,
                                             tmp_path):
    jprofile, profile = _profiles('piano')
    predictions, _ = _piano_track(4)
    if not with_onsets:
        predictions.pop(tools.KEY_ONSETS)

    want = jtr.DeviceNoteTranscriber(
        profile=jprofile, capacity=256, minimum_duration=minimum_duration,
        save_dir=str(tmp_path / 'jax')).process_track(dict(predictions), 't')
    got = tr.DeviceNoteTranscriber(
        profile=profile, capacity=256, minimum_duration=minimum_duration,
        save_dir=str(tmp_path / 'port'),
        device='cpu').process_track(dict(predictions), 't')

    _assert_same(got, want)
    _assert_same_files(tmp_path / 'port', tmp_path / 'jax')


def test_note_velocity_estimator_matches_jax(tmp_path):
    jprofile, profile = _profiles('piano')
    predictions, _ = _piano_track(5)
    predictions.update(jtr.NoteTranscriber(profile=jprofile).process_track(
        dict(predictions)))

    for window in (1, 5):
        want = jtr.NoteVelocityEstimator(
            profile=jprofile, readout_window=window,
            save_dir=str(tmp_path / f'jax{window}')).process_track(
                dict(predictions), 't')
        got = tr.NoteVelocityEstimator(
            profile=profile, readout_window=window,
            save_dir=str(tmp_path / f'port{window}')).process_track(
                dict(predictions), 't')
        _assert_same(got, want)
        _assert_same_files(tmp_path / f'port{window}',
                           tmp_path / f'jax{window}')


def _of2_estimator(module, profile):
    return module.ComboEstimator([module.NoteTranscriber(profile=profile),
                                  module.PitchListWrapper(profile=profile)])


def _of2_evaluator(module, tools_module, save_dir=None):
    evaluator = module.ComboEvaluator([
        module.LossWrapper(),
        module.MultipitchEvaluator(),
        module.NoteEvaluator(results_key=tools_module.KEY_NOTE_ON),
        module.NoteEvaluator(offset_ratio=0.2,
                             results_key=tools_module.KEY_NOTE_OFF),
        module.PitchListEvaluator(pitch_tolerances=[0.5, 1.0]),
        module.VelocityEvaluator()], save_dir=save_dir)
    evaluator.set_patterns(['loss', 'pr', 're', 'f1'])
    return evaluator


def _tabcnn_estimator(module, profile):
    return module.ComboEstimator([
        module.TablatureWrapper(profile=profile),
        module.StackedMultiPitchCollapser(profile=profile)])


def _tabcnn_evaluator(module, profile, save_dir=None):
    return module.ComboEvaluator([module.LossWrapper(),
                                  module.MultipitchEvaluator(),
                                  module.TablatureEvaluator(profile=profile),
                                  module.SoftmaxAccuracy()],
                                 save_dir=save_dir)


class RecordingWriter:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))


@pytest.mark.parametrize('recipe', ['of_2', 'tabcnn'])
def test_recipe_combos_match_jax(recipe, tmp_path):
    """The recipe's ComboEstimator and ComboEvaluator over three tracks:
    per-track results, the averaged results, the logged scalars of
    ``finalize`` and the results files."""

    kind = 'piano' if recipe == 'of_2' else 'guitar'
    jprofile, profile = _profiles(kind)
    make_track = _piano_track if kind == 'piano' else _guitar_track
    if recipe == 'of_2':
        sides = [(_of2_estimator(jtr, jprofile),
                  _of2_evaluator(jev, jtools, str(tmp_path / 'jax'))),
                 (_of2_estimator(tr, profile),
                  _of2_evaluator(ev, tools, str(tmp_path / 'port')))]
    else:
        sides = [(_tabcnn_estimator(jtr, jprofile),
                  _tabcnn_evaluator(jev, jprofile, str(tmp_path / 'jax'))),
                 (_tabcnn_estimator(tr, profile),
                  _tabcnn_evaluator(ev, profile, str(tmp_path / 'port')))]

    for seed in range(3):
        predictions, reference = make_track(seed)
        results = []
        for estimator, evaluator in sides:
            estimates = estimator.process_track(dict(predictions),
                                                reference[tools.KEY_TRACK])
            results.append(evaluator.process_track(
                estimates, reference, reference[tools.KEY_TRACK]))
        _assert_same(results[1], results[0], f'track {seed}')

    _assert_same(sides[1][1].average_results(), sides[0][1].average_results())
    writers = [RecordingWriter(), RecordingWriter()]
    for (_, evaluator), writer in zip(sides, writers):
        evaluator.finalize(writer, step=7)
    assert [s[0] for s in writers[1].scalars] == \
        [s[0] for s in writers[0].scalars]
    np.testing.assert_allclose([s[1] for s in writers[1].scalars],
                               [s[1] for s in writers[0].scalars], atol=TOL)
    assert writers[1].scalars and all(s[2] == 7 for s in writers[1].scalars)
    _assert_same_files(tmp_path / 'port', tmp_path / 'jax')


@pytest.mark.parametrize('name,kind', [
    ('StackedMultipitchEvaluator', 'piano'),
    ('StackedNoteEvaluator', 'piano'),
    ('StackedPitchListEvaluator', 'piano')])
@pytest.mark.parametrize('average_slices', [False, True])
def test_stacked_evaluators_match_jax(name, kind, average_slices):
    jprofile, profile = _profiles(kind)
    predictions, reference = _piano_track(6)
    stacked_est = _stacked_piano(predictions)
    stacked_ref = _stacked_piano(reference)

    if name == 'StackedMultipitchEvaluator':
        est, ref = (stacked_est[tools.KEY_MULTIPITCH],
                    stacked_ref[tools.KEY_MULTIPITCH])
    elif name == 'StackedNoteEvaluator':
        est = jtr.StackedNoteTranscriber(profile=jprofile).process_track(
            dict(stacked_est))[tools.KEY_NOTES]
        ref = jtr.StackedNoteTranscriber(profile=jprofile).process_track(
            dict(stacked_ref))[tools.KEY_NOTES]
    else:
        est = jtools.stacked_multi_pitch_to_stacked_pitch_list(
            stacked_est[tools.KEY_MULTIPITCH], predictions[tools.KEY_TIMES],
            jprofile)
        ref = jtools.stacked_multi_pitch_to_stacked_pitch_list(
            stacked_ref[tools.KEY_MULTIPITCH], reference[tools.KEY_TIMES],
            jprofile)

    want = getattr(jev, name)(average_slices=average_slices).evaluate(est, ref)
    got = getattr(ev, name)(average_slices=average_slices).evaluate(est, ref)
    _assert_same(got, want)


def test_evaluators_take_tensors_and_missing_entries():
    """Tensors (the device's predictions) score as their numpy values; a
    missing entry warns on both sides; VelocityEvaluator contributes
    nothing without maps."""

    predictions, reference = _guitar_track(7)
    est = torch.from_numpy(predictions[tools.KEY_TABLATURE])
    for module in (jev, ev):
        assert module.SoftmaxAccuracy().evaluate(
            est.numpy(), reference[tools.KEY_TABLATURE]) == \
            ev.SoftmaxAccuracy().evaluate(est, reference[tools.KEY_TABLATURE])
        with pytest.warns(RuntimeWarning):
            module.MultipitchEvaluator().unpack({}, reference)
        assert module.VelocityEvaluator().evaluate(None, None) == {}


def test_results_plumbing_matches_jax(tmp_path):
    tracked = {}
    jtracked = {}
    for seed in range(3):
        rng = np.random.RandomState(seed)
        new = {'a': {'p': rng.rand(), 'r': rng.rand()}, 'b': rng.rand(2)}
        tracked = ev.append_results(tracked, new)
        jtracked = jev.append_results(jtracked, new)
    _assert_same(tracked, jtracked)
    _assert_same(ev.average_results(tracked), jev.average_results(jtracked))

    for module, name in ((ev, 'port.txt'), (jev, 'jax.txt')):
        with open(tmp_path / name, 'w') as file:
            module.write_results(module.average_results(tracked), file,
                                 patterns=['p', 'b'])
    assert (tmp_path / 'port.txt').read_bytes() == \
        (tmp_path / 'jax.txt').read_bytes()
    assert ev.pattern_match('loss_total', ['loss']) and \
        not ev.pattern_match('x', None)
