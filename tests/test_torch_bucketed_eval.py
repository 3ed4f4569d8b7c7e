"""Bucketed whole-track evaluation: the port's ``inference`` and
``evaluate.validate`` vs the JAX package's, on the CPU.

Narrow O&F2 (complexity 2, 32 mels) and TabCNN (40 bins) with Flax
variables loaded by ``weights.from_flax``, ``device='cpu'``. Both sides
read the same features from a duck-typed track set, so:

- logits (and the unthresholded offsets) agree within 2e-3, and the
  thresholded maps may differ only where a logit lies within it of 0
  (PARITY.md's margin, as ``tests/test_torch_pipeline.py``); notes equal in
  every pitch row whose maps agree;
- the averaged validation results agree within 1e-6: the scores
  absolute (they count equal maps), the losses relative (float32 means of
  about 64 a frame, whose ulp is 7.6e-6, over logits within 1e-5);
- the port's bucketed predictions equal its unbucketed ones on the valid
  frames bit for bit, in float32 and bf16 (the frame mask and kernel B's
  masked plain version), and its batched validation scores equal its
  per-track ones. That check runs the CPU's convolutions without oneDNN:
  oneDNN picks its float32 conv algorithm by the image's size, so a conv
  over 17 frames and over the same 17 frames padded to 32 may round apart
  (3.8e-5 at 32 channels), whatever the mask does; PyTorch's native CPU
  conv (im2col and one GEMM) computes each output alike at every size.

One bucket size (8 frames) serves the JAX side throughout, so its forward
sees few shapes.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import evaluate as jev
from amt_tools_tpu import inference as jinf
from amt_tools_tpu import tools as jtools
from amt_tools_tpu import transcribe as jtr
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models import TabCNN as JaxTabCNN
from amt_tools_tpu.models.common import SoftmaxGroups as JaxSoftmaxGroups

from amt_tools_tpu_torch import evaluate as ev
from amt_tools_tpu_torch import inference as inf
from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch import transcribe as tr
from amt_tools_tpu_torch.models import OnsetsFrames2, TabCNN
from amt_tools_tpu_torch.models.common import SoftmaxGroups
from amt_tools_tpu_torch.ops import decode
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

N_MELS = 32
CQT_BINS = 40
BUCKET = 8
LOGIT_ATOL = 2e-3
RESULT_TOL = 1e-6
HOP_S = 0.032
PIANO_FRAMES = (17, 21, 23)   # all pad to 24 at BUCKET
GUITAR_FRAMES = (12, 14, 15)  # all pad to 16


class _Tracks:
    """A duck-typed validation set over fixed track dicts."""

    def __init__(self, tracks):
        self.data = {t[tools.KEY_TRACK]: t for t in tracks}
        self.tracks = list(self.data)

    def get_track_data(self, track_id):
        return dict(self.data[track_id])

    def get_track_frames(self, track_id):
        return self.data[track_id][tools.KEY_FEATS].shape[-1]


def _piano_track(seed, frames):
    profile = jtools.PianoProfile()
    rng = np.random.RandomState(seed)
    times = np.arange(frames) * HOP_S
    count = 6
    onsets = np.sort(rng.uniform(0, frames * HOP_S * 0.8, count))
    intervals = np.stack([onsets, onsets + rng.uniform(0.06, 0.3, count)], 1)
    pitches = rng.randint(50, 70, count).astype(float)
    multi_pitch = jtools.notes_to_multi_pitch(pitches, intervals, times,
                                              profile)
    return {tools.KEY_TRACK: f'piano_{seed}',
            tools.KEY_FEATS: rng.rand(1, N_MELS, frames).astype(np.float32),
            tools.KEY_TIMES: times,
            tools.KEY_MULTIPITCH: multi_pitch,
            tools.KEY_NOTES: jtools.notes_to_batched_notes(pitches,
                                                           intervals)}


def _guitar_track(seed, frames):
    profile = jtools.GuitarProfile()
    rng = np.random.RandomState(seed)
    tablature = rng.randint(-1, 20, (6, frames))
    stacked = jtools.tablature_to_stacked_multi_pitch(tablature, profile)
    return {tools.KEY_TRACK: f'guitar_{seed}',
            tools.KEY_FEATS: rng.rand(1, CQT_BINS, frames).astype(np.float32),
            tools.KEY_TIMES: np.arange(frames) * HOP_S,
            tools.KEY_TABLATURE: tablature,
            tools.KEY_MULTIPITCH:
                jtools.stacked_multi_pitch_to_multi_pitch(stacked)}


@pytest.fixture(scope='module')
def piano():
    """Flax O&F2 variables (with active heads) and the port's model."""

    model = JaxOnsetsFrames2(dim_in=N_MELS, profile=jtools.PianoProfile(),
                             model_complexity=2)
    feats = model.pre_proc({jtools.KEY_FEATS: jnp.zeros((1, 1, N_MELS, 8))})
    variables = model.init(jax.random.PRNGKey(0), feats[jtools.KEY_FEATS])
    # Raise the refined pitch and onset heads' priors, so notes decode
    params = jax.tree_util.tree_map(lambda v: v, variables['params'])
    for head in ('adjoin_out', 'onset_out'):
        bias = params[head]['Dense_0']['bias']
        params[head]['Dense_0']['bias'] = bias + 2.0
    variables = {**variables, 'params': params}

    port = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                         model_complexity=2)
    port.load_state_dict(from_flax(variables))

    tracks = [_piano_track(seed, frames)
              for seed, frames in enumerate(PIANO_FRAMES)]

    return model, variables, port.eval(), tracks


@pytest.fixture(scope='module')
def guitar():
    model = JaxTabCNN(dim_in=CQT_BINS, profile=jtools.GuitarProfile(),
                      fullseq=True)
    feats = model.pre_proc({jtools.KEY_FEATS: jnp.zeros((1, 1, CQT_BINS, 9))})
    variables = model.init({'params': jax.random.PRNGKey(1),
                            'dropout': jax.random.PRNGKey(2)},
                           feats[jtools.KEY_FEATS], train=False)
    port = TabCNN(dim_in=CQT_BINS, profile=tools.GuitarProfile(),
                  fullseq=True)
    port.load_state_dict(from_flax(variables))

    tracks = [_guitar_track(seed, frames)
              for seed, frames in enumerate(GUITAR_FRAMES)]

    return model, variables, port.eval(), tracks


def _logits(port, track, bucket):
    """The port's raw logits on a track, bucketed as run_offline pads."""

    feats = torch.from_numpy(track[tools.KEY_FEATS][None])
    frames = feats.shape[-1]
    kwargs = {}
    if bucket:
        feats = torch.nn.functional.pad(
            feats, (0, -(-frames // bucket) * bucket - frames))
        kwargs['lengths'] = torch.tensor([frames])
    with torch.no_grad():
        pre = port.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS]
        return {k: v[:, :frames] for k, v in port(pre, **kwargs).items()}


def test_run_offline_bucketed_matches_jax(piano):
    model, variables, port, tracks = piano
    track = tracks[1]
    profile = tools.PianoProfile()

    want = jinf.run_offline(dict(track), model, variables,
                            jtr.NoteTranscriber(profile=jtools.PianoProfile()),
                            bucket=BUCKET)
    got = inf.run_offline(dict(track), port,
                          tr.NoteTranscriber(profile=profile), bucket=BUCKET,
                          device='cpu')
    assert sorted(got) == sorted(want)

    # JAX's masked forward's logits, on the same padded features
    frames = track[tools.KEY_FEATS].shape[-1]
    feats = np.pad(track[tools.KEY_FEATS][None],
                   [(0, 0)] * 3 + [(0, 24 - frames)])
    pre = model.pre_proc({jtools.KEY_FEATS: jnp.asarray(feats)})
    ref = model.apply(variables, pre[jtools.KEY_FEATS],
                      lengths=jnp.asarray([frames]))
    logits = _logits(port, track, BUCKET)

    rows = np.zeros(88, dtype=bool)   # pitch rows whose maps differ
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS, tools.KEY_OFFSETS):
        ref_logits = np.asarray(ref[key])[0, :frames]
        np.testing.assert_allclose(logits[key][0].numpy(), ref_logits,
                                   atol=LOGIT_ATOL)
        if key == tools.KEY_OFFSETS:   # unthresholded probabilities
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       atol=LOGIT_ATOL)
            continue
        differ = got[key] != np.asarray(want[key])
        assert (np.abs(ref_logits.T[differ]) <= LOGIT_ATOL).all()
        rows |= differ.any(-1)

    # Notes equal in every pitch row whose maps agree
    notes, ref_notes = got[tools.KEY_NOTES], np.asarray(want[tools.KEY_NOTES])
    low = profile.low
    keep = ~rows[notes[:, 2].astype(int) - low]
    keep_ref = ~rows[ref_notes[:, 2].astype(int) - low]
    np.testing.assert_array_equal(notes[keep], ref_notes[keep_ref])
    assert keep_ref.sum() > 0, 'no notes compared'


@pytest.mark.parametrize('dtype', [None, torch.bfloat16])
def test_bucketed_equals_unbucketed_on_valid_frames(piano, dtype):
    _, variables, _, tracks = piano
    port = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                         model_complexity=2, dtype=dtype)
    port.load_state_dict(from_flax(variables))
    port.eval()

    with torch.backends.mkldnn.flags(enabled=False):
        for track in tracks:
            exact = _logits(port, track, 0)
            bucketed = _logits(port, track, 32)
            for key in exact:
                assert torch.equal(bucketed[key], exact[key]), key

            whole = inf.run_offline(dict(track), port, device='cpu')
            padded = inf.run_offline(dict(track), port, bucket=32,
                                     device='cpu')
            for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS,
                        tools.KEY_OFFSETS, tools.KEY_TIMES):
                np.testing.assert_array_equal(padded[key], whole[key])


def _of2(module, tools_module, profile):
    estimator = module[0].ComboEstimator([
        module[0].NoteTranscriber(profile=profile),
        module[0].PitchListWrapper(profile=profile)])
    evaluator = module[1].ComboEvaluator([
        module[1].LossWrapper(),
        module[1].MultipitchEvaluator(),
        module[1].NoteEvaluator(results_key=tools_module.KEY_NOTE_ON),
        module[1].NoteEvaluator(offset_ratio=0.2,
                                results_key=tools_module.KEY_NOTE_OFF)])
    return estimator, evaluator


def _tabcnn(module, profile):
    estimator = module[0].ComboEstimator([
        module[0].TablatureWrapper(profile=profile),
        module[0].StackedMultiPitchCollapser(profile=profile)])
    evaluator = module[1].ComboEvaluator([
        module[1].LossWrapper(), module[1].MultipitchEvaluator(),
        module[1].TablatureEvaluator(profile=profile),
        module[1].SoftmaxAccuracy()])
    return estimator, evaluator


def _flat(results, prefix=''):
    out = {}
    for key, value in results.items():
        if isinstance(value, dict):
            out.update(_flat(value, f'{prefix}{key}/'))
        else:
            out[prefix + key] = value
    return out


def _assert_results_close(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        loss = key.startswith(f'{tools.KEY_LOSS}/')
        np.testing.assert_allclose(got[key], want[key],
                                   atol=0 if loss else RESULT_TOL,
                                   rtol=RESULT_TOL if loss else 0,
                                   err_msg=key)


@pytest.mark.parametrize('recipe', ['of_2', 'tabcnn'])
def test_validate_matches_jax(recipe, piano, guitar):
    """The recipe's whole validation pass, bucketed, on a 3-track set of
    unequal lengths: the same averaged results within 1e-6."""

    if recipe == 'of_2':
        model, variables, port, tracks = piano
        jest, jeval = _of2((jtr, jev), jtools, jtools.PianoProfile())
        est, evaluator = _of2((tr, ev), tools, tools.PianoProfile())
    else:
        model, variables, port, tracks = guitar
        jest, jeval = _tabcnn((jtr, jev), jtools.GuitarProfile())
        est, evaluator = _tabcnn((tr, ev), tools.GuitarProfile())
    dataset = _Tracks(tracks)

    want = jev.validate(model, variables, dataset, jeval, jest,
                        bucket=BUCKET)
    got = ev.validate(port, dataset, evaluator, est, bucket=BUCKET,
                      device='cpu')

    _assert_results_close(got, want)
    notes = _flat(got).get(f'{tools.KEY_NOTE_ON}/{tools.KEY_F1}')
    assert recipe != 'of_2' or notes > 0, 'no notes matched'


@pytest.mark.parametrize('recipe', ['of_2', 'tabcnn'])
def test_batched_validate_equals_per_track(recipe, piano, guitar):
    """validate(batch_size=4, bucket=32) scores as the per-track loop (the
    loss terms are batch-level there, so LossWrapper stays out, as in
    JAX's ``tests/test_bucketed_eval.py``)."""

    if recipe == 'of_2':
        _, _, port, tracks = piano
        estimator, evaluator = _of2((tr, ev), tools, tools.PianoProfile())
    else:
        _, _, port, tracks = guitar
        estimator, evaluator = _tabcnn((tr, ev), tools.GuitarProfile())
    evaluator.evaluators = evaluator.evaluators[1:]
    dataset = _Tracks(tracks)

    per_track = ev.validate(port, dataset, copy.deepcopy(evaluator),
                            estimator, bucket=32, device='cpu')
    batched = ev.validate(port, dataset, copy.deepcopy(evaluator), estimator,
                          bucket=32, batch_size=4, device='cpu')

    _assert_results_close(batched, per_track)


def test_run_online_tabcnn_matches_jax():
    """Windowed (stateless) online inference: one 9-frame window a step."""

    rng = np.random.RandomState(0)
    feats = rng.rand(1, CQT_BINS, 10).astype(np.float32)
    model = JaxTabCNN(dim_in=CQT_BINS, profile=jtools.GuitarProfile(),
                      online=True)
    pre = model.pre_proc({jtools.KEY_FEATS: jnp.asarray(feats[None, ..., :9])})
    variables = model.init({'params': jax.random.PRNGKey(0),
                            'dropout': jax.random.PRNGKey(1)},
                           pre[jtools.KEY_FEATS], train=False)
    port = TabCNN(dim_in=CQT_BINS, profile=tools.GuitarProfile(),
                  online=True)
    port.load_state_dict(from_flax(variables))

    track = {tools.KEY_FEATS: feats, tools.KEY_TIMES: np.arange(10) * 0.023,
             tools.KEY_TRACK: 'tab_stream'}
    want = jinf.run_online(dict(track), model, variables,
                           jtr.TablatureWrapper(
                               profile=jtools.GuitarProfile()))
    got = inf.run_online(dict(track), port.eval(),
                         tr.TablatureWrapper(profile=tools.GuitarProfile()),
                         device='cpu')

    assert got[tools.KEY_TABLATURE].shape == (6, 10)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


@pytest.mark.parametrize('weighted', [False, True])
def test_softmax_groups_loss_matches_jax(weighted):
    rng = np.random.RandomState(3)
    groups, classes = 6, 21
    logits = (rng.randn(2, 30, groups * classes) * 3).astype(np.float32)
    labels = rng.randint(-1, classes - 1, (2, groups, 30))
    weights = rng.uniform(0.5, 2.0, groups * classes).astype(np.float32) \
        if weighted else None

    head = JaxSoftmaxGroups(dim_in=4, dim_out=groups * classes,
                            num_groups=groups, num_classes=classes,
                            weights=weights)
    want = float(head.get_loss(jnp.asarray(logits), jnp.asarray(labels)))
    port = SoftmaxGroups(4, groups * classes, groups, classes)
    got = port.get_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        weights=weights).item()

    # Relative: a float32 loss of 20-50 has an ulp of 2-4e-6
    np.testing.assert_allclose(got, want, rtol=RESULT_TOL, atol=0)


def test_tabcnn_post_proc_adds_the_loss(guitar):
    model, variables, port, tracks = guitar
    track = tracks[0]

    got = inf.run_offline(dict(track), port, device='cpu')
    want = jinf.run_offline(dict(track), model, variables)

    np.testing.assert_allclose(got[tools.KEY_LOSS][tools.KEY_LOSS_TOTAL],
                               float(want[tools.KEY_LOSS][
                                   tools.KEY_LOSS_TOTAL]), rtol=RESULT_TOL,
                               atol=0)
    np.testing.assert_array_equal(got[tools.KEY_TABLATURE],
                                  np.asarray(want[tools.KEY_TABLATURE]))
    assert got[tools.KEY_TABLATURE].shape == (6, GUITAR_FRAMES[0])


def test_entry_points_without_a_device_raise_when_no_cuda(piano):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    _, _, port, tracks = piano
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inf.run_offline(dict(tracks[0]), port)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ev.validate(port, _Tracks(tracks), ev.LossWrapper())
