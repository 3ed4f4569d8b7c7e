"""The 500-step convergence differential, port against the JAX package, on
the CPU (``tests/test_reference_differential.py``'s
``test_convergence_differential`` with the JAX package in the reference's
place; PARITY.md "Convergence scale").

O&F (V1) at complexity 2 on 48 mel bins over a 13-key ``PianoProfile(52,
64)``, 8 SyntheticPiano tracks of 8 s (6 to train, 2 held out), batch 4,
crops of 96 frames, Adam 2e-3, dropout off, 500 steps on each side from
the same weights (the port's seeded initialization, converted to the Flax
layout for the JAX package: the weights ``chip_smoke.py`` phase 47 can
build on the card without JAX) and the same crop stream (``RandomState(7)``) over one corpus (the JAX package's
tracks and features, as the reference test shares the rebuild's); each
side scores the held-out tracks with its own ``validate`` (bucketed by 128
frames: the masked recurrence). Both must learn (frame F1
above 0.6, the last loss below half the first) and agree within 0.04 frame
F1 and 0.10 note F1: 500 steps of float32 sums in another order compound
into different weights, which land at the same plateau (see the reference
test for why the corpus is this narrow).

``chip_smoke.py`` phase 47 trains the port's side on the card and holds it
to the JAX figures it carries as constants; this test checks those
constants against the JAX run, within 1e-3.

Marked slow: about 5 minutes on one CPU core, most of it the port's plain
LSTM loops.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from amt_tools_tpu import evaluate as jax_evaluate
from amt_tools_tpu import tools as jtools
from amt_tools_tpu import transcribe as jax_transcribe
from amt_tools_tpu.datasets import SyntheticPiano as JaxSyntheticPiano
from amt_tools_tpu.features import MelSpec as JaxMelSpec
from amt_tools_tpu.models import OnsetsFrames as JaxOnsetsFrames
from amt_tools_tpu.train import init_state
from amt_tools_tpu.train import make_train_step as jax_make_train_step

from amt_tools_tpu_torch import evaluate, tools, transcribe
from amt_tools_tpu_torch.models import OnsetsFrames
from amt_tools_tpu_torch.train import make_train_step
from amt_tools_tpu_torch.weights import from_flax

SAMPLE_RATE, HOP, DIM_IN, COMPLEXITY, LR = 16000, 512, 48, 2, 2e-3
STEPS, BATCH, CROP, BUCKET = 500, 4, 96, 128
FRAME_TOL, NOTE_TOL, CONSTANT_TOL = 0.04, 0.10, 1e-3


def _corpus(dataset, mel, profile):
    corpus = dataset(base_dir='.', data_proc=mel, profile=profile,
                     num_frames=None, num_tracks=8, track_duration=8.0,
                     notes_per_track=24, save_data=False, seed=0)
    return {t: corpus.get_track_data(t) for t in corpus.tracks}, corpus.tracks


def _crops(tracks, names):
    """The crop stream both sides train on: ``STEPS`` batches from
    ``RandomState(7)``."""

    stream = np.random.RandomState(7)
    for _ in range(STEPS):
        parts = {jtools.KEY_FEATS: [], jtools.KEY_MULTIPITCH: [],
                 jtools.KEY_ONSETS: []}
        for _ in range(BATCH):
            track = tracks[names[stream.randint(len(names))]]
            start = stream.randint(0, track[jtools.KEY_FEATS].shape[-1] -
                                   CROP)
            parts[jtools.KEY_FEATS].append(
                track[jtools.KEY_FEATS][..., start:start + CROP])
            for key in (jtools.KEY_MULTIPITCH, jtools.KEY_ONSETS):
                parts[key].append(track[key][:, start:start + CROP])
        yield {k: np.stack(v).astype(np.float32) for k, v in parts.items()}


class _Holdout:
    def __init__(self, tracks, names):
        self.tracks = list(names)
        self._data = tracks

    def get_track_data(self, track_id):
        return dict(self._data[track_id])


def _f1s(results):
    return (float(results[jtools.KEY_MULTIPITCH][jtools.KEY_F1]),
            float(results[jtools.KEY_NOTES][jtools.KEY_F1]))


def jax_corpus():
    """The corpus both sides train on and score: the JAX package's
    SyntheticPiano tracks and mel features, as numpy arrays."""

    mel = JaxMelSpec(sample_rate=SAMPLE_RATE, hop_length=HOP, n_mels=DIM_IN)
    return _corpus(JaxSyntheticPiano, mel, jtools.PianoProfile(52, 64))


def port_model():
    """The port's model at its seeded initialization (``generator`` seed 0),
    the weights both sides start from, as ``chip_smoke.py`` phase 47 builds
    it on the card."""

    return OnsetsFrames(dim_in=DIM_IN, profile=tools.PianoProfile(52, 64),
                        model_complexity=COMPLEXITY, dropout=False,
                        generator=torch.Generator().manual_seed(0))


def to_flax(state, like):
    """A port ``state_dict`` in the layout of the Flax variables ``like``:
    the inverse of ``weights.from_flax`` (HWIO conv kernels, (in, out)
    dense kernels, ``scale``, ``mean`` and ``var``)."""

    stats = {'mean': 'running_mean', 'var': 'running_var'}

    def convert(collection, path, leaf):
        *modules, name = [getattr(k, 'key', k) for k in path]
        value = state[f'{".".join(modules)}.' + (
            stats[name] if collection == 'batch_stats' else
            'weight' if name in ('kernel', 'scale') else name)].numpy()
        if name == 'kernel':
            value = (value.transpose(2, 3, 1, 0) if value.ndim == 4 else
                     value.T)
        assert value.shape == leaf.shape, (path, value.shape, leaf.shape)
        return jnp.asarray(value, leaf.dtype)

    return {collection: jax.tree_util.tree_map_with_path(
        lambda path, leaf: convert(collection, path, leaf), tree)
        for collection, tree in like.items()}


def jax_side(tracks, names, initial):
    """The JAX package's run from the port's ``initial`` ``state_dict`` ->
    (first and last loss, held-out frame and note F1)."""

    profile = jtools.PianoProfile(52, 64)

    model = JaxOnsetsFrames(dim_in=DIM_IN, profile=profile,
                            model_complexity=COMPLEXITY, dropout=False)
    optimizer = optax.adam(LR)
    batches = _crops(tracks, names[:6])
    first = next(batches)
    state = init_state(model, optimizer, jtools.dict_to_jax(first),
                       rng=jax.random.PRNGKey(0))
    variables = to_flax(initial, state.variables())
    state = state.replace(params=variables['params'],
                          batch_stats=variables['batch_stats'],
                          opt_state=optimizer.init(variables['params']))
    step = jax_make_train_step(model, optimizer, donate=False)

    losses = []
    for batch in [first, *batches]:
        state, loss = step(state, jtools.dict_to_jax(batch))
        losses.append(float(loss[jtools.KEY_LOSS_TOTAL]))

    estimator = jax_transcribe.ComboEstimator(
        [jax_transcribe.NoteTranscriber(profile=profile)])
    evaluator = jax_evaluate.ComboEvaluator(
        [jax_evaluate.MultipitchEvaluator(), jax_evaluate.NoteEvaluator()])
    results = jax_evaluate.validate(model, state.variables(),
                                    _Holdout(tracks, names[6:]), evaluator,
                                    estimator, bucket=BUCKET)

    return (losses[0], losses[-1]), _f1s(results)


def port_side(tracks, names, device):
    """The port's run from :func:`port_model` on ``device`` -> (first and
    last loss, held-out frame and note F1)."""

    profile = tools.PianoProfile(52, 64)

    model = port_model().to(device)
    step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                   lr=LR))
    losses = []
    for batch in _crops(tracks, names[:6]):
        loss = step({k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()})
        losses.append(float(loss[tools.KEY_LOSS_TOTAL]))

    estimator = transcribe.ComboEstimator(
        [transcribe.NoteTranscriber(profile=profile)])
    evaluator = evaluate.ComboEvaluator(
        [evaluate.MultipitchEvaluator(), evaluate.NoteEvaluator()])
    results = evaluate.validate(model, _Holdout(tracks, names[6:]),
                                evaluator, estimator, bucket=BUCKET,
                                device=device)

    return (losses[0], losses[-1]), _f1s(results)


def _smoke_constants():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.CONVERGENCE_JAX_F1


@pytest.mark.slow
def test_convergence_differential():
    torch.set_num_threads(1)
    tracks, names = jax_corpus()
    initial = port_model().state_dict()
    like = JaxOnsetsFrames(dim_in=DIM_IN, profile=jtools.PianoProfile(52, 64),
                           model_complexity=COMPLEXITY, dropout=False)
    variables = like.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, CROP, DIM_IN, 1)))
    # The conversion is from_flax's inverse
    round_trip = from_flax(to_flax(initial, variables))
    assert sorted(round_trip) == sorted(initial)
    assert all(torch.equal(round_trip[k], initial[k]) for k in initial)

    jax_losses, jax_f1 = jax_side(tracks, names, initial)
    port_losses, port_f1 = port_side(tracks, names, 'cpu')
    print(f'\nconvergence differential: JAX losses {jax_losses}, F1 '
          f'(frame, note) {jax_f1}; port losses {port_losses}, F1 {port_f1}')

    for first, last in (jax_losses, port_losses):
        assert last < 0.5 * first, (first, last)
    assert jax_f1[0] > 0.6 and port_f1[0] > 0.6, (jax_f1, port_f1)
    assert abs(port_f1[0] - jax_f1[0]) < FRAME_TOL, (port_f1, jax_f1)
    assert abs(port_f1[1] - jax_f1[1]) < NOTE_TOL, (port_f1, jax_f1)

    constants = _smoke_constants()
    assert abs(constants['frame'] - jax_f1[0]) <= CONSTANT_TOL, constants
    assert abs(constants['note'] - jax_f1[1]) <= CONSTANT_TOL, constants
