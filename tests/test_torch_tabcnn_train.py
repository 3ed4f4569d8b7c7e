"""TabCNN training against the JAX package on the CPU, in float32: the
train-mode forward (windowed and ``fullseq``) with its softmax CE loss and
gradients, ``SyntheticGuitar`` and what it needs
(``render_notes(velocity_range=...)``,
``tools.stacked_multi_pitch_to_tablature``), ``torch.optim.Adadelta``
against ``optax.adadelta`` (the recipe's optimizer,
``examples/papers/synthetic_tabcnn.py``), and ``train()`` on synthetic
guitar tracks.

Tolerances:
- logits: 1e-5 absolute; losses: 1e-6 relative (float32 sums in another
  order);
- gradients: 1e-4 of the largest gradient of the same module
  (``tests/test_torch_train_model.py``);
- audio, tablature, multi-pitch and notes: bit for bit (the same numpy
  arithmetic in the same order);
- CQT features of a track: 2e-4 on the [0, 1] scale, each side computing
  its own (``tests/test_torch_cqt.py``);
- Adadelta: parameters within 1e-6 of the largest (a square root and a
  division a step, in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.datasets import synthetic as jsynthetic
from amt_tools_tpu.features import CQT as JaxCQT
from amt_tools_tpu.models import TabCNN as JaxTabCNN
from amt_tools_tpu.models.common import run_on_batch as jax_run_on_batch

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.datasets import (DataLoader, SyntheticGuitar,
                                          render_notes)
from amt_tools_tpu_torch.features import CQT
from amt_tools_tpu_torch.models import TabCNN, run_on_batch
from amt_tools_tpu_torch.train import train
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

LOGIT_TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-4
FEATURE_TOL = 2e-4
ADADELTA_TOL = 1e-6


def _module_scale(grads, name):
    module = name.rsplit('.', 1)[0]
    return max(np.abs(v).max() for k, v in grads.items()
               if k.rsplit('.', 1)[0] == module)


def _tab_batch(rng, batch=2, dim_in=24, frames=10):
    profile = jtools.GuitarProfile()
    tablature = rng.randint(-1, profile.num_pitches, (batch, 6, frames))
    return {jtools.KEY_FEATS: rng.rand(batch, 1, dim_in, frames).astype(
                np.float32),
            jtools.KEY_TABLATURE: tablature.astype(np.int64)}


@pytest.mark.parametrize('fullseq', [False, True])
def test_train_forward_loss_and_gradients_match_flax(fullseq):
    rng = np.random.RandomState(0)
    data = _tab_batch(rng)
    jax_model = JaxTabCNN(dim_in=24, profile=jtools.GuitarProfile(),
                          fullseq=fullseq, dropout=False)
    jax_batch = {k: jnp.asarray(v) for k, v in data.items()}
    variables = jax_model.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jax_model.pre_proc(jax_batch)[jtools.KEY_FEATS])

    def loss_fn(params):
        output, _ = jax_run_on_batch(jax_model, {'params': params}, jax_batch,
                                     train=True,
                                     rngs={'dropout': jax.random.PRNGKey(2)})
        return output[jtools.KEY_LOSS][jtools.KEY_LOSS_TOTAL], output

    grads, ref = jax.grad(loss_fn, has_aux=True)(variables['params'])
    ref_logits = jax_model.apply(
        variables, jax_model.pre_proc(jax_batch)[jtools.KEY_FEATS],
        train=True, rngs={'dropout': jax.random.PRNGKey(2)})

    model = TabCNN(dim_in=24, profile=tools.GuitarProfile(), fullseq=fullseq,
                   dropout=False)
    model.load_state_dict(from_flax(variables))
    batch = {k: torch.from_numpy(v) for k, v in data.items()}

    model.train()
    logits = model(model.pre_proc(batch)[tools.KEY_FEATS])
    np.testing.assert_allclose(
        logits[tools.KEY_TABLATURE].detach().numpy(),
        np.asarray(ref_logits[jtools.KEY_TABLATURE]), rtol=0, atol=LOGIT_TOL)

    output = run_on_batch(model, batch, train=True)
    loss = output[tools.KEY_LOSS][tools.KEY_LOSS_TOTAL]
    loss.backward()
    np.testing.assert_allclose(
        loss.item(), float(ref[jtools.KEY_LOSS][jtools.KEY_LOSS_TOTAL]),
        rtol=LOSS_RTOL)
    assert np.array_equal(output[tools.KEY_TABLATURE].numpy(),
                          np.asarray(ref[jtools.KEY_TABLATURE]))

    ref_grads = {k: v.numpy() for k, v in from_flax({'params': grads}).items()}
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(ref_grads)
    for name, param in names.items():
        diff = np.abs(param.grad.numpy() - ref_grads[name]).max()
        assert diff <= GRAD_TOL * _module_scale(ref_grads, name), name


@pytest.mark.parametrize('fullseq', [False, True])
def test_train_dropout_draws_from_the_generator(fullseq):
    """Dropout (0.25 after the pool, 0.5 after dense1) is on in train mode
    with ``dropout``, draws from the explicit generator (the same seed, the
    same logits) and is off in eval mode or with the flag off."""

    model = TabCNN(dim_in=24, profile=tools.GuitarProfile(), fullseq=fullseq)
    feats = model.pre_proc({tools.KEY_FEATS: torch.rand(2, 1, 24, 10)})[
        tools.KEY_FEATS]

    model.eval()
    clean = model(feats)[tools.KEY_TABLATURE]
    model.train()
    noisy = model(feats, torch.Generator().manual_seed(1))[tools.KEY_TABLATURE]
    again = model(feats, torch.Generator().manual_seed(1))[tools.KEY_TABLATURE]
    other = model(feats, torch.Generator().manual_seed(2))[tools.KEY_TABLATURE]
    assert torch.equal(noisy, again)
    assert not torch.equal(noisy, other) and not torch.equal(noisy, clean)

    model.dropout = False
    assert torch.equal(model(feats)[tools.KEY_TABLATURE], clean)


@pytest.mark.parametrize('velocity_range', [None, (0.3, 1.0)])
def test_render_notes_velocity_range_bit_for_bit(velocity_range):
    rng = np.random.RandomState(3)
    pitches = rng.randint(40, 80, 6).astype(float)
    onsets = np.sort(rng.uniform(0, 1.5, 6))
    intervals = np.stack([onsets, onsets + 0.3], -1)
    kwargs = dict(seed=5, velocity_range=velocity_range, timbre_jitter=0.2)

    ref = jsynthetic.render_notes(pitches, intervals, 16000, 2.0, **kwargs)
    got = render_notes(pitches, intervals, 16000, 2.0, **kwargs)
    assert got.dtype == np.float32 and np.array_equal(got, ref)

    # Explicit velocities override the range, as in JAX
    velocities = np.full(6, 0.5)
    assert np.array_equal(
        render_notes(pitches, intervals, 16000, 2.0, velocities=velocities,
                     **kwargs),
        jsynthetic.render_notes(pitches, intervals, 16000, 2.0,
                                velocities=velocities, **kwargs))


def test_stacked_multi_pitch_to_tablature_matches_jax():
    profile = tools.GuitarProfile(num_frets=19)
    rng = np.random.RandomState(4)
    stacked = (rng.rand(3, 6, profile.get_range_len(), 17) < 0.05).astype(
        np.float32)

    ref = jtools.stacked_multi_pitch_to_tablature(
        stacked, jtools.GuitarProfile(num_frets=19))
    got = tools.stacked_multi_pitch_to_tablature(stacked, profile)
    assert got.shape == (3, 6, 17) and np.array_equal(got, ref)
    assert (got == -1).any() and (got >= 0).any()


@pytest.mark.parametrize('velocity_range', [None, (0.3, 1.0)])
def test_synthetic_guitar_tracks_match_jax(velocity_range):
    kwargs = dict(num_tracks=2, track_duration=1.5, notes_per_track=12,
                  velocity_range=velocity_range)
    ref_set = jsynthetic.SyntheticGuitar(
        data_proc=JaxCQT(n_bins=48, bins_per_octave=12),
        profile=jtools.GuitarProfile(num_frets=19), **kwargs)
    got_set = SyntheticGuitar(data_proc=CQT(n_bins=48, bins_per_octave=12),
                              profile=tools.GuitarProfile(num_frets=19),
                              device='cpu', **kwargs)
    assert got_set.tracks == ref_set.tracks

    for track in ref_set.tracks:
        ref = ref_set.get_track_data(track)
        got = got_set.get_track_data(track)
        for key in (tools.KEY_AUDIO, tools.KEY_TABLATURE,
                    tools.KEY_MULTIPITCH, tools.KEY_NOTES):
            assert np.asarray(got[key]).dtype == np.asarray(ref[key]).dtype
            assert np.array_equal(np.asarray(got[key]),
                                  np.asarray(ref[key])), (track, key)
        assert got[tools.KEY_TABLATURE].shape[0] == 6
        np.testing.assert_allclose(got[tools.KEY_FEATS],
                                   np.asarray(ref[jtools.KEY_FEATS]), rtol=0,
                                   atol=FEATURE_TOL)


def test_adadelta_matches_optax_on_identical_gradients():
    rng = np.random.RandomState(5)
    params = {'w': rng.randn(7, 5).astype(np.float32),
              'b': rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 10 ** -i
              for k, v in params.items()} for i in range(6)]

    optimizer = optax.adadelta(1.0)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = optimizer.init(jax_params)

    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for k, v in params.items()}
    torch_optimizer = torch.optim.Adadelta(torch_params.values(), lr=1.0)

    for grad in grads:
        updates, state = optimizer.update(
            {k: jnp.asarray(v) for k, v in grad.items()}, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(grad[k])
        torch_optimizer.step()

    for k, p in torch_params.items():
        ref = np.asarray(jax_params[k])
        diff = np.abs(p.detach().numpy() - ref).max()
        assert diff <= ADADELTA_TOL * np.abs(ref).max(), k
        # Adadelta moved the parameters (a real step, not a no-op)
        assert np.abs(ref - params[k]).max() > 1e-4


def test_tabcnn_loss_falls_through_train(tmp_path):
    """The recipe in miniature: windowed TabCNN on SyntheticGuitar CQT
    crops, Adadelta 1.0, a few passes of ``train()`` on the CPU; the loss of
    the last pass is below the first's and every loss is finite."""

    profile = tools.GuitarProfile(num_frets=19)
    cqt = CQT(n_bins=48, bins_per_octave=12)
    dataset = SyntheticGuitar(data_proc=cqt, profile=profile, num_tracks=4,
                              track_duration=1.5, notes_per_track=12,
                              num_frames=16, device='cpu')
    loader = DataLoader(dataset, batch_size=4, shuffle=True, drop_last=True,
                        seed=0)
    model = TabCNN(dim_in=48, profile=profile,
                   generator=torch.Generator().manual_seed(0))

    result = train(model, loader, torch.optim.Adadelta(model.parameters(),
                                                       lr=1.0),
                   iterations=12, log_dir=None, device='cpu')

    losses = result['losses'][tools.KEY_LOSS_TOTAL]
    assert result['step'] == 12 and len(losses) == 12
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0]
