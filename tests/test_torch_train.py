"""The training loop: the port's train step against the JAX package's, the
optimizers, resume, accumulation and ephemeral runs, on the CPU.

Cross-framework checks step SGD, not Adam: a conv bias that feeds a
train-mode BatchNorm has a gradient of pure rounding noise, which Adam
divides by its own magnitude into steps of about +-lr with signs that
differ between frameworks. Adam alone is checked on identical gradients.

Tolerances: parameters and batch statistics after 3 SGD steps within
``atol=1e-5, rtol=1e-4`` (float32 gradients in another order, three
times); Adam on identical gradients within 1e-6 of each moment tensor's
largest value and ``rtol=1e-6`` on the parameters (its arithmetic in
another order). The port's own runs are bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.train import init_state
from amt_tools_tpu.train import make_train_step as jax_make_train_step

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import OnsetsFrames2, run_on_batch
from amt_tools_tpu_torch.train import (latest_checkpoint, make_train_step,
                                       train)
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

DIM_IN, FRAMES = 16, 12


def _batch(seed, batch=2):
    rng = np.random.RandomState(seed)
    return {
        tools.KEY_FEATS: rng.rand(batch, 1, DIM_IN, FRAMES).astype(np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(batch, 88, FRAMES) < 0.1).astype(
            np.float32),
    }


def _model(dropout=True, seed=0):
    return OnsetsFrames2(dim_in=DIM_IN, profile=tools.PianoProfile(),
                         model_complexity=2, dropout=dropout,
                         generator=torch.Generator().manual_seed(seed))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_three_sgd_steps_match_jax():
    batches = [_batch(s) for s in range(3)]
    lr = 0.05

    jax_model = JaxOnsetsFrames2(dim_in=DIM_IN, profile=jtools.PianoProfile(),
                                 model_complexity=2, dropout=False)
    optimizer = optax.sgd(lr)
    state = init_state(jax_model, optimizer, jtools.dict_to_jax(batches[0]),
                       rng=jax.random.PRNGKey(0))
    model = _model(dropout=False)
    model.load_state_dict(from_flax(state.variables()))

    jax_step = jax_make_train_step(jax_model, optimizer, donate=False)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=lr))
    for batch in batches:
        state, ref_loss = jax_step(state, jtools.dict_to_jax(batch))
        loss = step(_tensors(batch))
        np.testing.assert_allclose(loss[tools.KEY_LOSS_TOTAL].item(),
                                   float(ref_loss[jtools.KEY_LOSS_TOTAL]),
                                   rtol=1e-5)

    ref = from_flax(state.variables())
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=key)


def test_adam_matches_optax_on_identical_gradients():
    rng = np.random.RandomState(4)
    shapes = [(5, 7), (3,), (2, 4, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]

    optimizer = optax.adam(6e-4)
    jax_params = [jnp.asarray(p) for p in params]
    opt_state = optimizer.init(jax_params)

    torch_params = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    adam = torch.optim.Adam(torch_params, lr=6e-4)

    for _ in range(5):
        # Gradients of many scales, some tiny (as a conv bias's noise)
        grads = [(rng.randn(*s) * 10.0 ** rng.uniform(-8, 1, s)).astype(
            np.float32) for s in shapes]

        updates, opt_state = optimizer.update([jnp.asarray(g) for g in grads],
                                              opt_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)

        for p, g in zip(torch_params, grads):
            p.grad = torch.from_numpy(g)
        adam.step()

        # The moments (torch's lerp rounds elsewhere than optax's weighted
        # sum: within 1e-6 of the tensor's largest), then the parameters
        moments = opt_state[0]
        for p, mu, nu in zip(torch_params, moments.mu, moments.nu):
            for key, ref in (('exp_avg', mu), ('exp_avg_sq', nu)):
                ref = np.asarray(ref)
                np.testing.assert_allclose(adam.state[p][key].numpy(), ref,
                                           rtol=0, atol=1e-6 * np.abs(ref).max())
        for p, ref in zip(torch_params, jax_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-9)


class _Loader:
    """A re-iterable loader over fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def _schedule(count):
    return 1.0 / (1.0 + 0.5 * count)


def test_resume_continues_bit_for_bit(tmp_path):
    """train(6) equals train(3) plus a resume to 6, with dropout and the
    scheduler on: the dropout noise comes from (seed, step) and the
    schedule's count is in the checkpoint."""

    loader = _Loader([_batch(0), _batch(1)])

    def run(iterations, log_dir, seed):
        model = _model(dropout=True)
        optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
        result = train(model, loader, optimizer, iterations, checkpoints=0,
                       log_dir=log_dir, scheduler=_schedule, seed=seed,
                       device='cpu')
        return model, optimizer, result

    model, optimizer, straight = run(6, str(tmp_path / 'straight'), seed=3)
    assert straight['step'] == 12

    _, _, first = run(3, str(tmp_path / 'resumed'), seed=3)
    assert first['step'] == 6
    assert latest_checkpoint(str(tmp_path / 'resumed'))[1] == 3
    # The resumed call takes the seed from the checkpoint, not its argument
    resumed_model, resumed_opt, second = run(6, str(tmp_path / 'resumed'),
                                             seed=99)
    assert second['step'] == 12

    for key in straight['losses']:
        assert (first['losses'][key] + second['losses'][key] ==
                straight['losses'][key]), key
    for key, value in model.state_dict().items():
        assert torch.equal(value, resumed_model.state_dict()[key]), key
    assert ([g['lr'] for g in optimizer.param_groups] ==
            [g['lr'] for g in resumed_opt.param_groups])
    assert optimizer.param_groups[0]['lr'] == pytest.approx(
        1e-3 * _schedule(11))


def test_dropout_noise_changes_with_the_seed():
    loader = _Loader([_batch(0)])
    losses = []
    for seed in (0, 0, 1):
        model = _model(dropout=True)
        result = train(model, loader,
                       torch.optim.SGD(model.parameters(), lr=0.01), 2,
                       log_dir=None, seed=seed, device='cpu')
        losses.append(result['losses'][tools.KEY_LOSS_TOTAL])

    assert losses[0] == losses[1] and losses[0] != losses[2]


def test_accumulation_equals_the_manual_average():
    batch = _tensors(_batch(5, batch=4))

    model = _model(dropout=False)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
    loss = make_train_step(model, optimizer, accum_steps=2)(batch)

    # By hand: each half's gradient alone (the second after the first's
    # BatchNorm update), averaged, then one update
    manual = _model(dropout=False)
    manual_opt = torch.optim.SGD(manual.parameters(), lr=0.1)
    grads, losses = [], []
    for half in (slice(0, 2), slice(2, 4)):
        manual_opt.zero_grad()
        out = run_on_batch(manual, {k: v[half] for k, v in batch.items()},
                           train=True)
        out[tools.KEY_LOSS][tools.KEY_LOSS_TOTAL].backward()
        grads.append([p.grad.clone() for p in manual.parameters()])
        losses.append(out[tools.KEY_LOSS][tools.KEY_LOSS_TOTAL].item())
    for p, g0, g1 in zip(manual.parameters(), *grads):
        p.grad = (g0 + g1) / 2
    manual_opt.step()

    assert loss[tools.KEY_LOSS_TOTAL].item() == pytest.approx(
        sum(losses) / 2, rel=1e-6)
    for key, value in manual.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key


def test_indivisible_batch_raises():
    model = _model(dropout=False)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                           accum_steps=3)
    with pytest.raises(ValueError, match='divisible'):
        step(_tensors(_batch(0, batch=4)))


def test_ephemeral_run_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = _model(dropout=True)
    result = train(model, _Loader([_batch(0)]),
                   torch.optim.Adam(model.parameters(), lr=1e-3), 2,
                   checkpoints=2, log_dir=None, device='cpu')

    assert result['step'] == 2
    assert np.isfinite(result['losses'][tools.KEY_LOSS_TOTAL]).all()
    assert os.listdir(tmp_path) == []


def test_checkpoints_and_validation_arguments(tmp_path):
    model = _model(dropout=False)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01)
    train(model, _Loader([_batch(0)]), optimizer, 4, checkpoints=2,
          log_dir=str(tmp_path), device='cpu')
    assert sorted(os.listdir(tmp_path)) == ['model-2.ckpt', 'model-4.ckpt']
    assert latest_checkpoint(str(tmp_path), max_iteration=3)[1] == 2

    # single_batch takes one batch a pass
    result = train(model, _Loader([_batch(0), _batch(1)]), optimizer, 3,
                   log_dir=None, single_batch=True, device='cpu')
    assert result['step'] == 3

    # A validation set without an evaluator validates nothing (as in JAX);
    # validation itself is tests/test_torch_train_validate.py's
    result = train(model, _Loader([_batch(0)]), optimizer, 2, checkpoints=2,
                   log_dir=None, val_set=[], device='cpu')
    assert result['step'] == 2
