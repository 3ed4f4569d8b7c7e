"""The velocity head against the JAX package on the CPU, in float32:
``RegressionBank`` (its projection, log domain, masked MSE and finalize)
and ``OnsetsFrames2(estimate_velocity=True)`` (eval logits, a train-mode
``run_on_batch``'s losses and velocity-head gradients, the finalized
velocity map, the warning when the batch has no velocities), with the
Flax variables loaded through ``weights.from_flax``.

Tolerances:
- logits: 1e-5 absolute (float32 products in another order);
- the log-domain maps and the finalized velocities: 1e-6 absolute (one
  float32 ``log10`` or ``10 ** x`` against XLA's, values in [0, 1]);
- losses: 1e-6 relative, the head's masked MSE on given logits and a
  whole model's (float32 sums in another order);
- gradients: 1e-4 of the largest gradient of the same module, as
  ``tests/test_torch_train_model.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models import RegressionBank as JaxRegressionBank
from amt_tools_tpu.models.common import run_on_batch as jax_run_on_batch

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import (OnsetsFrames2, RegressionBank,
                                        run_on_batch)
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

LOGIT_TOL = 1e-5
MAP_TOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-4


def _bank_pair(dim_in=12, dim_out=88, floor_db=-30.0):
    jax_bank = JaxRegressionBank(dim_in=dim_in, dim_out=dim_out,
                                 floor_db=floor_db)
    variables = jax_bank.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, dim_in)))
    bank = RegressionBank(dim_in, dim_out, floor_db=floor_db)
    bank.load_state_dict(from_flax(variables))
    return jax_bank, variables, bank


def test_regression_bank_forward_matches_flax():
    jax_bank, variables, bank = _bank_pair()
    x = np.random.RandomState(0).randn(2, 7, 12).astype(np.float32)

    ref = jax_bank.apply(variables, jnp.asarray(x))
    got = bank(torch.from_numpy(x))

    assert got.shape == (2, 7, 88)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=LOGIT_TOL)
    # Bias starts at zero, as Flax's Dense
    assert torch.count_nonzero(RegressionBank(4, 3).Dense_0.bias) == 0


@pytest.mark.parametrize('floor_db', [-30.0, -20.0])
def test_log_domain_matches_jax(floor_db):
    jax_bank, _, bank = _bank_pair(floor_db=floor_db)
    values = np.concatenate([[0.0, 1e-3, 10 ** (floor_db / 20), 0.5, 1.0,
                              1.5],
                             np.random.RandomState(1).rand(50)]).astype(
                                 np.float32)

    ref = np.asarray(jax_bank.to_log_domain(jnp.asarray(values)))
    got = bank.to_log_domain(torch.from_numpy(values)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=MAP_TOL)
    # The floor maps to 0, 1.0 to 1, and values outside are clipped
    assert got[0] == got[1] == pytest.approx(0.0, abs=1e-6)
    assert got[4] == got[5] == pytest.approx(1.0, abs=1e-6)

    back = np.asarray(jax_bank.from_log_domain(jnp.asarray(ref)))
    got_back = bank.from_log_domain(torch.from_numpy(np.array(ref))).numpy()
    np.testing.assert_allclose(got_back, back, rtol=0, atol=MAP_TOL)


def test_masked_mse_and_finalize_match_jax():
    jax_bank, _, bank = _bank_pair()
    rng = np.random.RandomState(2)
    logits = (rng.randn(3, 9, 88) * 3).astype(np.float32)
    reference = np.where(rng.rand(3, 88, 9) < 0.3,
                         rng.uniform(0.1, 1.0, (3, 88, 9)), 0.0).astype(
                             np.float32)
    mask = (reference > 0).astype(np.float32)

    ref = float(jax_bank.get_loss(jnp.asarray(logits), jnp.asarray(reference),
                                  jnp.asarray(mask)))
    got = bank.get_loss(torch.from_numpy(logits), torch.from_numpy(reference),
                        torch.from_numpy(reference) > 0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), ref, rtol=LOSS_RTOL)

    # An empty mask divides by one: the loss is 0, not NaN
    empty = bank.get_loss(torch.from_numpy(logits), torch.zeros(3, 88, 9),
                          torch.zeros(3, 88, 9))
    assert empty.item() == 0.0

    final = np.asarray(jax_bank.finalize_output(jnp.asarray(logits)))
    got_final = bank.finalize_output(torch.from_numpy(logits)).numpy()
    assert got_final.shape == (3, 88, 9)
    np.testing.assert_allclose(got_final, final, rtol=0, atol=MAP_TOL)


def _velocity_batch(rng, batch=2, dim_in=16, frames=20):
    feats = rng.rand(batch, 1, dim_in, frames).astype(np.float32)
    multi_pitch = (rng.rand(batch, 88, frames) < 0.1).astype(np.float32)
    velocity = np.where(multi_pitch > 0,
                        rng.uniform(0.2, 1.0, (batch, 88, frames)),
                        0.0).astype(np.float32)
    return {jtools.KEY_FEATS: feats, jtools.KEY_MULTIPITCH: multi_pitch,
            jtools.KEY_VELOCITY: velocity}


def _model_pair(dim_in=16):
    jax_model = JaxOnsetsFrames2(dim_in=dim_in, profile=jtools.PianoProfile(),
                                 model_complexity=2, estimate_velocity=True,
                                 dropout=False)
    variables = jax.jit(jax_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, dim_in, 1)))
    model = OnsetsFrames2(dim_in=dim_in, profile=tools.PianoProfile(),
                          model_complexity=2, estimate_velocity=True,
                          dropout=False)
    model.load_state_dict(from_flax(variables))
    return jax_model, variables, model


def test_velocity_tree_maps_and_eval_logits_match_flax():
    jax_model, variables, model = _model_pair()
    assert sorted(from_flax(variables)) == sorted(model.state_dict())
    assert model.head_names[-1] == 'velocity'

    data = _velocity_batch(np.random.RandomState(3))
    jax_batch = jax_model.pre_proc({k: jnp.asarray(v)
                                    for k, v in data.items()})
    ref = jax_model.apply(variables, jax_batch[jtools.KEY_FEATS])

    model.eval()
    with torch.no_grad():
        feats = model.pre_proc({tools.KEY_FEATS: torch.from_numpy(
            data[tools.KEY_FEATS])})[tools.KEY_FEATS]
        got = model(feats)

    assert sorted(got) == sorted(ref)
    assert tools.KEY_VELOCITY in got
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=LOGIT_TOL, err_msg=key)


def _module_scale(grads, name):
    module = name.rsplit('.', 1)[0]
    return max(np.abs(v).max() for k, v in grads.items()
               if k.rsplit('.', 1)[0] == module)


def test_velocity_train_step_matches_flax():
    """One train-mode ``run_on_batch`` (dropout off on both sides): the
    four losses with the masked velocity MSE in the total, the velocity
    stack's gradients, and the finalized velocity map."""

    jax_model, variables, model = _model_pair()
    data = _velocity_batch(np.random.RandomState(4))
    jax_batch = {k: jnp.asarray(v) for k, v in data.items()}

    def loss_fn(params):
        output, _ = jax_run_on_batch(
            jax_model, {'params': params,
                        'batch_stats': variables['batch_stats']},
            jax_batch, train=True, rngs={'dropout': jax.random.PRNGKey(1)})
        return output[jtools.KEY_LOSS][jtools.KEY_LOSS_TOTAL], output

    grads, ref = jax.jit(jax.grad(loss_fn, has_aux=True))(variables['params'])

    output = run_on_batch(model, {k: torch.from_numpy(v)
                                  for k, v in data.items()}, train=True)
    loss = output[tools.KEY_LOSS]
    loss[tools.KEY_LOSS_TOTAL].backward()

    ref_loss = ref[jtools.KEY_LOSS]
    assert sorted(loss) == sorted(ref_loss)
    assert tools.KEY_LOSS_VELOCITY in loss
    for key in ref_loss:
        np.testing.assert_allclose(loss[key].item(), float(ref_loss[key]),
                                   rtol=LOSS_RTOL, err_msg=key)

    ref_grads = {k: v.numpy() for k, v in from_flax({'params': grads}).items()}
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(ref_grads)
    for name, param in names.items():
        if name.startswith('velocity_'):
            diff = np.abs(param.grad.numpy() - ref_grads[name]).max()
            assert diff <= GRAD_TOL * _module_scale(ref_grads, name), name

    velocity = output[tools.KEY_VELOCITY]
    assert velocity.shape == (2, 88, 20)
    np.testing.assert_allclose(velocity.numpy(),
                               np.asarray(ref[jtools.KEY_VELOCITY]),
                               rtol=0, atol=1e-5)


def test_missing_velocity_warns_like_jax():
    jax_model, variables, model = _model_pair()
    data = _velocity_batch(np.random.RandomState(5))
    del data[jtools.KEY_VELOCITY]

    with pytest.warns(RuntimeWarning, match='no velocity ground truth'):
        jax_run_on_batch(jax_model, variables,
                         {k: jnp.asarray(v) for k, v in data.items()})
    with pytest.warns(RuntimeWarning, match='no velocity ground truth'):
        with torch.no_grad():
            output = run_on_batch(model, {k: torch.from_numpy(v)
                                          for k, v in data.items()})
    assert tools.KEY_LOSS_VELOCITY not in output[tools.KEY_LOSS]
    assert output[tools.KEY_VELOCITY].shape == (2, 88, 20)

    # Without ground truth at all there is no loss and no warning
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        with torch.no_grad():
            run_on_batch(model, {tools.KEY_FEATS: torch.from_numpy(
                data[tools.KEY_FEATS])})
