"""The O&F models in train mode against the JAX package's Flax models, on
the CPU in float32: train-mode BatchNorm, dropout, the logistic loss, and a
whole ``run_on_batch(train=True)`` of ``OnsetsFrames2`` with its gradients
and mutated batch statistics.

Tolerances:
- losses and BatchNorm outputs: ``rtol=1e-5`` (float32 sums in another
  order);
- gradients: within 1e-4 of the largest gradient of the same module (conv
  weight and bias together). A conv bias that feeds a train-mode BatchNorm
  has a true gradient of zero, so both frameworks return rounding noise
  there (about 1e-7 against 1e-2 for the kernel); held to its module's
  scale, the noise passes and a real error does not;
- batch statistics: ``atol=1e-6`` (means of values in [0, 1] and their
  variances, rounded in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import LogisticBank as JaxLogisticBank
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models.common import run_on_batch as jax_run_on_batch

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import LogisticBank, OnsetsFrames2, run_on_batch
from amt_tools_tpu_torch.ops.layers import BatchNorm, dropout
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)


@pytest.mark.parametrize('shape', [(4, 3, 7, 5), (2, 6, 9)])
def test_batchnorm_train_matches_flax(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    channels = shape[1]
    scale = rng.uniform(0.5, 2, channels).astype(np.float32)
    bias = rng.randn(channels).astype(np.float32)
    mean0 = rng.randn(channels).astype(np.float32)
    var0 = rng.uniform(0.5, 2, channels).astype(np.float32)

    # Flax normalizes the last axis: move channels there
    x_last = np.moveaxis(x, 1, -1)
    layer = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = {'params': {'scale': scale, 'bias': bias},
                 'batch_stats': {'mean': mean0, 'var': var0}}
    ref, mutated = layer.apply(variables, jnp.asarray(x_last),
                               mutable=['batch_stats'])

    norm = BatchNorm(channels)
    norm.load_state_dict({'weight': torch.from_numpy(scale),
                          'bias': torch.from_numpy(bias),
                          'running_mean': torch.from_numpy(mean0),
                          'running_var': torch.from_numpy(var0)})
    norm.train()
    got = norm(torch.from_numpy(x))

    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    stats = mutated['batch_stats']
    np.testing.assert_allclose(norm.running_mean.numpy(),
                               np.asarray(stats['mean']), atol=1e-6)
    np.testing.assert_allclose(norm.running_var.numpy(),
                               np.asarray(stats['var']), atol=1e-6)

    # Eval mode reads the running statistics and leaves them alone
    norm.eval()
    before = norm.running_var.clone()
    norm(torch.from_numpy(x))
    assert torch.equal(norm.running_var, before)


def test_dropout_keep_rate_scale_and_eval_identity():
    x = torch.ones(400, 500)
    g = torch.Generator().manual_seed(0)
    out = dropout(x, 0.25, g)

    kept = out != 0
    # 200,000 Bernoulli(0.75) draws: the keep rate within 5 sigma
    assert abs(kept.float().mean().item() - 0.75) < 5 * (0.75 * 0.25 / 2e5) ** 0.5
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))

    # The same generator state gives the same mask; another does not
    again = dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert not torch.equal(out, dropout(x, 0.25, g))

    with pytest.raises(ValueError):
        dropout(x, 0.5, None)

    # The model's dropouts are the identity in eval mode and with the flag
    # off, and draw from the generator in train mode
    model = OnsetsFrames2(dim_in=16, profile=tools.PianoProfile(),
                          model_complexity=2)
    feats = torch.rand(2, 6, 16, 1)
    am = model.pitch_am
    am.eval()
    assert torch.equal(am(feats), am(feats, torch.Generator().manual_seed(1)))
    am.train()
    am.dropout = False
    assert torch.equal(am(feats), am(feats))
    am.dropout = True
    first = am(feats, torch.Generator().manual_seed(1))
    assert torch.equal(first, am(feats, torch.Generator().manual_seed(1)))
    assert not torch.equal(first, am(feats, torch.Generator().manual_seed(2)))


@pytest.mark.parametrize('weighted', [False, True])
def test_logistic_loss_matches_jax(weighted):
    rng = np.random.RandomState(1)
    logits = (rng.randn(3, 11, 88) * 4).astype(np.float32)
    reference = (rng.rand(3, 88, 11) < 0.2).astype(np.float32)
    weights = rng.uniform(0.5, 2, 88).astype(np.float32) if weighted else None

    head = JaxLogisticBank(dim_in=4, dim_out=88, weights=weights)
    ref = head.get_loss(jnp.asarray(logits), jnp.asarray(reference))
    got = LogisticBank.get_loss(torch.from_numpy(logits),
                                torch.from_numpy(reference), weights)

    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)

    # bf16 logits: the loss still accumulates in float32
    got16 = LogisticBank.get_loss(torch.from_numpy(logits).bfloat16(),
                                  torch.from_numpy(reference), weights)
    assert got16.dtype == torch.float32


def _module_scale(grads, name):
    module = name.rsplit('.', 1)[0]
    return max(np.abs(v).max() for k, v in grads.items()
               if k.rsplit('.', 1)[0] == module)


@pytest.mark.parametrize('give_onsets', [False, True])
def test_onsets_frames2_train_step_matches_flax(give_onsets):
    """Losses, every gradient and the mutated batch statistics of one
    train-mode ``run_on_batch`` (dropout off on both sides: the two
    frameworks' noise cannot match). Without onset/offset targets in the
    batch both derive them from the multi-pitch reference."""

    rng = np.random.RandomState(2)
    batch, dim_in, frames = 2, 16, 20
    feats = rng.rand(batch, 1, dim_in, frames).astype(np.float32)
    multi_pitch = (rng.rand(batch, 88, frames) < 0.1).astype(np.float32)
    data = {jtools.KEY_FEATS: feats, jtools.KEY_MULTIPITCH: multi_pitch}
    if give_onsets:
        data[jtools.KEY_ONSETS] = (rng.rand(batch, 88, frames) < 0.05).astype(
            np.float32)
        data[jtools.KEY_OFFSETS] = (rng.rand(batch, 88, frames) < 0.05).astype(
            np.float32)

    jax_model = JaxOnsetsFrames2(dim_in=dim_in, profile=jtools.PianoProfile(),
                                 model_complexity=2, dropout=False)
    jax_batch = {k: jnp.asarray(v) for k, v in data.items()}
    variables = jax.jit(jax_model.init)(
        jax.random.PRNGKey(0), jax_model.pre_proc(jax_batch)[jtools.KEY_FEATS])

    def loss_fn(params):
        output, mutated = jax_run_on_batch(
            jax_model, {'params': params,
                        'batch_stats': variables['batch_stats']},
            jax_batch, train=True, rngs={'dropout': jax.random.PRNGKey(1)})
        loss = output[jtools.KEY_LOSS]
        return loss[jtools.KEY_LOSS_TOTAL], (loss, mutated)

    grads, (ref_loss, mutated) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables['params'])

    model = OnsetsFrames2(dim_in=dim_in, profile=tools.PianoProfile(),
                          model_complexity=2, dropout=False)
    assert model.detach_heads
    model.load_state_dict(from_flax(variables))
    output = run_on_batch(model, {k: torch.from_numpy(v)
                                  for k, v in data.items()}, train=True)
    assert model.training
    loss = output[tools.KEY_LOSS]
    loss[tools.KEY_LOSS_TOTAL].backward()

    assert sorted(loss) == sorted(ref_loss) == sorted(
        [tools.KEY_LOSS_TOTAL, tools.KEY_LOSS_PITCH, tools.KEY_LOSS_ONSETS,
         tools.KEY_LOSS_OFFSETS])
    for key in ref_loss:
        np.testing.assert_allclose(loss[key].item(), float(ref_loss[key]),
                                   rtol=1e-5, err_msg=key)

    ref_grads = {k: v.numpy() for k, v in from_flax({'params': grads}).items()}
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(ref_grads)
    for name, param in names.items():
        diff = np.abs(param.grad.numpy() - ref_grads[name]).max()
        assert diff <= 1e-4 * _module_scale(ref_grads, name), name

    ref_stats = from_flax({'batch_stats': mutated['batch_stats']})
    state = model.state_dict()
    for key, value in ref_stats.items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                   atol=1e-6, err_msg=key)

    # Finalized outputs still come back with the losses
    assert output[tools.KEY_MULTIPITCH].shape == (batch, 88, frames)

