"""``remat`` (``TranscriptionModel.remat``: ``True`` checkpoints each whole
acoustic stack, ``'blocks'`` each conv block) changes memory and never math,
as ``tests/test_models.py::test_remat_variants_are_bit_exact`` holds for
Flax: against ``remat=False`` with dropout ON, one optimizer step gives the
same loss, every gradient, the same BatchNorm running statistics and the
same parameters, bit for bit (tolerance: none).

Two hazards of ``torch.utils.checkpoint`` that a literal translation of
``jax.checkpoint`` would hit, each shown and then held here:
- the recomputed train-mode BatchNorm would update its running statistics
  a second time;
- checkpointing restores the default generators' state, not the explicit
  dropout generator's, so the recomputed masks would differ.
"""

import copy

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import OnsetsFrames2, run_on_batch
from amt_tools_tpu_torch.models.onsetsframes import AcousticModel
from amt_tools_tpu_torch.ops.layers import checkpoint, dropout

torch.set_num_threads(1)


def _batch(seed=0, batch=2, dim_in=16, frames=12):
    rng = np.random.RandomState(seed)
    multi_pitch = (rng.rand(batch, 88, frames) < 0.1).astype(np.float32)
    return {tools.KEY_FEATS: torch.from_numpy(
                rng.rand(batch, 1, dim_in, frames).astype(np.float32)),
            tools.KEY_MULTIPITCH: torch.from_numpy(multi_pitch),
            tools.KEY_VELOCITY: torch.from_numpy(
                (multi_pitch * rng.uniform(0.2, 1, multi_pitch.shape)).astype(
                    np.float32))}


def _one_step(remat, seed=0):
    model = OnsetsFrames2(dim_in=16, profile=tools.PianoProfile(),
                          model_complexity=2, estimate_velocity=True,
                          remat=remat,
                          generator=torch.Generator().manual_seed(7))
    optimizer = torch.optim.Adam(model.parameters(), lr=6e-4)
    generator = torch.Generator().manual_seed(11)
    output = run_on_batch(model, _batch(seed), train=True,
                          generator=generator)
    loss = output[tools.KEY_LOSS][tools.KEY_LOSS_TOTAL]
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    optimizer.step()
    return loss.detach(), grads, model.state_dict(), generator.get_state()


@pytest.mark.parametrize('remat', [True, 'blocks'])
def test_remat_is_bit_exact_with_dropout_on(remat):
    base_loss, base_grads, base_state, base_rng = _one_step(False)
    loss, grads, state, rng = _one_step(remat)

    assert loss.item() == base_loss.item()
    assert sorted(state) == sorted(base_state)  # the tree is unchanged
    for name, grad in base_grads.items():
        assert torch.equal(grads[name], grad), name
    for name, value in base_state.items():
        assert torch.equal(state[name], value), name
    # The dropout generator ends where it would without remat
    assert torch.equal(rng, base_rng)


@pytest.mark.parametrize('remat', [True, 'blocks'])
def test_running_statistics_update_once(remat):
    """One train forward and backward moves each running statistic once:
    0.9 * (initial) + 0.1 * (batch statistic), as without remat; a
    recomputation that updated them again would give 0.81 * initial +
    0.19 * ... ."""

    stack = AcousticModel(16, 32, model_complexity=2, remat=remat,
                          generator=torch.Generator().manual_seed(3))
    plain = copy.deepcopy(stack)
    plain.remat = False
    feats = torch.rand(2, 12, 16, 1)

    for module in (stack, plain):
        module.train()
        out = module(feats, torch.Generator().manual_seed(5))
        out.sum().backward()

    for name, value in plain.state_dict().items():
        if name.endswith(('running_mean', 'running_var')):
            assert torch.equal(stack.state_dict()[name], value), name
    # ... and they did move
    assert not torch.equal(stack.BatchNorm_0.running_var,
                           torch.ones_like(stack.BatchNorm_0.running_var))

    # The hazard: torch.utils.checkpoint alone updates them twice
    naive = copy.deepcopy(plain)
    naive.load_state_dict(AcousticModel(
        16, 32, model_complexity=2,
        generator=torch.Generator().manual_seed(3)).state_dict())
    naive.train()
    naive.dropout = False
    out = torch.utils.checkpoint.checkpoint(naive, feats, use_reentrant=False)
    out.sum().backward()
    once = copy.deepcopy(naive)
    once.load_state_dict(AcousticModel(
        16, 32, model_complexity=2,
        generator=torch.Generator().manual_seed(3)).state_dict())
    once(feats)
    assert not torch.equal(naive.BatchNorm_0.running_mean,
                           once.BatchNorm_0.running_mean)


def test_remat_runs_only_where_autograd_records():
    """In eval mode, or under no_grad, the stack is not checkpointed: the
    same outputs with and without remat, no recomputation."""

    stack = AcousticModel(16, 32, model_complexity=2, remat=True)
    plain = copy.deepcopy(stack)
    plain.remat = False
    feats = torch.rand(2, 12, 16, 1)
    stack.eval(), plain.eval()
    assert torch.equal(stack(feats), plain(feats))

    with pytest.raises(ValueError):
        OnsetsFrames2(dim_in=16, profile=tools.PianoProfile(),
                      model_complexity=2, remat='stack')


def _noisy(x, generator):
    return dropout(x * 2.0, 0.5, generator)


def test_plain_checkpoint_would_redraw_other_masks():
    """The hazard: ``torch.utils.checkpoint`` alone recomputes dropout
    from the explicit generator's advanced state, so the gradient uses
    other masks than the forward; ``ops.layers.checkpoint`` uses the same."""

    x = torch.rand(64, 64, requires_grad=True)

    def grad_of(run):
        x.grad = None
        g = torch.Generator().manual_seed(0)
        run(g).sum().backward()
        return x.grad.clone()

    want = grad_of(lambda g: _noisy(x, g))
    naive = grad_of(lambda g: torch.utils.checkpoint.checkpoint(
        _noisy, x, g, use_reentrant=False))
    ours = grad_of(lambda g: checkpoint(lambda y: _noisy(y, g), x,
                                        generator=g))

    assert not torch.equal(naive, want)
    assert torch.equal(ours, want)
