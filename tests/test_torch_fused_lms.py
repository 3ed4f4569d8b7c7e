"""The grouped language-model layout (``fused_lms``) against the JAX
package's fused models, on the CPU.

Mirrors ``tests/test_fused_lms.py``: O&F2 with ``fused_lms`` (one
``GroupedBiLSTM`` for the onset, offset and, with the velocity head,
velocity language models: one grouped launch of kernel B in eval, E and F
in training, through their plain versions here) against JAX's fused model
on the same variables through ``weights.from_flax``; three SGD steps of
the fully fused O&F2 (``fused_heads`` and ``fused_lms``) against JAX's
fused train step, as ``tests/test_torch_train.py`` does for the per-head
layout. Tolerances: logits within 1e-5; after three SGD steps the
parameters and statistics within ``atol=1e-5, rtol=1e-4`` and each step's
loss within ``rtol=1e-5`` (float32 gradients in another order, three
times); the converters bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models import fuse_lm_variables as jax_fuse_lm
from amt_tools_tpu.train import init_state
from amt_tools_tpu.train import make_train_step as jax_make_train_step

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import (OnsetsFrames, OnsetsFrames2,
                                        OnsetsFramesOnline, fuse_lm_variables,
                                        unfuse_lm_variables)
from amt_tools_tpu_torch.ops import lstm_kernel
from amt_tools_tpu_torch.train import make_train_step
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

DIM_IN = 48


def _jax_model(**kw):
    return JaxOnsetsFrames2(dim_in=DIM_IN, profile=jtools.PianoProfile(),
                            model_complexity=2, **kw)


def _model(**kw):
    return OnsetsFrames2(DIM_IN, tools.PianoProfile(), model_complexity=2,
                         **kw)


@pytest.mark.parametrize('velocity', [False, True])
@pytest.mark.parametrize('use_lengths', [False, True])
def test_fused_lms_match_jax(velocity, use_lengths):
    rng = np.random.RandomState(0)
    feats = rng.rand(2, 9, DIM_IN, 1).astype(np.float32)
    lengths = np.array([9, 5]) if use_lengths else None

    jax_ref = _jax_model(estimate_velocity=velocity)
    rngs = {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)}
    v_ref = jax_ref.init(rngs, jnp.asarray(feats), train=False)
    v_fused = jax_fuse_lm(v_ref, jax_ref._fused_lm_streams)
    want = _jax_model(estimate_velocity=velocity, fused_lms=True).apply(
        v_fused, jnp.asarray(feats), train=False,
        lengths=None if lengths is None else jnp.asarray(lengths))

    model = _model(estimate_velocity=velocity, fused_lms=True).eval()
    assert model._fused_lm_streams == jax_ref._fused_lm_streams
    model.load_state_dict(from_flax(v_fused))
    launches = lstm_kernel.lstm_scan.grouped_launches
    with torch.no_grad():
        got = model(torch.from_numpy(feats), lengths=None if lengths is None
                    else torch.from_numpy(lengths))
    # the CPU's plain version counts no launch
    assert lstm_kernel.lstm_scan.grouped_launches == launches

    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)

    # The converters: from_flax of JAX's fused tree is the port's converter
    # on from_flax of the per-head tree, and the round trip is exact
    per_head = from_flax(v_ref)
    fused = fuse_lm_variables(per_head, model._fused_lm_streams)
    want_state = from_flax(v_fused)
    assert sorted(fused) == sorted(want_state)
    for key in want_state:
        assert torch.equal(fused[key], want_state[key]), key
    back = unfuse_lm_variables(fused, model._fused_lm_streams)
    assert sorted(back) == sorted(per_head)
    for key in per_head:
        assert torch.equal(back[key], per_head[key]), key


def _batch(seed, frames=12):
    rng = np.random.RandomState(seed)
    return {
        tools.KEY_FEATS: rng.rand(2, 1, DIM_IN, frames).astype(np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(2, 88, frames) < 0.1).astype(
            np.float32),
    }


def test_three_sgd_steps_of_the_fused_model_match_jax():
    """Grouped E and F (plain versions) and the grouped acoustic stack in
    train mode, three SGD steps against JAX's fused train step."""

    batches = [_batch(s) for s in range(3)]
    lr = 0.05
    kw = dict(fused_heads=True, fused_lms=True, dropout=False)

    jax_model = _jax_model(**kw)
    optimizer = optax.sgd(lr)
    state = init_state(jax_model, optimizer, jtools.dict_to_jax(batches[0]),
                       rng=jax.random.PRNGKey(0))
    model = _model(**kw)
    model.load_state_dict(from_flax(state.variables()))

    jax_step = jax_make_train_step(jax_model, optimizer, donate=False)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=lr))
    for batch in batches:
        state, ref_loss = jax_step(state, jtools.dict_to_jax(batch))
        loss = step({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(loss[tools.KEY_LOSS_TOTAL].item(),
                                   float(ref_loss[jtools.KEY_LOSS_TOTAL]),
                                   rtol=1e-5)

    ref = from_flax(state.variables())
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=key)


def test_converters_validate_stream_arity():
    model = _model(estimate_velocity=True)
    state = model.state_dict()

    # 3 LM subtrees present, but only 2 streams named
    with pytest.raises(ValueError, match='velocity'):
        fuse_lm_variables(state, ('onset', 'offset'))
    # a stream named that the variables lack
    with pytest.raises(ValueError, match='not'):
        fuse_lm_variables(_model().state_dict(),
                          ('onset', 'offset', 'velocity'))

    fused = fuse_lm_variables(state, model._fused_lm_streams)
    # a 3-stream group, but the default 2-stream order requested
    with pytest.raises(ValueError, match='streams'):
        unfuse_lm_variables(fused, ('onset', 'offset'))


def test_fused_lms_refusals():
    profile = tools.PianoProfile()
    with pytest.raises(ValueError, match='fused_lms'):
        OnsetsFrames(DIM_IN, profile, model_complexity=2, fused_lms=True)
    with pytest.raises(ValueError, match='online'):
        OnsetsFramesOnline(DIM_IN, profile, model_complexity=2,
                           fused_lms=True)
    with pytest.raises(ValueError, match='quant_lm'):
        _model(fused_lms=True, quant_lm=True)
    # the online model takes the fused acoustic stack
    OnsetsFramesOnline(DIM_IN, profile, model_complexity=2, fused_heads=True)
