"""Context and tensor parallelism of the port against the JAX package, on
the CPU.

The port runs one gloo group of 4 spawned ranks (``tests/torch_ranks.py``).
Context parallelism: a track's frames are sharded over the 4 ranks and
each rank's windows, joined in rank order, equal ``framify`` of the whole
track bit for bit (zero track edges, ``win_length`` 1 and the errors
included; the gradient through the halo exchange equals the unsharded
one within ``atol=rtol=1e-6``, a sum of 9 window terms in another order);
TabCNN on the time-sharded windows equals JAX's
unsharded logits within ``atol=rtol=2e-5``. Tensor parallelism: on a
2 (data) x 2 (model) mesh the wide kernels are sharded column-wise and an
SGD step of O&F (V1) equals JAX's single-device step (dropout off; loss
``rtol=2e-5``, parameters ``rtol=1e-4, atol=1e-6``, the tolerances of
``tests/test_tensor_parallel.py``) and the port's one-process step with
BatchNorm and dropout on (loss ``rtol=1e-5``, parameters and statistics
``atol=rtol=1e-5``). The fused O&F2 (``fused_heads``, ``fused_lms``)
shards its grouped ``head_kernels`` and stacked recurrent kernels on their
last axis, as JAX's left-padded rules do, and its sharded step equals
JAX's single-device fused step within the same tolerances. Mirrors
``tests/test_context_parallel.py`` and ``tests/test_tensor_parallel.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames as JaxOnsetsFrames
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models import TabCNN as JaxTabCNN
from amt_tools_tpu.train import init_state
from amt_tools_tpu.train import make_train_step as jax_make_train_step

import torch_ranks
from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.ops import frames as frame_ops
from amt_tools_tpu_torch.train import make_train_step, step_generator
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

WORLD = 4
LR = 1e-2
SEED = 2
OF1 = {'dim_in': 48, 'model_complexity': 2}


def _tp_batch():
    rng = np.random.RandomState(0)
    return {
        tools.KEY_FEATS: rng.rand(4, 1, 48, 8).astype(np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(4, 88, 8) > 0.9).astype(np.float32),
    }


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    feats = rng.rand(2, 1, 16, 64).astype(np.float32)
    window_weights = rng.randn(2, 1, 16, 64, 9).astype(np.float32)
    track = np.random.RandomState(1).rand(1, 1, 48, 128).astype(np.float32)

    jax_tab = JaxTabCNN(dim_in=48, profile=jtools.GuitarProfile(),
                        model_complexity=1)
    pre = jax_tab.pre_proc({jtools.KEY_FEATS: jnp.asarray(track)})
    tab_vars = jax_tab.init({'params': jax.random.PRNGKey(0),
                             'dropout': jax.random.PRNGKey(1)},
                            pre[jtools.KEY_FEATS], train=False)

    batch = _tp_batch()
    jax_of1 = JaxOnsetsFrames(profile=jtools.PianoProfile(), dropout=False,
                              **OF1)
    optimizer = optax.sgd(LR)
    state = init_state(jax_of1, optimizer, jtools.dict_to_jax(batch),
                       rng=jax.random.PRNGKey(0))
    of1_state = from_flax(state.variables())
    tp = {name: {'spec': ('of1', dict(OF1, dropout=dropout)),
                 'state': of1_state, 'batch': batch}
          for name, dropout in (('tp_jax', False), ('tp_dropout', True))}
    fused_kw = dict(OF1, dropout=False, fused_heads=True, fused_lms=True)
    jax_fused = JaxOnsetsFrames2(profile=jtools.PianoProfile(), **fused_kw)
    fused_state = init_state(jax_fused, optimizer, jtools.dict_to_jax(batch),
                             rng=jax.random.PRNGKey(0))
    tp['tp_fused'] = {'spec': ('of2', fused_kw),
                      'state': from_flax(fused_state.variables()),
                      'batch': batch}

    inputs = {'feats': feats, 'window_weights': window_weights,
              'track': track, 'tabcnn': from_flax(tab_vars), 'tp': tp,
              'lr': LR, 'seed': SEED}
    ranks = torch_ranks.Ranks('cp_tp_checks', WORLD,
                              tmp_path_factory.mktemp('cp_tp'), inputs)

    # The references while the ranks run
    jax_logits = np.asarray(jax_tab.apply(tab_vars, pre[jtools.KEY_FEATS],
                                          train=False)[jtools.KEY_TABLATURE])
    step = jax_make_train_step(jax_of1, optimizer, donate=False)
    new_state, jax_loss = step(state, jtools.dict_to_jax(batch))
    jax_after = {k: v.numpy() for k, v in from_flax(
        jax.device_get(new_state.variables())).items()}
    fused_step = jax_make_train_step(jax_fused, optimizer, donate=False)
    fused_state, fused_loss = fused_step(fused_state,
                                         jtools.dict_to_jax(batch))
    fused_after = {k: v.numpy() for k, v in from_flax(
        jax.device_get(fused_state.variables())).items()}

    single = {}
    for name, case in tp.items():
        model = torch_ranks._model(case['spec'])
        model.load_state_dict(case['state'])
        loss = make_train_step(
            model, torch.optim.SGD(model.parameters(), lr=LR))(
                {k: torch.from_numpy(v) for k, v in batch.items()},
                step_generator(SEED, 0, 'cpu'))
        single[name] = torch_ranks._step_result(model, loss)

    references = {'jax_logits': jax_logits,
                  'jax_step': (float(jax_loss[jtools.KEY_LOSS_TOTAL]),
                               jax_after),
                  'jax_fused_step': (float(fused_loss[jtools.KEY_LOSS_TOTAL]),
                                     fused_after),
                  'single': single}

    return ranks.results(), references, inputs


def _joined(ranks, key):
    """The ranks' time blocks (axis -2 of windows) joined in rank order."""

    return np.concatenate([r[key] for r in ranks], axis=-2)


def test_framify_matches_unsharded(runs):
    ranks, _, inputs = runs
    want = frame_ops.framify(torch.from_numpy(inputs['feats']), 9,
                             pad=True).numpy()

    np.testing.assert_array_equal(_joined(ranks, 'windows'), want)


def test_framify_edge_zeros(runs):
    """Track-edge windows see zeros, exactly like the unsharded zero pad."""

    ranks, _, _ = runs
    windows = _joined(ranks, 'edges')

    np.testing.assert_array_equal(windows[0, 0, 0, 0],
                                  [0, 0, 0, 0, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(windows[0, 0, 0, -1],
                                  [1, 1, 1, 1, 1, 0, 0, 0, 0])
    # Interior block edges take their neighbours' frames, not zeros
    np.testing.assert_array_equal(windows[0, 0, 0, 16], np.ones(9))


def test_validation_errors(runs):
    ranks, _, _ = runs

    for result in ranks:
        assert 'divisible' in result['indivisible']
        assert 'halo' in result['halo']


def test_framify_win_length_one(runs):
    """halo == 0: single-frame windows, no neighbour exchange."""

    ranks, _, inputs = runs
    want = frame_ops.framify(torch.from_numpy(inputs['feats']), 1,
                             pad=True).numpy()

    np.testing.assert_array_equal(_joined(ranks, 'windows_1'), want)


def test_framify_gradient_through_the_halos(runs):
    ranks, _, inputs = runs
    feats = torch.from_numpy(inputs['feats']).requires_grad_(True)
    windows = frame_ops.framify(feats, 9, pad=True)
    (windows * torch.from_numpy(inputs['window_weights'])).sum().backward()

    got = np.concatenate([r['window_grad'] for r in ranks], axis=-1)
    np.testing.assert_allclose(got, feats.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_tabcnn_whole_track_time_sharded(runs):
    """TabCNN logits over a time-sharded track == JAX's unsharded logits."""

    ranks, references, _ = runs
    got = np.concatenate([r['tabcnn'] for r in ranks], axis=1)

    np.testing.assert_allclose(got, references['jax_logits'], atol=2e-5,
                               rtol=2e-5)


def test_tp_param_placement(runs):
    ranks, _, inputs = runs
    full = {k: tuple(v.shape) for k, v in inputs['tp']['tp_jax'][
        'state'].items()}

    for result in ranks:
        sharded = result['tp_jax']['sharded']
        # Every wide kernel family is sharded across the model axis
        assert any('input_proj_fwd.weight' in name for name in sharded)
        assert any('recurrent_kernel_bwd' in name for name in sharded)
        assert any(name.endswith('am.Dense_0.weight') for name in sharded)
        assert any(name.endswith('_out.Dense_0.weight') for name in sharded)
        for name in sharded:
            local, whole = result['tp_jax']['local'][name], full[name]
            dim = 1 if 'recurrent_kernel' in name else 0
            assert local[dim] * 2 == whole[dim], name
        # The convolutions and batch norms stay whole
        for name in full:
            if 'Conv_' in name or 'BatchNorm' in name:
                assert result['tp_jax']['local'][name] == full[name], name


def test_dp_tp_step_matches_single_device(runs):
    """A (2 data x 2 model) sharded SGD step equals JAX's unsharded one."""

    ranks, references, _ = runs
    jax_loss, jax_after = references['jax_step']

    for result in ranks:
        got = result['tp_jax']
        np.testing.assert_allclose(got['loss'][tools.KEY_LOSS_TOTAL],
                                   jax_loss, rtol=2e-5)
        assert sorted(got['state']) == sorted(jax_after)
        for key, want in jax_after.items():
            np.testing.assert_allclose(got['state'][key], want, rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def test_dp_tp_step_with_dropout_matches_one_process(runs):
    ranks, references, _ = runs
    want = references['single']['tp_dropout']

    for result in ranks:
        got = result['tp_dropout']
        np.testing.assert_allclose(got['loss'][tools.KEY_LOSS_TOTAL],
                                   want['loss'][tools.KEY_LOSS_TOTAL],
                                   rtol=1e-5)
        for key, value in want['state'].items():
            np.testing.assert_allclose(got['state'][key], value, rtol=1e-5,
                                       atol=1e-5, err_msg=key)


def test_tp_fused_layouts_match_the_jax_step(runs):
    """The fused O&F2's grouped head kernels (H, K, D) and stacked
    recurrent kernels (S, H, 4H) shard their last axis; the (2 data x 2
    model) step equals JAX's single-device fused step."""

    ranks, references, inputs = runs
    jax_loss, jax_after = references['jax_fused_step']
    full = {k: tuple(v.shape) for k, v in inputs['tp']['tp_fused'][
        'state'].items()}

    for result in ranks:
        got = result['tp_fused']
        for name in ('grouped_am.head_kernels',
                     'group_lm.recurrent_kernel_fwd',
                     'group_lm.recurrent_kernel_bwd'):
            assert name in got['sharded']
            assert got['local'][name][-1] * 2 == full[name][-1], name
        assert 'group_lm.input_proj_fwd_kernel' not in got['sharded']
        np.testing.assert_allclose(got['loss'][tools.KEY_LOSS_TOTAL],
                                   jax_loss, rtol=2e-5)
        assert sorted(got['state']) == sorted(jax_after)
        for key, want in jax_after.items():
            np.testing.assert_allclose(got['state'][key], want, rtol=1e-4,
                                       atol=1e-6, err_msg=key)
