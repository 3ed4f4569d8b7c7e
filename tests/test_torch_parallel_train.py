"""Data-parallel training of the port against its one-process step and the
JAX package's mesh step, on the CPU.

The port runs one gloo group of 4 spawned ranks (``tests/torch_ranks.py``)
with a 4-rank mesh and a 2-rank one (ranks 0 and 1). Every case starts
from the same Flax variables (``weights.from_flax``) and one global batch
of 8. With BatchNorm and dropout on, a 2- and a 4-rank SGD step of O&F2
and of TabCNN must equal the one-process step on the global batch: the
BatchNorm statistics are the global batch's, and each rank keeps its rows
of the global dropout masks. A missing global statistic, a repeated mask
or a gradient mean off by the world size shows at once. With dropout off
(JAX's random bits are not the port's) the 4-rank step equals JAX's
8-device mesh step. Mirrors ``tests/test_train.py``'s data-parallel step
and loop; also ``accum_steps=2`` with a mesh against without, and a
resumed data-parallel ``train()``.

Tolerances (float32 sums in another order): losses ``rtol=1e-5``;
gradients within 1e-5 of the largest gradient of the same top-level module
(``pitch_am``, ``onset_lm``, ``conv1``, ...: a conv bias ahead of a
train-mode BatchNorm has a gradient of pure rounding noise, as in
``chip_smoke.py``'s card-against-CPU step); parameters and BatchNorm
statistics ``atol=1e-5`` (``rtol=1e-5``).
"""

import numpy as np
import pytest
import torch

import jax
import optax

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models import TabCNN as JaxTabCNN
from amt_tools_tpu.parallel import get_mesh as jax_get_mesh
from amt_tools_tpu.parallel import replicate as jax_replicate
from amt_tools_tpu.parallel import shard_batch as jax_shard_batch
from amt_tools_tpu.train import TrainState, init_state
from amt_tools_tpu.train import make_train_step as jax_make_train_step

import torch_ranks
from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.train import make_train_step, step_generator, train
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

LR = 0.05
SEED = 5
OF2 = {'dim_in': 16, 'model_complexity': 2}
TAB = {'dim_in': 24, 'model_complexity': 1}


def _of2_batch(seed):
    rng = np.random.RandomState(seed)
    return {
        tools.KEY_FEATS: rng.rand(8, 1, 16, 12).astype(np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(8, 88, 12) < 0.1).astype(np.float32),
    }


def _tab_batch(seed):
    rng = np.random.RandomState(seed)
    return {
        tools.KEY_FEATS: rng.rand(8, 1, 24, 8).astype(np.float32),
        tools.KEY_TABLATURE: rng.randint(-1, 20, (8, 6, 8)).astype(
            np.float32),
    }


def _jax_init(model, batch):
    return init_state(model, optax.sgd(LR), jtools.dict_to_jax(batch),
                      rng=jax.random.PRNGKey(0))


def _jax_mesh_step(model, state, batch):
    """JAX's 8-device data-parallel SGD step: (loss, variables after)."""

    optimizer = optax.sgd(LR)
    mesh = jax_get_mesh()
    sharded = TrainState(step=state.step,
                         params=jax_replicate(state.params, mesh),
                         batch_stats=jax_replicate(state.batch_stats, mesh),
                         opt_state=jax_replicate(state.opt_state, mesh),
                         rng=state.rng)
    step = jax_make_train_step(model, optimizer, mesh=mesh, donate=False)
    new_state, loss = step(sharded, jax_shard_batch(batch, mesh))

    return (float(loss[jtools.KEY_LOSS_TOTAL]),
            {k: v.numpy() for k, v in
             from_flax(jax.device_get(new_state.variables())).items()})


def _one_process_step(spec, state, batch):
    model = torch_ranks._model(spec)
    model.load_state_dict(state)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = step({k: torch.from_numpy(v) for k, v in batch.items()},
                step_generator(SEED, 0, 'cpu'))

    return torch_ranks._step_result(model, loss)


def _one_process_train(spec, state, batches, iterations, accum_steps=1):
    model = torch_ranks._model(spec)
    model.load_state_dict(state)
    result = train(model, torch_ranks.Loader(batches),
                   torch.optim.SGD(model.parameters(), lr=LR), iterations,
                   log_dir=None, seed=3, device='cpu',
                   accum_steps=accum_steps)

    return {'result': result,
            'state': torch_ranks._numpy(model.state_dict())}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    jax_of2 = JaxOnsetsFrames2(profile=jtools.PianoProfile(), dropout=False,
                               **OF2)
    jax_tab = JaxTabCNN(profile=jtools.GuitarProfile(), dropout=False, **TAB)
    of2_init = _jax_init(jax_of2, _of2_batch(0))
    tab_init = _jax_init(jax_tab, _tab_batch(0))
    of2_state = from_flax(of2_init.variables())
    tab_state = from_flax(tab_init.variables())

    steps = {}
    for kind, state, batch, kwargs in (('of2', of2_state, _of2_batch(0), OF2),
                                       ('tabcnn', tab_state, _tab_batch(0),
                                        TAB)):
        for dropout in (True, False):
            for world in ((2, 4) if dropout else (4,)):
                steps[(kind, dropout, world)] = {
                    'spec': (kind, dict(kwargs, dropout=dropout)),
                    'state': state, 'batch': batch, 'world': world}

    loop_spec = ('of2', dict(OF2, dropout=True))
    loop_batches = [_of2_batch(1), _of2_batch(2)]
    inputs = {'lr': LR, 'seed': SEED, 'steps': steps,
              'loop': {'spec': loop_spec, 'state': of2_state,
                       'batches': loop_batches,
                       'log_dir': str(tmp_path_factory.mktemp('dp_loop'))}}
    ranks = torch_ranks.Ranks('train_checks', 4,
                              tmp_path_factory.mktemp('train'), inputs)

    # JAX's mesh steps and the one-process references while the ranks run
    of2_jax_loss, of2_jax_after = _jax_mesh_step(jax_of2, of2_init,
                                                 _of2_batch(0))
    tab_jax_loss, tab_jax_after = _jax_mesh_step(jax_tab, tab_init,
                                                 _tab_batch(0))
    single = {name: _one_process_step(case['spec'], case['state'],
                                      case['batch'])
              for name, case in steps.items()}
    single['loop'] = _one_process_train(loop_spec, of2_state, loop_batches, 3)
    single['accum'] = _one_process_train(loop_spec, of2_state,
                                         loop_batches[:1], 1, accum_steps=2)
    jax_ref = {'of2': (of2_jax_loss, of2_jax_after),
               'tabcnn': (tab_jax_loss, tab_jax_after)}

    return ranks.results(), single, jax_ref


def _assert_state(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def _assert_step(got, want):
    np.testing.assert_allclose(got['loss'][tools.KEY_LOSS_TOTAL],
                               want['loss'][tools.KEY_LOSS_TOTAL], rtol=1e-5)
    scales = {}
    for key, ref in want['grads'].items():
        module = key.split('.')[0]
        scales[module] = max(scales.get(module, 0.0), np.abs(ref).max())
    for key, ref in want['grads'].items():
        np.testing.assert_allclose(got['grads'][key], ref, rtol=0,
                                   atol=1e-5 * scales[key.split('.')[0]],
                                   err_msg=key)
    _assert_state(got['state'], want['state'])


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('kind', ['of2', 'tabcnn'])
def test_dp_step_with_dropout_matches_one_process(runs, kind, world):
    ranks, single, _ = runs
    name = (kind, True, world)

    for rank in range(world):
        _assert_step(ranks[rank][name], single[name])
    # Every rank holds the same parameters and statistics afterwards
    for rank in range(1, world):
        for key, value in ranks[0][name]['state'].items():
            np.testing.assert_array_equal(ranks[rank][name]['state'][key],
                                          value)


@pytest.mark.parametrize('kind', ['of2', 'tabcnn'])
def test_dp_step_matches_jax_mesh_step(runs, kind):
    """Dropout off: the 4-rank step against JAX's 8-device mesh step."""

    ranks, single, jax_ref = runs
    name = (kind, False, 4)
    jax_loss, jax_after = jax_ref[kind]

    for rank in range(4):
        got = ranks[rank][name]
        np.testing.assert_allclose(got['loss'][tools.KEY_LOSS_TOTAL],
                                   jax_loss, rtol=1e-5)
        _assert_state(got['state'], jax_after)
        _assert_step(got, single[name])


def test_dp_batch_norm_statistics_are_global(runs):
    """The running statistics after a 4-rank step are the global batch's:
    a rank's own batch statistics would move them elsewhere."""

    ranks, single, _ = runs
    name = ('of2', True, 4)
    keys = [k for k in single[name]['state'] if k.endswith('running_var')]
    assert keys
    for key in keys:
        np.testing.assert_allclose(ranks[3][name]['state'][key],
                                   single[name]['state'][key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_train_loop_data_parallel_and_resume(runs):
    """train(mesh) for 2 iterations (rank 0 writes the checkpoint), then a
    resume to 3 from other weights on every rank: the losses and the final
    weights of one-process train() for 3 iterations."""

    ranks, single, _ = runs
    want = single['loop']
    losses = want['result']['losses'][tools.KEY_LOSS_TOTAL]
    assert len(losses) == 6

    for result in ranks:
        first, second = result['loop']['runs']
        assert first['step'] == 4 and second['step'] == 6
        got = (first['losses'][tools.KEY_LOSS_TOTAL] +
               second['losses'][tools.KEY_LOSS_TOTAL])
        np.testing.assert_allclose(got, losses, rtol=1e-5)
        _assert_state(result['loop']['state'], want['state'])


def test_accumulation_with_a_mesh_equals_without(runs):
    ranks, single, _ = runs
    want = single['accum']

    for result in ranks:
        got = result['accum']
        assert got['result']['step'] == 1
        for key, values in want['result']['losses'].items():
            np.testing.assert_allclose(got['result']['losses'][key], values,
                                       rtol=1e-5, err_msg=key)
        _assert_state(got['state'], want['state'])
