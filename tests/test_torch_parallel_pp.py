"""Pipeline parallelism of the port (the GPipe schedule and the O&F
flagship stages) against sequential execution and the JAX package's
sequential models, on the CPU.

The port runs one gloo group of 8 spawned ranks (``tests/torch_ranks.py``):
1-D ``pipe`` meshes over ranks 0-2, 0-3 and 0-4 (3, 4 and 5 stages) and a
4 (pipe) x 2 (data) mesh over all 8. Mirrors
``tests/test_pipeline_parallel.py`` (a residual dense stage: outputs and
gradients within ``atol=1e-5``, ``rtol=1e-5`` and ``1e-4``, dp x pp, a
stage-count mismatch) and ``tests/test_pipeline_flagship.py`` (O&F V2 on 4
stages, with a data axis, V1 on 3, V2 with velocity on 5: logits within
``rtol=atol=2e-5`` of JAX's sequential ``model.apply`` and of the port's
own sequential forward on the same Flax variables; d loss / d features
within ``rtol=5e-4, atol=5e-5`` of both, through the ``detach_heads``
stop-gradients). Also the port's own: each stage's parameter gradients
equal the sequential model's (``rtol=1e-4``, ``atol`` 1e-5 of the
tensor's largest), and every pipe rank gets the whole input gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames as JaxOnsetsFrames
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2

import torch_ranks
from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

FLAGSHIP = {'dim_in': 16, 'in_channels': 1, 'model_complexity': 2}
GRAD_KEYS = (tools.KEY_ONSETS, tools.KEY_MULTIPITCH)


def _make_stages(num_stages, width, rng):
    return [{'w': (rng.randn(width, width) * 0.3).astype(np.float32),
             'b': (rng.randn(width) * 0.1).astype(np.float32)}
            for _ in range(num_stages)]


def _sequential(stages, x):
    for params in torch_ranks._stages(stages):
        x = torch_ranks.residual_stage(params, x)
    return x


def _flagship(kind, **kwargs):
    """A JAX model and its Flax variables from a seed (they do not depend
    on the batch or the frames)."""

    cls = JaxOnsetsFrames2 if kind == 'of2' else JaxOnsetsFrames
    model = cls(profile=jtools.PianoProfile(), **FLAGSHIP, **kwargs)
    feats = jnp.zeros((1, 12, FLAGSHIP['dim_in'], 1))
    variables = jax.jit(lambda key, x: model.init(key, x, False, None))(
        jax.random.PRNGKey(1), feats)

    return model, variables


def _feats(batch, frames=12):
    return np.array(jax.random.normal(jax.random.PRNGKey(0),
                                      (batch, frames, FLAGSHIP['dim_in'], 1)))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    forward = {'stages': _make_stages(4, 16, rng),
               'x': rng.randn(6, 2, 16).astype(np.float32)}
    rng = np.random.RandomState(1)
    gradients = {'stages': _make_stages(4, 8, rng),
                 'x': rng.randn(5, 2, 8).astype(np.float32),
                 'target': rng.randn(5, 2, 8).astype(np.float32)}
    rng = np.random.RandomState(2)
    dp_pp = {'stages': _make_stages(4, 16, rng),
             'x': rng.randn(6, 4, 16).astype(np.float32)}

    models = {'of2': _flagship('of2'), 'of1': _flagship('of1'),
              'velocity': _flagship('of2', estimate_velocity=True)}
    # name: (model, features, stages, microbatches, data axis, gradients)
    cases = {'v2': ('of2', _feats(8), 4, 4, False, False),
             'v2_dp': ('of2', _feats(8), 4, 4, True, False),
             'v1': ('of1', _feats(6), 3, 3, False, False),
             'velocity': ('velocity', _feats(5), 5, 5, False, False),
             'grad': ('of2', _feats(4, frames=8), 4, 4, False, True)}
    flagship, jax_models = {}, {}
    for name, (key, feats, stages, micro, dp, grad) in cases.items():
        model, variables = models[key]
        extra = {'estimate_velocity': True} if key == 'velocity' else {}
        jax_models[name] = (model, variables, feats)
        flagship[name] = {'spec': ('of1' if key == 'of1' else 'of2',
                                   dict(FLAGSHIP, **extra)),
                          'state': from_flax(variables), 'feats': feats,
                          'stages': stages, 'num_micro': micro, 'dp': dp,
                          'grad': grad, 'keys': GRAD_KEYS}

    inputs = {'forward': forward, 'gradients': gradients, 'dp_pp': dp_pp,
              'flagship': flagship}
    ranks = torch_ranks.Ranks('pp_checks', 8, tmp_path_factory.mktemp('pp'),
                              inputs)

    # The sequential references while the ranks run
    references = {}
    for name, (model, variables, feats) in jax_models.items():
        apply = jax.jit(lambda v, f, model=model: model.apply(v, f, False,
                                                              None))
        ref = {'jax': {k: np.asarray(v) for k, v in apply(
            variables, jnp.asarray(feats)).items()}}
        port = torch_ranks._model(flagship[name]['spec']).eval()
        port.load_state_dict(flagship[name]['state'])
        x = torch.from_numpy(feats).requires_grad_(flagship[name]['grad'])
        logits = port(x)
        ref['port'] = torch_ranks._numpy(logits)
        if flagship[name]['grad']:
            def loss_fn(f, model=model, variables=variables):
                out = model.apply(variables, f, False, None)
                return sum(jnp.sum(out[k] ** 2) for k in GRAD_KEYS)
            ref['jax_grad'] = np.asarray(jax.jit(jax.grad(loss_fn))(
                jnp.asarray(feats)))
            sum(torch.sum(logits[k] ** 2) for k in GRAD_KEYS).backward()
            ref['port_grad'] = x.grad.numpy()
            ref['param_grads'] = {k: p.grad.numpy() for k, p in
                                  port.named_parameters() if p.grad is not None}
        references[name] = ref

    return ranks.results(timeout=180.0), references, inputs


def test_pipeline_matches_sequential(runs):
    ranks, _, inputs = runs
    case = inputs['forward']
    want = _sequential(case['stages'], torch.from_numpy(case['x'])).numpy()

    # Outputs on every pipe rank
    for result in ranks[:4]:
        np.testing.assert_allclose(result['forward'], want, atol=1e-5,
                                   rtol=1e-5)


def test_pipeline_gradients_match_sequential(runs):
    ranks, _, inputs = runs
    case = inputs['gradients']
    stages = torch_ranks._stages(case['stages'])
    for params in stages:
        for value in params.values():
            value.requires_grad_(True)
    x = torch.from_numpy(case['x']).requires_grad_(True)
    y = x
    for params in stages:
        y = torch_ranks.residual_stage(params, y)
    torch.mean((y - torch.from_numpy(case['target'])) ** 2).backward()

    for stage, result in enumerate(ranks[:4]):
        got = result['gradients']
        for key in ('w', 'b'):
            np.testing.assert_allclose(got['params'][key],
                                       stages[stage][key].grad.numpy(),
                                       atol=1e-5, rtol=1e-4)
        # Every pipe rank holds the whole input gradient
        np.testing.assert_allclose(got['x'], x.grad.numpy(), atol=1e-5,
                                   rtol=1e-4)


def test_pipeline_composes_with_data_parallelism(runs):
    """dp x pp: microbatch rows shard over 'data' while stages pipeline."""

    ranks, _, inputs = runs
    case = inputs['dp_pp']
    want = _sequential(case['stages'], torch.from_numpy(case['x'])).numpy()

    # Rank r sits at (pipe r // 2, data r % 2) and holds its replica's rows
    for rank, result in enumerate(ranks):
        data = rank % 2
        np.testing.assert_allclose(result['dp_pp'],
                                   want[:, 2 * data:2 * data + 2],
                                   atol=1e-5, rtol=1e-5)


def test_stage_count_mismatch_raises(runs):
    ranks, _, _ = runs

    for result in ranks[:4]:
        assert result['mismatch'].startswith('ValueError')
        assert 'one stage per device' in result['mismatch']


def _assert_logits(got, ref):
    for want in (ref['jax'], ref['port']):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-5,
                                       atol=2e-5, err_msg=key)


@pytest.mark.parametrize('name,stages', [('v2', 4), ('v1', 3),
                                         ('velocity', 5)])
def test_flagship_pipeline_exact(runs, name, stages):
    """V2 on 4 stages (pitch/onset/offset/refine), V1 on 3, the velocity
    head as a 5th: every pipe rank holds the sequential logits."""

    ranks, references, _ = runs
    for result in ranks[:stages]:
        _assert_logits(result[name]['logits'], references[name])
    if name == 'velocity':
        assert tools.KEY_VELOCITY in ranks[0][name]['logits']


def test_flagship_pipeline_dp_x_pp(runs):
    """The same 4 stages composed with a data axis (4 x 2 mesh)."""

    ranks, references, _ = runs
    ref = references['v2_dp']
    for rank, result in enumerate(ranks):
        rows = slice(4 * (rank % 2), 4 * (rank % 2) + 4)
        _assert_logits(result['v2_dp']['logits'],
                       {side: {k: v[rows] for k, v in ref[side].items()}
                        for side in ('jax', 'port')})


def test_flagship_pipeline_gradients_match_sequential(runs):
    """d loss / d feats agrees with the sequential models, and each stage's
    parameter gradients with the sequential model's: the schedule and the
    detach_heads stop-gradients all differentiate."""

    ranks, references, _ = runs
    ref = references['grad']
    seen = set()
    for result in ranks[:4]:
        got = result['grad']
        for want in (ref['jax_grad'], ref['port_grad']):
            np.testing.assert_allclose(got['feats_grad'], want, rtol=5e-4,
                                       atol=5e-5)
        for key, grad in got['param_grads'].items():
            # The offset head feeds no loss term here (the refinement reads
            # it detached): the sequential model leaves its gradient None,
            # the pipeline's payload carries zeros back to it
            want = ref['param_grads'].get(key, np.zeros_like(grad))
            np.testing.assert_allclose(grad, want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=key)
            seen.add(key)
    # The stages' gradients cover the model's
    assert seen >= set(ref['param_grads'])
