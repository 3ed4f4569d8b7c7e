"""The port's mesh, data-parallel placement and collectives against the JAX
package's mesh helpers, and the kernels' refusal of DTensors, on the CPU.

The JAX side runs on its 8-device virtual CPU mesh; the port runs one
gloo process group of 4 spawned ranks (``tests/torch_ranks.py``), whose
local shards, in rank order, make the global arrays compared here. Mirrors
``tests/test_shard_guard.py`` and ``tests/test_validate_flows.py``'s
``test_local_batch_to_global``. Placement is exact (bit for bit); the
masked mean within ``rtol=1e-6`` (float32 sums in another order).
"""

import ast
import warnings
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from amt_tools_tpu import parallel as jax_parallel
from amt_tools_tpu.parallel import get_mesh as jax_get_mesh
from amt_tools_tpu.parallel import pad_shard_batch as jax_pad_shard_batch
from amt_tools_tpu.parallel import pp_flagship as jax_pp_flagship
from amt_tools_tpu.parallel import shard_batch as jax_shard_batch

import torch_ranks
from amt_tools_tpu_torch import parallel
from amt_tools_tpu_torch.parallel import pp_flagship

WORLD = 4
REPO = Path(__file__).resolve().parent.parent


def _batch(batch_size):
    rng = np.random.RandomState(0)
    return {
        'feats': rng.rand(batch_size, 1, 48, 8).astype(np.float32),
        'tablature': rng.randint(-1, 20, (batch_size, 6, 8)).astype(
            np.float32),
    }


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    inputs = {'batch30': _batch(30), 'batch32': _batch(32),
              'global': np.arange(8 * 4, dtype=np.float32).reshape(8, 4)}
    return torch_ranks.spawn('mesh_checks', WORLD,
                             tmp_path_factory.mktemp('mesh'), inputs)


def _joined(ranks, key, leaf=None):
    parts = [r[key] if leaf is None else r[key][leaf] for r in ranks]
    return np.concatenate(parts)


def test_parallel_exports_the_jax_names():
    assert parallel.__all__ == jax_parallel.__all__
    assert pp_flagship.__all__ == jax_pp_flagship.__all__
    for name in parallel.__all__:
        assert callable(getattr(parallel, name))


def test_rank_workers_import_no_jax():
    tree = ast.parse((REPO / 'tests' / 'torch_ranks.py').read_text())
    names = {alias.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    names |= {node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not any(name == 'jax' or name.startswith('jax.') or
                   name == 'amt_tools_tpu' or
                   name.startswith('amt_tools_tpu.') or
                   name.split('.')[0] in ('flax', 'optax')
                   for name in names), names


def test_shard_batch_warns_on_non_divisible(ranks):
    with pytest.warns(UserWarning, match='not.*divisible'):
        jax_shard_batch(_batch(30), jax_get_mesh())

    for result in ranks:
        assert len(result['warned30']) == 2
        assert all('not divisible' in m for m in result['warned30'])
        # Still correct (kept whole), just loud about it
        assert result['rows30'] == {'feats': 30, 'tablature': 30}


def test_shard_batch_silent_on_divisible(ranks):
    batch = _batch(32)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        want = jax_shard_batch(batch, jax_get_mesh())

    for key in batch:
        assert all(r['local32'][key].shape[0] == 8 for r in ranks)
        got = _joined(ranks, 'local32', key)
        np.testing.assert_array_equal(got, np.asarray(want[key]))
        np.testing.assert_array_equal(got, batch[key])


def test_pad_shard_batch_pads_and_masks(ranks):
    batch = _batch(30)
    want, want_valid = jax_pad_shard_batch(batch, jax_get_mesh())

    valid = _joined(ranks, 'valid')
    assert valid.shape == (32,)
    assert int(valid.sum()) == 30 and not valid[30] and not valid[31]
    np.testing.assert_array_equal(valid, np.asarray(want_valid))
    for key in batch:
        got = _joined(ranks, 'padded', key)
        assert got.shape[0] == 32
        np.testing.assert_array_equal(got, np.asarray(want[key]))
        np.testing.assert_array_equal(got[30:], 0.0)
        np.testing.assert_array_equal(got[:30], batch[key])


def test_pad_shard_batch_masked_reduction_matches_unpadded(ranks):
    batch = _batch(30)
    sharded, valid = jax_pad_shard_batch(batch, jax_get_mesh())

    @jax.jit
    def masked_mean(x, valid):
        per_example = jnp.sum(x, axis=tuple(range(1, x.ndim)))
        return jnp.sum(per_example * valid) / jnp.sum(valid)

    jax_mean = float(masked_mean(sharded['feats'], valid))
    want = float(batch['feats'].reshape(30, -1).sum(axis=1).mean())
    for result in ranks:
        np.testing.assert_allclose(result['masked_mean'], want, rtol=1e-6)
        np.testing.assert_allclose(result['masked_mean'], jax_mean,
                                   rtol=1e-6)


def test_local_batch_to_global(ranks):
    batch = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)

    got = _joined(ranks, 'local_global', 'x')
    assert got.shape == (8, 4)
    np.testing.assert_array_equal(got, batch)
    # Each rank contributed its own two rows
    assert all(r['local_global']['x'].shape == (2, 4) for r in ranks)
    # Unequal local batches are refused on every rank
    assert all('differ in shape' in r['ragged'] for r in ranks)


def test_get_mesh_shapes_and_shardings(ranks):
    coords = sorted(r['grid'][2:] for r in ranks)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for result in ranks:
        assert result['grid'][:2] == (('data', 'model'), (2, 2))
        assert result['grid_shardings'] == [('Shard', 'Replicate'),
                                            ('Replicate', 'Replicate')]
        assert 'shape is required' in result['no_shape']


def test_replicate_takes_rank_zero_values(ranks):
    for result in ranks:
        np.testing.assert_array_equal(result['replicated']['a'], 0.0)
        np.testing.assert_array_equal(result['replicated']['b'][0],
                                      np.arange(4))
        np.testing.assert_array_equal(result['replicated_module'], 0.0)


def test_differentiable_collectives(ranks):
    total_weight = sum(range(1, WORLD + 1))
    for rank, result in enumerate(ranks):
        value, grad = result['all_reduce']
        np.testing.assert_array_equal(value, sum(range(WORLD)))
        # Every rank's loss reaches every rank's input
        np.testing.assert_array_equal(grad, total_weight)

        value, grad = result['reduce_grad']
        np.testing.assert_array_equal(value, rank)
        np.testing.assert_array_equal(grad, total_weight)

        value, grad = result['gather_columns']
        np.testing.assert_array_equal(
            value, np.repeat(np.arange(WORLD, dtype=np.float32), 2)[None]
            .repeat(2, axis=0))
        # The rank's own columns of the output's gradient
        cols = np.arange(8.0)[2 * rank:2 * rank + 2]
        np.testing.assert_array_equal(grad, np.tile(cols, (2, 1)))


def test_average_gradients(ranks):
    mean = np.mean(np.arange(WORLD, dtype=np.float64))
    for result in ranks:
        float32, float64, missing = result['average_gradients']
        np.testing.assert_array_equal(float32, np.float32(mean))
        np.testing.assert_array_equal(float64, 2.0 * mean)
        assert float64.dtype == np.float64
        assert missing is None


def _refused(messages):
    return all(m is not None and m.startswith('TypeError') and
               'DTensor' in m and 'plain tensors' in m for m in messages)


def test_lstm_wrappers_refuse_dtensors(ranks):
    for result in ranks:
        assert _refused(result['lstm_refusals']), result['lstm_refusals']
        assert result['plain_refusals'][0] is None


def test_stft_wrapper_refuses_dtensors(ranks):
    for result in ranks:
        assert _refused(result['stft_refusals']), result['stft_refusals']
        assert result['plain_refusals'][1] is None


def test_cqt_wrappers_refuse_dtensors(ranks):
    for result in ranks:
        assert _refused(result['cqt_refusals']), result['cqt_refusals']
        assert result['plain_refusals'][2] is None


def test_lstm_layer_gathers_a_dtensor_recurrent_kernel(ranks):
    for result in ranks:
        got, want = result['dtensor_layer']
        np.testing.assert_array_equal(got, want)
