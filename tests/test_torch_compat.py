"""The port's ``compat`` (reference torch checkpoints -> the port's modules).

The reference package is not installed, so the reference checkpoints are
synthetic: seeded random ``state_dict``s in the reference's parameter names
and layouts (``onset_head.0.layer1.0.weight``, ``adjoin.0.mlm.weight_ih_l0``,
``dense.3.output_layer.weight``, ...) for OnsetsFrames, OnsetsFrames2 and
TabCNN, with the BatchNorms' ``num_batches_tracked`` the reference also
saves. The port's ``compat`` must equal the JAX package's ``compat``
followed by ``weights.from_flax`` bit for bit, from an in-memory
state_dict, a live module and a ``torch.save``d file; the result loads
strictly into the port's model, whose forward then equals the Flax
forward on JAX's ported variables (float32, 1e-5); and the port refuses
what JAX refuses, with the same reason.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import compat as jax_compat
from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import AcousticModel as JaxAcousticModel
from amt_tools_tpu.models import OnsetsFrames as JaxOnsetsFrames
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models import OnsetsFramesOnline as JaxOnsetsFramesOnline
from amt_tools_tpu.models import TabCNN as JaxTabCNN

from amt_tools_tpu_torch import compat, tools
from amt_tools_tpu_torch.models import (AcousticModel, OnsetsFrames,
                                        OnsetsFrames2, OnsetsFramesOnline,
                                        TabCNN)
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

DIM_IN = 48
TOL = 1e-5


def _rand(rng, *shape, positive=False):
    x = rng.standard_normal(shape).astype(np.float32) * 0.1
    if positive:
        x = np.abs(x) + 0.5

    return torch.from_numpy(x)


def _reference_onsetsframes(model, seed):
    """A reference O&F (V1 or V2) state_dict whose shapes fit ``model``."""

    rng = np.random.RandomState(seed)
    port = model.state_dict()
    sd = {}

    def acoustic(prefix, name):
        for i, layer in enumerate(('layer1', 'layer2', 'layer3')):
            shape = port[f'{name}.Conv_{i}.weight'].shape
            sd[f'{prefix}.{layer}.0.weight'] = _rand(rng, *shape)
            sd[f'{prefix}.{layer}.0.bias'] = _rand(rng, shape[0])
            for stat in ('weight', 'bias', 'running_mean'):
                sd[f'{prefix}.{layer}.1.{stat}'] = _rand(rng, shape[0])
            sd[f'{prefix}.{layer}.1.running_var'] = _rand(rng, shape[0],
                                                          positive=True)
            sd[f'{prefix}.{layer}.1.num_batches_tracked'] = torch.tensor(7)
        shape = port[f'{name}.Dense_0.weight'].shape
        sd[f'{prefix}.fc1.0.weight'] = _rand(rng, *shape)
        sd[f'{prefix}.fc1.0.bias'] = _rand(rng, shape[0])

    def language(prefix, name):
        for suffix, side in (('', 'fwd'), ('_reverse', 'bwd')):
            four_h, width = port[
                f'{name}.FastBiLSTM_0.input_proj_{side}.weight'].shape
            sd[f'{prefix}.mlm.weight_ih_l0{suffix}'] = _rand(rng, four_h,
                                                             width)
            sd[f'{prefix}.mlm.weight_hh_l0{suffix}'] = _rand(
                rng, four_h, four_h // 4)
            sd[f'{prefix}.mlm.bias_ih_l0{suffix}'] = _rand(rng, four_h)
            sd[f'{prefix}.mlm.bias_hh_l0{suffix}'] = _rand(rng, four_h)

    def output(prefix, name):
        shape = port[f'{name}.Dense_0.weight'].shape
        sd[f'{prefix}.output_layer.weight'] = _rand(rng, *shape)
        sd[f'{prefix}.output_layer.bias'] = _rand(rng, shape[0])

    acoustic('onset_head.0', 'onset_am')
    language('onset_head.1', 'onset_lm')
    output('onset_head.2', 'onset_out')
    acoustic('pitch_head.0', 'pitch_am')
    output('pitch_head.1', 'pitch_out')
    language('adjoin.0', 'adjoin_lm')
    output('adjoin.1', 'adjoin_out')
    if isinstance(model, OnsetsFrames2):
        acoustic('offset_head.0', 'offset_am')
        language('offset_head.1', 'offset_lm')
        output('offset_head.2', 'offset_out')

    return sd


def _reference_tabcnn(model, seed):
    rng = np.random.RandomState(seed)
    port = model.state_dict()
    sd = {}
    for i, j in enumerate((0, 2, 4)):
        shape = port[f'conv{i + 1}.weight'].shape
        sd[f'conv.{j}.weight'] = _rand(rng, *shape)
        sd[f'conv.{j}.bias'] = _rand(rng, shape[0])
    for key, name in (('dense.0', 'dense1'),
                      ('dense.3.output_layer', 'tablature_out.Dense_0')):
        shape = port[f'{name}.weight'].shape
        sd[f'{key}.weight'] = _rand(rng, *shape)
        sd[f'{key}.bias'] = _rand(rng, shape[0])

    return sd


def _pairs():
    """(label, port model, JAX model) of every supported model."""

    piano, jpiano = tools.PianoProfile(), jtools.PianoProfile()

    return [
        ('OnsetsFrames', OnsetsFrames(dim_in=DIM_IN, profile=piano,
                                      model_complexity=2),
         JaxOnsetsFrames(dim_in=DIM_IN, profile=jpiano, model_complexity=2)),
        ('OnsetsFrames2', OnsetsFrames2(dim_in=DIM_IN, profile=piano,
                                        model_complexity=2),
         JaxOnsetsFrames2(dim_in=DIM_IN, profile=jpiano,
                          model_complexity=2)),
        ('TabCNN', TabCNN(dim_in=36, profile=tools.GuitarProfile(),
                          frame_width=9),
         JaxTabCNN(dim_in=36, profile=jtools.GuitarProfile(), frame_width=9)),
    ]


PAIRS = _pairs()


def _reference(model, seed=3):
    if isinstance(model, TabCNN):
        return _reference_tabcnn(model, seed)
    return _reference_onsetsframes(model, seed)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize('label, model, jax_model', PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_port_matches_jax_compat_then_from_flax(label, model, jax_model):
    reference = _reference(model)
    expected = from_flax(jax_compat.port_reference_checkpoint(jax_model,
                                                              reference))

    # From the state_dict and from a live module
    _assert_state_equal(compat.port_reference_checkpoint(model, reference),
                        expected)
    live = types.SimpleNamespace(state_dict=lambda: dict(reference))
    _assert_state_equal(compat.port_reference_checkpoint(model, live),
                        expected)

    # The model-specific entry points
    if label == 'TabCNN':
        got = compat.port_tabcnn_state_dict(reference, dim_in=36,
                                            frame_width=9)
    else:
        got = compat.port_onsetsframes_state_dict(reference)
    _assert_state_equal(got, expected)


@pytest.mark.parametrize('label, model, jax_model', PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_port_from_saved_file_serves_as_flax_does(label, model, jax_model,
                                                  tmp_path):
    reference = _reference(model, seed=5)
    path = tmp_path / 'reference.pt'
    torch.save(reference, str(path))

    state = compat.port_reference_checkpoint(model, str(path))
    model.load_state_dict(state)
    model.eval()

    variables = jax_compat.port_reference_checkpoint(jax_model, str(path))
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    _assert_state_equal(state, from_flax(variables))

    rng = np.random.RandomState(0)
    frames = 9
    feats = rng.rand(2, 1, model.dim_in, frames).astype(np.float32)
    jax_feats = jax_model.pre_proc({jtools.KEY_FEATS: jnp.asarray(feats)})
    ref = jax_model.apply(variables, jax_feats[jtools.KEY_FEATS])
    with torch.no_grad():
        port_feats = model.pre_proc({tools.KEY_FEATS: torch.from_numpy(
            feats)})
        got = model(port_feats[tools.KEY_FEATS])

    assert sorted(got) == sorted(ref)
    for key in ref:
        out = got[key].numpy()
        assert np.all(np.isfinite(out))
        np.testing.assert_allclose(out, np.asarray(ref[key]), rtol=0,
                                   atol=TOL, err_msg=key)


def _refusal(port, jax_fn):
    with pytest.raises(Exception) as theirs:
        jax_fn()
    with pytest.raises(type(theirs.value)) as mine:
        port()

    return str(mine.value), str(theirs.value)


def test_port_rejects_online_model():
    model = OnsetsFramesOnline(dim_in=DIM_IN, profile=tools.PianoProfile(),
                               model_complexity=2)
    jax_model = JaxOnsetsFramesOnline(dim_in=DIM_IN,
                                      profile=jtools.PianoProfile(),
                                      model_complexity=2)
    reference = _reference(PAIRS[1][1])

    mine, theirs = _refusal(
        lambda: compat.port_reference_checkpoint(model, reference),
        lambda: jax_compat.port_reference_checkpoint(jax_model, reference))
    assert 'unidirectional' in mine
    assert mine == theirs


def test_port_rejects_velocity_model():
    model = OnsetsFrames2(dim_in=DIM_IN, profile=tools.PianoProfile(),
                          model_complexity=2, estimate_velocity=True)
    jax_model = JaxOnsetsFrames2(dim_in=DIM_IN, profile=jtools.PianoProfile(),
                                 model_complexity=2, estimate_velocity=True)
    reference = _reference(PAIRS[1][1])

    mine, theirs = _refusal(
        lambda: compat.port_reference_checkpoint(model, reference),
        lambda: jax_compat.port_reference_checkpoint(jax_model, reference))
    assert 'velocity' in mine
    assert mine == theirs


def test_port_rejects_unknown_model():
    mine, theirs = _refusal(
        lambda: compat.port_reference_checkpoint(
            AcousticModel(dim_in=8, dim_out=8), {}),
        lambda: jax_compat.port_reference_checkpoint(
            JaxAcousticModel(dim_in=8, dim_out=8), {}))
    assert 'porting' in mine
    assert mine.replace('AcousticModel', '') == \
        theirs.replace('AcousticModel', '')
