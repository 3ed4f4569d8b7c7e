"""Int8 serving: the port's ``ops.qconv`` layers, ``calibrate_quant_stats``
and the int8 models against the JAX package's, on the CPU, with Flax
variables made from a seed (the pipelines: ``test_torch_int8_pipeline.py``).

Tolerances:
- ``quantize_symmetric``, ``Int8Conv`` (SAME and VALID) and ``Int8Dense``,
  dynamic and static, in float32: none, bit for bit (the same division,
  round half to even, int32 sums and the scales' product taken first);
- ``calibrate_quant_stats``: each scale within 1e-6 relative (the float
  layers ahead of each int8 layer sum in another order);
- int8 models on identical features with JAX's scales: float32 logits
  within 2e-3, PARITY.md's bound for the float models; bf16 logits within
  4e-2, two bf16 ulps at the logits' magnitude (below 4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.features import MelSpec as JaxMelSpec
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models import TabCNN as JaxTabCNN
from amt_tools_tpu.ops import qconv as jqconv
from amt_tools_tpu.serving import calibrate_quant_stats as jax_calibrate

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import OnsetsFrames2, TabCNN
from amt_tools_tpu_torch.ops import qconv
from amt_tools_tpu_torch.ops.qconv import (Int8Conv, Int8Dense, int8_layers,
                                           int8_matmul, quantize_symmetric)
from amt_tools_tpu_torch.serving import calibrate_quant_stats
from amt_tools_tpu_torch.weights import from_flax

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)

LOGIT_ATOL = 2e-3
BF16_ATOL = 4e-2
STAT_RTOL = 1e-6
N_MELS = 48


def _strip_stats(variables):
    return {k: v for k, v in variables.items() if k != jqconv.QUANT_STATS}


def _stats_by_name(variables):
    """JAX's quant_stats as {port layer name: float}."""

    return {'.'.join(p.key for p in path[:-1]): float(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables[jqconv.QUANT_STATS])}


# -- the layers -------------------------------------------------------------


@pytest.mark.parametrize('axis', [None, 0, -1])
def test_quantize_symmetric_bit_for_bit(axis):
    x = np.random.RandomState(0).randn(4, 7, 5).astype(np.float32) * 3.0
    want_q, want_s = jqconv.quantize_symmetric(jnp.asarray(x), axis=axis)
    got_q, got_s = quantize_symmetric(torch.from_numpy(x), axis=axis)

    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _conv_pair(padding, static, seed=0, c_in=8, c_out=12):
    """A Flax Int8Conv and the port's, on the same variables (random bias),
    and a (B, H, W, C) batch of clips of unequal loudness."""

    rng = np.random.RandomState(seed)
    x = (rng.rand(3, 9, 16, c_in) *
         rng.uniform(0.1, 3.0, (3, 1, 1, 1))).astype(np.float32)
    flax_conv = jqconv.Int8Conv(c_out, (3, 3), padding=padding,
                                static_scale=static)
    params = flax_conv.init(jax.random.PRNGKey(seed), x)['params']
    params = {'kernel': params['kernel'],
              'bias': rng.randn(c_out).astype(np.float32)}

    conv = Int8Conv(c_in, c_out, padding=padding, static_scale=static)
    conv.load_state_dict(from_flax({'params': params}))

    return flax_conv, params, conv, x


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize('static', [False, True])
@pytest.mark.parametrize('padding', ['SAME', 'VALID'])
def test_int8_conv_bit_for_bit(padding, static):
    flax_conv, params, conv, x = _conv_pair(padding, static)

    if static:
        want, mutated = flax_conv.apply({'params': params}, x,
                                        mutable=[jqconv.QUANT_STATS])
        conv.calibrating = True
    else:
        want = flax_conv.apply({'params': params}, x)
    got = _nhwc(conv(_nchw(x)))

    assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
    np.testing.assert_array_equal(got, np.asarray(want))
    if static:
        assert float(conv.act_amax) == float(
            mutated[jqconv.QUANT_STATS]['act_amax'])


@pytest.mark.parametrize('static', [False, True])
def test_int8_dense_bit_for_bit(static):
    rng = np.random.RandomState(1)
    x = (rng.rand(2, 9, 40) *
         rng.uniform(0.1, 3.0, (2, 9, 1))).astype(np.float32)
    flax_dense = jqconv.Int8Dense(24, static_scale=static)
    params = flax_dense.init(jax.random.PRNGKey(1), x)['params']
    params = {'kernel': params['kernel'],
              'bias': rng.randn(24).astype(np.float32)}

    dense = Int8Dense(40, 24, static_scale=static)
    dense.load_state_dict(from_flax({'params': params}))
    if static:
        want = flax_dense.apply({'params': params}, x,
                                mutable=[jqconv.QUANT_STATS])[0]
        dense.calibrating = True
    else:
        want = flax_dense.apply({'params': params}, x)

    got = dense(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 9, 24)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize('layer', ['conv', 'dense'])
def test_calibration_pass_equals_the_serving_pass_after_it(layer):
    """The calibrating forward folds max|x| first, then quantizes with it;
    the serving forward after it reads the scale and gives the same."""

    rng = np.random.RandomState(5)
    if layer == 'conv':
        module = Int8Conv(8, 12, static_scale=True)
        x = torch.from_numpy(rng.rand(2, 8, 9, 16).astype(np.float32))
    else:
        module = Int8Dense(8, 12, static_scale=True)
        x = torch.from_numpy(rng.rand(2, 9, 8).astype(np.float32))

    module.calibrating = True
    with torch.no_grad():
        calibrating = module(x)
    module.calibrating = False
    assert float(module.act_amax) == float(x.abs().max())

    with torch.no_grad():
        serving = module(x)
        louder = module(4.0 * x)
    torch.testing.assert_close(serving, calibrating, rtol=0, atol=0)
    # Serving reads the scale and never updates it: louder input saturates
    assert float(module.act_amax) == float(x.abs().max())
    assert not torch.equal(louder, 4.0 * serving)


@pytest.mark.parametrize('static', [False, True])
def test_chunks_equal_one_pass(monkeypatch, static):
    """The im2col and the product in chunks of whole samples (rows for the
    dense) give what one pass gives."""

    _, _, conv, x = _conv_pair('SAME', static, seed=2)
    dense = Int8Dense(16, 8, static_scale=static)
    if static:
        conv.act_amax.fill_(2.0)
        dense.act_amax.fill_(1.5)
    rows = torch.rand(50, 16)

    with torch.no_grad():
        whole = conv(_nchw(x)), dense(rows)
        monkeypatch.setattr(qconv, 'CHUNK_BYTES', 1)
        chunked = conv(_nchw(x)), dense(rows)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dynamic_scales_independent_of_batch_composition():
    """Per-sample scales: a clip's outputs do not change when a much louder
    clip joins its batch (the JAX package's test of the same)."""

    rng = np.random.RandomState(3)
    quiet = torch.from_numpy(rng.rand(1, 8, 9, 16).astype(np.float32))
    loud = 100.0 * torch.from_numpy(rng.rand(1, 8, 9, 16).astype(np.float32))
    conv = Int8Conv(8, 12)

    with torch.no_grad():
        alone = conv(quiet)
        together = conv(torch.cat([quiet, loud]))
    torch.testing.assert_close(together[:1], alone, rtol=0, atol=0)


@pytest.mark.parametrize('m,k,n', [(3, 9, 12), (40, 432, 48), (17, 16, 8)])
def test_int8_matmul_pads_to_the_cards_rules(m, k, n):
    """Zero padding to M > 16, K and N multiples of 8 changes no sum."""

    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = int8_matmul(a, b)

    assert got.dtype == torch.int32 and got.shape == (m, n)
    torch.testing.assert_close(got, a.int() @ b.int().t(), rtol=0, atol=0)


def test_bf16_output_is_the_rounded_float32_output():
    _, _, conv, x = _conv_pair('VALID', False, seed=4)
    with torch.no_grad():
        f32 = conv(_nchw(x))
        conv.dtype = torch.bfloat16
        bf16 = conv(_nchw(x))
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, f32.to(torch.bfloat16), rtol=0, atol=0)


# -- checkpoints ------------------------------------------------------------


def _jax_of2(dim_in=N_MELS, complexity=2, **kwargs):
    return JaxOnsetsFrames2(dim_in=dim_in, profile=jtools.PianoProfile(),
                            model_complexity=complexity, **kwargs)


def _port_of2(dim_in=N_MELS, complexity=2, **kwargs):
    return OnsetsFrames2(dim_in=dim_in, profile=tools.PianoProfile(),
                         model_complexity=complexity, **kwargs)


def test_state_dict_covers_every_flax_leaf_with_quant_stats():
    jax_model = _jax_of2(dim_in=32, quant_acoustic='static',
                         quant_lm='static')
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8, 32, 1))))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    # 3 stacks x (Conv_1, Conv_2, Dense_0) + 3 BiLSTMs x 2 projections
    assert len(jax.tree_util.tree_leaves(variables['quant_stats'])) == 15

    state = from_flax(variables)
    model = _port_of2(dim_in=32, quant_acoustic='static', quant_lm='static')
    expected = model.state_dict()
    assert sorted(state) == sorted(expected)
    for key, value in state.items():
        assert value.shape == expected[key].shape, key
    model.load_state_dict(state)


def test_a_float_checkpoint_loads_into_an_int8_model():
    """Same parameter names and the same random initialization; the scales
    stay zero until calibrated."""

    generator = torch.Generator
    float_model = _port_of2(generator=generator().manual_seed(7))
    int8_model = _port_of2(generator=generator().manual_seed(7),
                           quant_acoustic='static', quant_lm='static')
    for name, value in float_model.state_dict().items():
        torch.testing.assert_close(int8_model.state_dict()[name], value,
                                   rtol=0, atol=0)

    int8_model.load_state_dict(float_model.state_dict())
    assert all(float(layer.act_amax) == 0.0
               for _, layer in int8_layers(int8_model))
    assert len(int8_layers(int8_model)) == 15


def test_from_flax_rejects_other_collections():
    with pytest.raises(ValueError, match='intermediates'):
        from_flax({'params': {}, 'intermediates': {'x': np.zeros(1)}})


# -- calibration ------------------------------------------------------------


def test_calibrate_quant_stats_matches_jax():
    """O&F2 at complexity 2, float32, 229 mels: the 9 scales (3 stacks x
    Conv_1, Conv_2, Dense_0) after a soft and then a loud batch, each
    within 1e-6 relative of JAX's running maximum."""

    rng = np.random.RandomState(0)
    soft = 0.05 * rng.randn(1, 16000).astype(np.float32)
    loud = 0.9 * rng.randn(1, 16000).astype(np.float32)

    jax_model = _jax_of2(dim_in=229, quant_acoustic='static')
    jax_mel = JaxMelSpec(n_mels=229)
    feats = jax_model.pre_proc({jtools.KEY_FEATS: jax_mel.process_jax(
        jnp.asarray(soft))})[jtools.KEY_FEATS]
    variables = _strip_stats(jax.jit(jax_model.init)(
        jax.random.PRNGKey(0), jnp.zeros_like(feats)))
    after_soft = jax_calibrate(jax_model, variables, jax_mel,
                               jnp.asarray(soft))
    after_loud = jax_calibrate(jax_model, after_soft, jax_mel,
                               jnp.asarray(loud))

    model = _port_of2(dim_in=229, quant_acoustic='static')
    model.load_state_dict(from_flax(variables))
    mel = MelSpec(n_mels=229)
    got_soft = calibrate_quant_stats(model, mel, soft, device='cpu')
    got_loud = calibrate_quant_stats(model, mel, [loud], device='cpu')

    for got, want in ((got_soft, _stats_by_name(after_soft)),
                      (got_loud, _stats_by_name(after_loud))):
        assert sorted(got) == sorted(want) and len(got) == 9
        for name, value in want.items():
            assert value > 0
            assert abs(got[name] - value) <= STAT_RTOL * value, name
    assert all(got_loud[name] >= got_soft[name] for name in got_soft)
    assert not any(layer.calibrating for _, layer in int8_layers(model))


# -- the models -------------------------------------------------------------


def _calibrated_jax_variables(jax_model, feats, seed):
    """Variables from a seed with random BatchNorm statistics and biases,
    and (static models) JAX's scales from a calibration pass on feats."""

    rng = np.random.RandomState(seed)
    variables = jax.jit(lambda k, x: jax_model.init(k, x, train=False))(
        {'params': jax.random.PRNGKey(seed),
         'dropout': jax.random.PRNGKey(seed + 1)}, jnp.zeros_like(feats))
    variables = _strip_stats(variables)

    def perturb(path, value):
        name = path[-1].key
        if name == 'mean':
            return rng.randn(*value.shape).astype(np.float32) * 0.1
        if name == 'var':
            return rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
        if name == 'bias':
            return value + 0.05 * rng.randn(*value.shape).astype(np.float32)
        return value

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    if jax_model.quant_acoustic == 'static' or jax_model.quant_lm == 'static':
        _, mutated = jax_model.apply(variables, feats,
                                     mutable=[jqconv.QUANT_STATS])
        variables = {**variables, **mutated}

    return variables


@pytest.mark.parametrize('quant,dtype', [
    ('static', None), ('static', 'bf16'), (True, None)])
def test_onsets_frames2_int8_logits_match_flax(quant, dtype):
    rng = np.random.RandomState(11)
    feats = rng.rand(2, 1, N_MELS, 30).astype(np.float32)
    kwargs = dict(quant_acoustic=quant, quant_lm=quant)

    jax_model = _jax_of2(dtype=jnp.bfloat16 if dtype else None, **kwargs)
    pre = jax_model.pre_proc({jtools.KEY_FEATS: jnp.asarray(feats)})[
        jtools.KEY_FEATS]
    variables = _calibrated_jax_variables(jax_model, pre, seed=3)
    want = jax_model.apply(variables, pre)

    model = _port_of2(dtype=torch.bfloat16 if dtype else None, **kwargs)
    model.load_state_dict(from_flax(variables))
    model.eval()
    with torch.no_grad():
        got = model(model.pre_proc({tools.KEY_FEATS: torch.from_numpy(
            feats)})[tools.KEY_FEATS])

    atol = BF16_ATOL if dtype else LOGIT_ATOL
    assert sorted(got) == sorted(want)
    for key in want:
        ref = np.asarray(want[key], np.float32)
        assert np.abs(ref).max() < 4.0
        assert got[key].dtype == (torch.bfloat16 if dtype else torch.float32)
        np.testing.assert_allclose(got[key].float().numpy(), ref, rtol=0,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize('fullseq,quant,dtype', [
    (True, 'static', None), (True, 'static', 'bf16'), (True, True, None),
    (False, 'static', None), (False, True, None)])
def test_tabcnn_int8_logits_match_flax(fullseq, quant, dtype):
    """In the dynamic mode the per-sample scale covers a whole clip in
    fullseq and one context window in the windowed forward, in both
    packages."""

    rng = np.random.RandomState(12)
    feats = (rng.rand(2, 1, 40, 23) *
             rng.uniform(0.2, 1.0, (2, 1, 1, 23))).astype(np.float32)
    jax_model = JaxTabCNN(dim_in=40, profile=jtools.GuitarProfile(),
                          fullseq=fullseq, quant_acoustic=quant,
                          dtype=jnp.bfloat16 if dtype else None)
    pre = jax_model.pre_proc({jtools.KEY_FEATS: jnp.asarray(feats)})[
        jtools.KEY_FEATS]
    variables = _calibrated_jax_variables(jax_model, pre, seed=4)
    want = np.asarray(jax_model.apply(variables, pre)[jtools.KEY_TABLATURE],
                      np.float32)

    model = TabCNN(dim_in=40, profile=tools.GuitarProfile(), fullseq=fullseq,
                   quant_acoustic=quant,
                   dtype=torch.bfloat16 if dtype else None)
    model.load_state_dict(from_flax(variables))
    model.eval()
    with torch.no_grad():
        got = model(model.pre_proc({tools.KEY_FEATS: torch.from_numpy(
            feats)})[tools.KEY_FEATS])[tools.KEY_TABLATURE]

    assert np.abs(want).max() < 4.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_ATOL if dtype else LOGIT_ATOL)
