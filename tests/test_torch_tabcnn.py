"""TabCNN and its pieces: the port with weights from ``weights.from_flax``
vs the JAX package's Flax model, on the CPU.

Tolerances:
- ``framify``, ``pre_proc`` layouts and ``SoftmaxGroups.finalize_output``:
  none, equal values (ties included: both argmaxes return the first
  maximum);
- float32 logits: 2e-3 absolute against Flax (convolution and dense sums
  in another order over 3 convs and a 5952-wide dense at the full width);
- fullseq vs windowed in the port: 1e-5 (the same products, another
  grouping);
- bf16 vs float32: 0.05 of the logit scale, and bf16 fullseq vs windowed
  0.02 of it, the bounds ``tests/test_tablature_pipeline.py:216`` sets for
  the JAX model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import TabCNN as JaxTabCNN
from amt_tools_tpu.models.common import SoftmaxGroups as JaxSoftmaxGroups
from amt_tools_tpu.ops import frames as jframes

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import SoftmaxGroups, TabCNN
from amt_tools_tpu_torch.ops import frames
from amt_tools_tpu_torch.weights import from_flax

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)

ATOL = 2e-3


@pytest.mark.parametrize('win,hop,pad,frames_in', [(9, 1, True, 23),
                                                   (9, 1, False, 23),
                                                   (4, 2, True, 17),
                                                   (9, 1, False, 5)])
def test_framify_matches_jax(win, hop, pad, frames_in):
    acts = np.random.RandomState(0).rand(2, 1, 5, frames_in).astype(np.float32)

    got = frames.framify(torch.from_numpy(acts), win, hop, pad).numpy()
    want = np.asarray(jframes.framify(jnp.asarray(acts), win, hop, pad))

    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_softmax_groups_finalize_matches_jax(dtype):
    """Tied logits are common in bf16: both argmaxes take the first."""

    groups, classes = 6, 21
    rng = np.random.RandomState(1)
    logits = rng.randint(-3, 3, (2, 50, groups * classes)).astype(np.float32)
    assert (np.sort(logits.reshape(2, 50, groups, classes), -1)[..., -1] ==
            np.sort(logits.reshape(2, 50, groups, classes), -1)[..., -2]).any()

    head = SoftmaxGroups(8, groups * classes, groups, classes)
    ref_head = JaxSoftmaxGroups(dim_in=0, dim_out=groups * classes,
                                num_groups=groups, num_classes=classes)

    port = torch.from_numpy(logits).to(getattr(torch, dtype))
    ref = jnp.asarray(logits, getattr(jnp, dtype))
    for last_negative in (True, False):
        got = head.finalize_output(port, last_negative=last_negative)
        want = ref_head.finalize_output(ref, last_negative=last_negative)
        assert got.shape == (2, groups, 50)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == classes - 1).any()


def _flax(dim_in, frames_in, fullseq, seed, batch=2):
    """Features, the Flax model's variables and its logits."""

    rng = np.random.RandomState(seed)
    feats = rng.rand(batch, 1, dim_in, frames_in).astype(np.float32)

    jax_model = JaxTabCNN(dim_in=dim_in, profile=jtools.GuitarProfile(),
                          fullseq=fullseq)
    pre = jax_model.pre_proc({jtools.KEY_FEATS: jnp.asarray(feats)})
    pre = pre[jtools.KEY_FEATS]
    variables = jax.jit(lambda k, x: jax_model.init(k, x, train=False))(
        {'params': jax.random.PRNGKey(seed),
         'dropout': jax.random.PRNGKey(seed + 1)}, pre)
    # A bias on every layer, so the bias mapping is exercised too
    variables = jax.tree_util.tree_map(
        lambda v: v + (0.05 * rng.randn(*v.shape).astype(np.float32)
                       if v.ndim == 1 else 0.0), variables)
    ref = jax_model.apply(variables, pre, train=False)

    return feats, pre, variables, ref


def _port(variables, dim_in, **kw):
    model = TabCNN(dim_in=dim_in, profile=tools.GuitarProfile(), **kw)
    model.load_state_dict(from_flax(variables))
    return model.eval()


def _logits(model, feats):
    with torch.no_grad():
        pre = model.pre_proc({tools.KEY_FEATS: torch.from_numpy(feats)})
        return model(pre[tools.KEY_FEATS])[tools.KEY_TABLATURE]


@pytest.mark.parametrize('fullseq', [False, True])
@pytest.mark.parametrize('dim_in,frames_in', [(40, 23), (192, 7)])
def test_logits_match_flax(fullseq, dim_in, frames_in):
    """(192, 7) is the full width: 32/64/64 convs and a 5952 -> 128 dense."""

    feats, pre, variables, ref = _flax(dim_in, frames_in, fullseq, seed=2)
    model = _port(variables, dim_in, fullseq=fullseq)

    port_pre = model.pre_proc({tools.KEY_FEATS: torch.from_numpy(feats)})
    port_pre = port_pre[tools.KEY_FEATS]
    # fullseq: (B, C, F, T + 8) vs Flax NHWC (B, F, T + 8, C); windowed:
    # (B, T, C, F, W) vs (B, T, F, W, C)
    order = (0, 2, 3, 1) if fullseq else (0, 1, 3, 4, 2)
    np.testing.assert_array_equal(port_pre.permute(order).numpy(),
                                  np.asarray(pre))

    got = _logits(model, feats)
    want = np.asarray(ref[jtools.KEY_TABLATURE])
    assert got.shape == want.shape == (2, frames_in, 6 * 21)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if dim_in == 192:
        assert model.dense1.weight.shape == (128, 5952)

    final = model.post_proc({tools.KEY_OUTPUT: {tools.KEY_TABLATURE: got}})
    tablature = final[tools.KEY_TABLATURE]
    assert tablature.shape == (2, 6, frames_in)
    assert tablature.min() >= -1 and tablature.max() < 20


def test_fullseq_equals_windowed():
    feats, _, variables, _ = _flax(40, 23, False, seed=3)

    windowed = _logits(_port(variables, 40), feats)
    full = _logits(_port(variables, 40, fullseq=True), feats)

    np.testing.assert_allclose(full.numpy(), windowed.numpy(), rtol=0,
                               atol=1e-5)


def test_online_windows_match_flax():
    """Online mode: the features span one window and are not padded."""

    rng = np.random.RandomState(4)
    feats = rng.rand(2, 1, 40, 9).astype(np.float32)
    jax_model = JaxTabCNN(dim_in=40, profile=jtools.GuitarProfile(),
                          online=True)
    pre = jax_model.pre_proc({jtools.KEY_FEATS: jnp.asarray(feats)})
    pre = pre[jtools.KEY_FEATS]
    variables = jax_model.init({'params': jax.random.PRNGKey(4),
                                'dropout': jax.random.PRNGKey(5)}, pre)
    ref = np.asarray(jax_model.apply(variables, pre)[jtools.KEY_TABLATURE])

    got = _logits(_port(variables, 40, online=True), feats).numpy()
    assert got.shape == ref.shape == (2, 1, 126)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_bf16_tracks_float32():
    feats, _, variables, _ = _flax(40, 23, False, seed=5)

    ref = _logits(_port(variables, 40), feats).numpy()
    got = _logits(_port(variables, 40, dtype=torch.bfloat16), feats)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() < 0.05 * scale

    full = _logits(_port(variables, 40, dtype=torch.bfloat16, fullseq=True),
                   feats).float().numpy()
    np.testing.assert_allclose(full, got, atol=0.02 * scale, rtol=0.05)

    # Parameters stay float32 while the compute runs in bf16
    model = _port(variables, 40, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_fullseq_frame_width_guard():
    with pytest.raises(ValueError, match='frame_width == 9'):
        TabCNN(dim_in=40, profile=tools.GuitarProfile(), frame_width=7,
               fullseq=True)

    # The windowed forward takes other widths
    model = TabCNN(dim_in=40, profile=tools.GuitarProfile(),
                   frame_width=11).eval()
    with torch.no_grad():
        pre = model.pre_proc({tools.KEY_FEATS: torch.rand(1, 1, 40, 5)})
        assert model(pre[tools.KEY_FEATS])[tools.KEY_TABLATURE].shape == \
            (1, 5, 126)


def test_state_dict_covers_every_flax_leaf():
    jax_model = JaxTabCNN(dim_in=192, profile=jtools.GuitarProfile(),
                          fullseq=True)
    shapes = jax.eval_shape(lambda: jax_model.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jnp.zeros((1, 192, 12, 1)), train=False))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)

    state = from_flax(variables)
    model = TabCNN(dim_in=192, profile=tools.GuitarProfile(), fullseq=True)
    expected = model.state_dict()

    assert sorted(state) == sorted(expected)
    for key, value in state.items():
        assert value.shape == expected[key].shape, key
    assert model.num_groups == 6 and model.num_classes == 21


def test_training_forward_is_refused():
    """TabCNN trains now (tests/test_torch_tabcnn_train.py): a train-mode
    forward with dropout on is refused without an explicit generator, and
    runs with one."""

    model = TabCNN(dim_in=40, profile=tools.GuitarProfile(), fullseq=True)
    with pytest.raises(ValueError, match='explicit torch.Generator'):
        model(torch.zeros(1, 1, 40, 12))
    out = model(torch.zeros(1, 1, 40, 12),
                generator=torch.Generator().manual_seed(0))
    assert out[tools.KEY_TABLATURE].shape == (1, 4, 6 * 21)
