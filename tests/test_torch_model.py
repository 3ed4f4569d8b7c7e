"""O&F logits: the port with weights from ``weights.from_flax`` vs the JAX
package's Flax models, on the CPU, in float32.

Tolerance: raw logits within 2e-3 absolute, the bound PARITY.md sets for
the JAX package against its own torch reference (convolution and LSTM sums
in another order, over 3 conv layers, a 5472-wide dense and 2 recurrences).
The same features go into both models, so this isolates the models.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames as JaxOnsetsFrames
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import OnsetsFrames, OnsetsFrames2
from amt_tools_tpu_torch.weights import from_flax

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)

ATOL = 2e-3


def _randomize_batch_stats(variables, rng):
    """Non-trivial BatchNorm statistics, so their mapping is exercised."""

    def walk(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict) or hasattr(value, 'items'):
                out[key] = walk(value)
            elif key == 'mean':
                out[key] = rng.randn(*value.shape).astype(np.float32) * 0.1
            else:
                out[key] = rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
        return out

    out = dict(variables)
    out['batch_stats'] = walk(variables['batch_stats'])
    return out


def _compare(jax_cls, port_cls, dim_in, complexity, batch, frames, seed):
    rng = np.random.RandomState(seed)
    feats = rng.rand(batch, 1, dim_in, frames).astype(np.float32)

    jax_model = jax_cls(dim_in=dim_in, profile=jtools.PianoProfile(),
                        model_complexity=complexity)
    jax_feats = jax_model.pre_proc({jtools.KEY_FEATS: jnp.asarray(feats)})
    jax_feats = jax_feats[jtools.KEY_FEATS]
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(seed), jax_feats)
    variables = _randomize_batch_stats(variables, rng)
    ref = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables,
                                                                  jax_feats)

    model = port_cls(dim_in=dim_in, profile=tools.PianoProfile(),
                     model_complexity=complexity)
    model.load_state_dict(from_flax(variables))
    model.eval()

    port_feats = model.pre_proc({tools.KEY_FEATS: torch.from_numpy(feats)})
    port_feats = port_feats[tools.KEY_FEATS]
    np.testing.assert_array_equal(port_feats.numpy(), np.asarray(jax_feats))

    with torch.no_grad():
        got = model(port_feats)

    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == (batch, frames, 88)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL, err_msg=key)

    return model, got


@pytest.mark.parametrize('batch,frames', [(2, 37)])
def test_onsets_frames2_narrow(batch, frames):
    model, got = _compare(JaxOnsetsFrames2, OnsetsFrames2, 48, 2, batch,
                          frames, seed=0)

    # Finalized outputs: thresholded onsets/multi-pitch, sigmoid offsets
    final = model.post_proc({tools.KEY_OUTPUT: got})
    assert final[tools.KEY_MULTIPITCH].shape == (batch, 88, frames)
    assert set(np.unique(final[tools.KEY_ONSETS].numpy())) <= {0.0, 1.0}
    offsets = final[tools.KEY_OFFSETS].numpy()
    assert ((offsets > 0) & (offsets < 1)).all()


def test_onsets_frames2_full_width():
    """Complexity 3 at 229 mels: 48/48/96 channels, a 5472 -> 768 dense,
    BiLSTMs of 256 units per direction, on a short clip."""

    model, _ = _compare(JaxOnsetsFrames2, OnsetsFrames2, 229, 3, 1, 12,
                        seed=1)
    assert model.pitch_am.Dense_0.weight.shape == (768, 5472)
    assert model.onset_lm.FastBiLSTM_0.recurrent_kernel_fwd.shape == (256, 1024)


def test_onsets_frames_v1_narrow():
    _compare(JaxOnsetsFrames, OnsetsFrames, 40, 2, 2, 21, seed=2)


def test_state_dict_covers_every_flax_leaf():
    jax_model = JaxOnsetsFrames2(dim_in=32, profile=jtools.PianoProfile(),
                                 model_complexity=2)
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8, 32, 1))))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)

    state = from_flax(variables)
    model = OnsetsFrames2(dim_in=32, profile=tools.PianoProfile(),
                          model_complexity=2)
    expected = model.state_dict()

    assert sorted(state) == sorted(expected)
    for key, value in state.items():
        assert value.shape == expected[key].shape, key


def test_training_forward_is_refused():
    model = OnsetsFrames2(dim_in=16, profile=tools.PianoProfile(),
                          model_complexity=2)
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, 4, 16, 1))
