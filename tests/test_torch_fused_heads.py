"""The fused acoustic layout (``fused_heads``) against the JAX package's
fused models and against the port's per-head layout, on the CPU.

Mirrors ``tests/test_fused_heads.py``. The JAX per-head variables are
fused by JAX's converter and loaded through ``weights.from_flax`` (grouped
conv kernels (kh, kw, Cin/G, Cout) -> OIHW, ``head_kernels`` (H, K, D) as
they are). Tolerances: float32 logits within 1e-5 of JAX's fused model and
of the port's per-head model (the same sums, blocked otherwise by the
grouped conv); the converters bit for bit, and ``from_flax`` of a fused
tree bit for bit the port's converter on ``from_flax`` of the per-head
tree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames as JaxOnsetsFrames
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models.onsetsframes import (
    fuse_acoustic_variables as jax_fuse_acoustic)

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import (OnsetsFrames, OnsetsFrames2,
                                        fuse_acoustic_variables,
                                        unfuse_acoustic_variables)
from amt_tools_tpu_torch.models.onsetsframes import GroupedAcousticModel
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

DIM_IN, FRAMES = 72, 16
MODELS = {'v1': (JaxOnsetsFrames, OnsetsFrames),
          'v2': (JaxOnsetsFrames2, OnsetsFrames2)}


def _feats(seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(2, FRAMES, DIM_IN, 1).astype(np.float32)


def _variables(jax_cls, feats, **kw):
    model = jax_cls(dim_in=DIM_IN, profile=jtools.PianoProfile(),
                    model_complexity=2, **kw)
    rngs = {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)}
    return model, model.init(rngs, jnp.asarray(feats), train=False)


def _port(cls, state, **kw):
    model = cls(DIM_IN, tools.PianoProfile(), model_complexity=2, **kw)
    model.load_state_dict(state)
    return model.eval()


def _forward(model, feats, lengths=None):
    with torch.no_grad():
        return model(torch.from_numpy(feats), lengths=lengths)


@pytest.mark.parametrize('version', ['v1', 'v2'])
def test_fused_heads_match_jax_and_the_per_head_port(version):
    jax_cls, cls = MODELS[version]
    feats = _feats()
    jax_ref, v_ref = _variables(jax_cls, feats)
    jax_fused = jax_cls(dim_in=DIM_IN, profile=jtools.PianoProfile(),
                        model_complexity=2, fused_heads=True)
    v_fused = jax_fuse_acoustic(v_ref, jax_ref.head_names)
    want = jax_fused.apply(v_fused, jnp.asarray(feats), train=False)

    fused = _port(cls, from_flax(v_fused), fused_heads=True)
    per_head = _port(cls, from_flax(v_ref))
    got = _forward(fused, feats)
    ref = _forward(per_head, feats)

    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   rtol=0, atol=1e-5, err_msg=key)


def test_fused_heads_with_velocity_and_lengths():
    """The fourth (velocity) head and bucketed lengths through the grouped
    stack."""

    feats = _feats(1)
    lengths = np.array([FRAMES, 9])
    jax_ref, v_ref = _variables(JaxOnsetsFrames2, feats,
                                estimate_velocity=True)
    assert jax_ref.head_names == ('pitch', 'onset', 'offset', 'velocity')
    jax_fused = JaxOnsetsFrames2(dim_in=DIM_IN, profile=jtools.PianoProfile(),
                                 model_complexity=2, estimate_velocity=True,
                                 fused_heads=True)
    v_fused = jax_fuse_acoustic(v_ref, jax_ref.head_names)
    want = jax_fused.apply(v_fused, jnp.asarray(feats), train=False,
                           lengths=jnp.asarray(lengths))

    fused = _port(OnsetsFrames2, from_flax(v_fused), fused_heads=True,
                  estimate_velocity=True)
    assert fused.head_names == jax_ref.head_names
    got = _forward(fused, feats, torch.from_numpy(lengths))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)


@pytest.mark.parametrize('velocity', [False, True])
def test_converters_round_trip_and_commute_with_from_flax(velocity):
    feats = _feats(2)
    jax_ref, v_ref = _variables(JaxOnsetsFrames2, feats,
                                estimate_velocity=velocity)
    heads = jax_ref.head_names
    per_head = from_flax(v_ref)

    fused = fuse_acoustic_variables(per_head, heads)
    want = from_flax(jax_fuse_acoustic(v_ref, heads))
    assert sorted(fused) == sorted(want)
    for key in want:
        assert torch.equal(fused[key], want[key]), key

    model = OnsetsFrames2(DIM_IN, tools.PianoProfile(), model_complexity=2,
                          estimate_velocity=velocity, fused_heads=True)
    assert {k: v.shape for k, v in fused.items()} == {
        k: v.shape for k, v in model.state_dict().items()}

    back = unfuse_acoustic_variables(fused, heads)
    assert sorted(back) == sorted(per_head)
    for key in per_head:
        assert torch.equal(back[key], per_head[key]), key
    assert sorted(fuse_acoustic_variables(back, heads)) == sorted(fused)


def test_each_head_reads_its_own_channels():
    """Convs 2-3 are block-diagonal by head and each head's flatten takes
    its own channels (the order within a head is held to JAX above): with
    zero conv weights for heads 1 and 2 after conv1, only head 0's
    embedding varies over frames."""

    stack = GroupedAcousticModel(DIM_IN, 8, heads=3, model_complexity=1)
    stack.eval()
    with torch.no_grad():
        stack.Conv_1.weight[16:].zero_()  # nf1 = 16 channels a head
        stack.Conv_2.weight[32:].zero_()  # nf3 = 32
        out = stack(torch.from_numpy(_feats(3)))
    assert out.shape == (2, FRAMES, 3, 8)
    # Heads 1 and 2 saw zero conv weights after conv1: their embeddings
    # are the projection of a constant activation, the same at every frame
    for head in (1, 2):
        assert torch.allclose(out[:, :, head], out[:1, :1, head].expand(
            2, FRAMES, 8), atol=1e-6)
    assert not torch.allclose(out[:, :, 0], out[:1, :1, 0].expand(
        2, FRAMES, 8), atol=1e-6)


def test_fused_heads_refusals():
    profile = tools.PianoProfile()
    with pytest.raises(ValueError, match='quant_acoustic'):
        OnsetsFrames2(DIM_IN, profile, model_complexity=2, fused_heads=True,
                      quant_acoustic=True)
    with pytest.raises(ValueError, match="remat='blocks'"):
        OnsetsFrames2(DIM_IN, profile, model_complexity=2, fused_heads=True,
                      remat='blocks')
    # the per-head stacks take both
    OnsetsFrames2(DIM_IN, profile, model_complexity=2, remat='blocks')


def _train_step(model, feats, seed=0):
    model.train()
    generator = torch.Generator().manual_seed(seed)
    out = model(torch.from_numpy(feats), generator=generator)
    loss = sum(v.float().square().mean() for v in out.values())
    loss.backward()
    return {name: p.grad.clone() for name, p in model.named_parameters()}


def test_remat_recomputes_the_grouped_stack_bit_for_bit():
    """``remat=True`` checkpoints the whole grouped stack: gradients,
    dropout masks and BatchNorm statistics bit for bit ``remat=False``."""

    feats = _feats(4)
    state = OnsetsFrames2(DIM_IN, tools.PianoProfile(), model_complexity=2,
                          fused_heads=True).state_dict()
    grads = []
    for remat in (False, True):
        model = OnsetsFrames2(DIM_IN, tools.PianoProfile(),
                              model_complexity=2, fused_heads=True,
                              remat=remat)
        model.load_state_dict(state)
        grads.append((_train_step(model, feats),
                      {k: v.clone() for k, v in model.state_dict().items()}))
    for (g0, s0), (g1, s1) in [grads]:
        for key in g0:
            assert torch.equal(g0[key], g1[key]), key
        for key in s0:
            assert torch.equal(s0[key], s1[key]), key
