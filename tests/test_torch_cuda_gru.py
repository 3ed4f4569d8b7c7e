"""Kernel G (``csrc/gru_scan.cu``), the epilogue's average pool and
bias-free conv, and the High-resolution Piano Transcription model on a card.

Every test here needs a CUDA device and skips without one; like
``tests/test_torch_cuda.py`` it imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_gru.py

Tolerances:
- kernel G in float32 against ``torch.nn.GRU`` (cuDNN, TF32 off) and
  against its plain version: 1e-5 of the largest output. Both compute each
  step in float32; only the order of the recurrent product's sums differs;
- kernel G in bf16 against its plain version, at the serving shapes: 1e-2
  absolute at most and 1e-4 on the mean, on outputs in (-1, 1). Both read
  the same bf16 operands and accumulate in float32, but in another order,
  which moves an occasional h across a bf16 rounding boundary (2^-8
  relative) before the next product reads it; the recurrence carries the
  difference for a few steps. A float32 product or an unrounded h in the
  kernel would move every value, which the mean would show;
- grouped launches: bit for bit each group's launch alone;
- the epilogue's average pool and bias-free route: bit for bit the eager
  ops on the card (``F.avg_pool2d``, whose float32 sum of a pair from zero,
  halving and one rounding the kernel repeats);
- the model's bf16 forward on the card against the float32 reference on
  the CPU: every head's RMS gap under 0.05 of its spread.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import RegressCRNN
from amt_tools_tpu_torch.ops import conv_epilogue as ce
from amt_tools_tpu_torch.ops import gru_kernel as gk
from amt_tools_tpu_torch.ops.gru import BiGRU

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the hand-written Hopper kernels)')
    with tools.exact_fp32():
        yield torch.device('cuda')


def _inputs(groups, batch, frames, hidden, dtype, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    xw = (0.5 * torch.randn(groups, batch, frames, 3 * hidden, generator=g,
                            device=device)).to(dtype)
    bound = hidden ** -0.5
    w_h = ((2 * torch.rand(groups, hidden, 3 * hidden, generator=g,
                           device=device) - 1) * bound).to(dtype)
    b_hn = (2 * torch.rand(groups, hidden, generator=g, device=device) - 1) * (
        bound)

    return xw, w_h, b_hn


@pytest.mark.parametrize('shape', [(2, 3, 40, 256, 1), (4, 17, 25, 256, 2),
                                   (2, 8, 30, 48, 0), (3, 33, 20, 128, 3)])
def test_kernel_g_float32_matches_plain(cuda, shape):
    groups, batch, frames, hidden, reverse_from = shape
    xw, w_h, b_hn = _inputs(groups, batch, frames, hidden, torch.float32,
                            cuda)
    got = gk.gru_scan_grouped(xw, w_h, b_hn, reverse_from)
    want = gk.gru_scan_plain(xw, w_h, b_hn, reverse_from)

    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize('groups, frames', [(8, 600), (2, 6001)])
def test_kernel_g_bf16_matches_plain_at_the_serving_shapes(cuda, groups,
                                                           frames):
    xw, w_h, b_hn = _inputs(groups, 64, frames, 256, torch.bfloat16, cuda)
    launches = gk.gru_scan_grouped.launches
    got = gk.gru_scan_grouped(xw, w_h, b_hn, groups // 2).float()
    want = gk.gru_scan_plain(xw, w_h, b_hn, groups // 2).float()

    assert gk.gru_scan_grouped.launches == launches + 1
    err = (got - want).abs()
    assert float(err.max()) <= 1e-2 and float(err.mean()) <= 1e-4


@pytest.mark.parametrize('layers', [1, 2])
def test_kernel_g_float32_matches_nn_gru(cuda, layers):
    torch.manual_seed(layers)
    ref = torch.nn.GRU(96, 256, num_layers=layers, batch_first=True,
                       bidirectional=True).to(cuda)
    ours = BiGRU(96, 256, num_layers=layers).to(cuda).eval()
    ours.load_state_dict(ref.state_dict())
    x = torch.randn(5, 300, 96, device=cuda)
    launches = gk.gru_scan_grouped.launches
    with torch.no_grad():
        got, want = ours(x), ref(x)[0]

    assert gk.gru_scan_grouped.launches == launches + layers
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_g_grouped_equals_each_group_alone(cuda, dtype):
    xw, w_h, b_hn = _inputs(6, 40, 50, 256, dtype, cuda)
    got = gk.gru_scan_grouped(xw, w_h, b_hn, 3)
    for g in range(6):
        alone = gk.gru_scan_grouped(xw[g:g + 1].contiguous(),
                                    w_h[g:g + 1].contiguous(),
                                    b_hn[g:g + 1].contiguous(),
                                    0 if g >= 3 else 1)
        assert torch.equal(got[g], alone[0])


def test_kernel_g_geometry_is_the_kernel_s(cuda):
    lib = gk.cuda_build.library('gru_scan', gk._SIGNATURES)
    for hidden in (48, 256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            for rows in (1, 8, 13, 22, 32):
                expected = gk.gru_geometry(hidden, dtype, rows)['bytes']
                assert lib.gru_scan_smem(
                    hidden, int(dtype == torch.bfloat16), rows) == expected
    plan = gk.gru_launch_plan(64, 256, torch.bfloat16, cuda, groups=8)
    assert plan['waves'] == 1 and plan['clusters'] <= plan['active_clusters']


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize('layout', [torch.contiguous_format,
                                    torch.channels_last])
@pytest.mark.parametrize('shape', [(2, 48, 50, 229), (2, 64, 7, 114),
                                   (1, 96, 9, 57), (3, 128, 5, 28),
                                   (2, 6, 3, 9)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_epilogue_average_pool_and_no_bias_match_the_eager_ops(
        cuda, dtype, shape, layout):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    x.view(-1)[::97] = -0.0
    x = x.contiguous(memory_format=layout)
    channels = shape[1]
    mean = 0.3 * torch.randn(channels, generator=g, device=cuda)
    mul = torch.rand(channels, generator=g, device=cuda) + 0.5
    bias = 0.2 * torch.randn(channels, generator=g, device=cuda)
    conv_bias = (0.1 * torch.randn(channels, generator=g, device=cuda)).to(
        dtype)
    for with_bias in (False, True):
        for pool, avg in ((False, False), (True, False), (True, True)):
            b = conv_bias if with_bias else None
            got = ce.conv_epilogue(x, b, mean, mul, bias, pool, avg)
            y = x if b is None else x + b.view(1, -1, 1, 1)
            y = F.relu(ce.batch_norm_eval(y, mean, mul, bias, dtype))
            if pool:
                y = (F.avg_pool2d(y, (1, 2), stride=(1, 2)) if avg else
                     F.max_pool2d(y, (1, 2), stride=(1, 2)))
            assert got.shape == y.shape and got.stride() == y.stride()
            assert torch.equal(_bits(got), _bits(y))


def test_model_runs_its_grus_in_kernel_g(cuda, monkeypatch):
    """Every GRU of the model runs in kernel G: four grouped launches a
    forward, and no call of the library's GRU; the convs' epilogues and
    fc5's norm run in the epilogue kernel, 9 a stack."""

    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import hpt_reference as ref

    library_calls = []
    forward = torch.nn.GRU.forward
    monkeypatch.setattr(torch.nn.GRU, 'forward', lambda self, *a, **k: (
        library_calls.append(self), forward(self, *a, **k))[1])

    model = RegressCRNN(dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(4))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(5)
    for name in state:
        if name == 'bn0.running_mean':
            state[name] = -40.0 + 5.0 * torch.randn(229, generator=g)
        elif name == 'bn0.running_var':
            state[name] = 300.0 + 100.0 * torch.rand(229, generator=g)
    model.load_state_dict(state)
    model = model.to(cuda).eval()
    assert not any(isinstance(m, torch.nn.GRU) for m in model.modules())

    feats = -40.0 + 20.0 * torch.rand(2, 1, 229, 120, generator=g)
    launches = gk.gru_scan_grouped.launches
    epilogues = ce.conv_epilogue.launches
    with torch.inference_mode():
        got = model(feats.to(cuda))
    assert gk.gru_scan_grouped.launches == launches + 4
    assert ce.conv_epilogue.launches == epilogues + 4 * 9
    assert library_calls == []

    with torch.no_grad():
        want = ref.forward(state, feats)
    for key in ref.HEADS:
        gap = (got[key].float().cpu() - want[key]).square().mean().sqrt()
        assert float(gap) <= 0.05 * float(want[key].std())
    assert np.isfinite(got['frame'].float().cpu().numpy()).all()
