"""The port's ``profiling.py`` on the CPU, against the analytic count and JAX.

- The FLOPs ``FlopCounterMode`` counts for a small O&F2 forward (through
  kernel B's op formula for the six recurrences) equal the count worked out
  from the architecture: the convolutions, the dense layers and the
  recurrences' 2 H 4H a row and step. The fused layouts (one grouped conv
  stack, one grouped launch of B for four of the recurrences) count the
  same.
- ``StageTimer``'s stages, counts and report layout are JAX's on the same
  stages (the times differ).
- The peaks: 0.0 on the CPU and for an unknown card, the H100 SXM table
  read by ``torch.cuda.get_device_name``.
- ``trace`` writes a TensorBoard trace file; ``compiled_cost`` counts the
  kernels' own bytes; ``mfu`` is 0.0 where the peak is unknown.
"""

import glob
import re
import time

import numpy as np
import pytest
import torch

from amt_tools_tpu import profiling as jax_profiling

from amt_tools_tpu_torch import profiling, tools
from amt_tools_tpu_torch.models import OnsetsFrames2
from amt_tools_tpu_torch.ops import lstm_kernel, stft_kernel
from amt_tools_tpu_torch.ops.cuda_build import OP_COSTS

torch.set_num_threads(1)

BATCH, FRAMES, DIM_IN = 2, 9, 16


def _model(fused=False):
    return OnsetsFrames2(dim_in=DIM_IN, profile=tools.PianoProfile(),
                         model_complexity=2, fused_heads=fused,
                         fused_lms=fused).eval()


def _feats():
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.rand(BATCH, FRAMES, DIM_IN, 1).astype(
        np.float32))


def _analytic_flops(model):
    """The forward's multiply-adds, two FLOPs each, from the architecture:
    three acoustic stacks (3x3 SAME convs at F, F and F/2 after a 1x2
    pool, then the dense layer over F/4 x nf3), three BiLSTMs (two
    input projections and two recurrences each) and four output layers."""

    b, t, f = BATCH, FRAMES, DIM_IN
    c = model.model_complexity
    nf1, nf3 = 16 * c, 32 * c
    flops = 0
    for _ in model.head_names:
        flops += 2 * b * t * f * nf1 * 1 * 9
        flops += 2 * b * t * f * nf1 * nf1 * 9
        flops += 2 * b * t * (f // 2) * nf3 * nf1 * 9
        flops += 2 * b * t * (nf3 * (f // 4)) * model.dim_am
    hidden = model.dim_lm // 2
    for width in (model.dim_am, model.dim_am, 3 * model.dim_out):
        flops += 2 * (2 * b * t * width * 4 * hidden)
        flops += 2 * lstm_kernel.scan_cost(b, t, hidden, torch.float32)[0]
    flops += 2 * b * t * model.dim_am * model.dim_out
    flops += 3 * 2 * b * t * model.dim_lm * model.dim_out

    return flops


def test_forward_flops_equal_the_analytic_count():
    model, feats = _model(), _feats()

    with torch.no_grad():
        counted = profiling.compiled_flops(model, feats)

    assert counted == _analytic_flops(model)


def test_fused_forward_flops_equal_the_analytic_count():
    """The fused layouts count the per-head layout's FLOPs: the grouped
    convolutions by their groups, the grouped launch of B by G times its
    formula."""

    model, feats = _model(fused=True), _feats()

    with torch.no_grad():
        counted = profiling.compiled_flops(model, feats)

    assert counted == _analytic_flops(model)


def test_compiled_cost_counts_the_kernels_bytes():
    """A call of kernel B's op alone: its cost function's FLOPs and bytes,
    not the bytes of its tensors."""

    rng = np.random.RandomState(1)
    xw = torch.from_numpy(rng.randn(2, 5, 64).astype(np.float32))
    w_h = torch.from_numpy(rng.randn(16, 64).astype(np.float32))

    flops, num_bytes = profiling.compiled_cost(lstm_kernel.lstm_scan, xw, w_h)

    assert (flops, num_bytes) == lstm_kernel.scan_cost(2, 5, 16,
                                                       torch.float32)
    assert torch.ops.amt_tools_tpu_torch.lstm_scan in OP_COSTS


def test_compiled_cost_counts_other_ops_once_each():
    x = torch.ones(4, 8)
    w = torch.ones(8, 3)

    flops, num_bytes = profiling.compiled_cost(lambda: torch.mm(x, w))

    assert flops == 2 * 4 * 8 * 3
    assert num_bytes == 4 * (4 * 8 + 8 * 3 + 4 * 3)


def _stages(timer):
    """The same three stages, in the same order, one of them twice."""

    for stage in ('features', 'forward', 'features', 'decode'):
        with timer(stage):
            time.sleep(0.001)


def test_stage_timer_matches_jax():
    ours, theirs = profiling.StageTimer(), jax_profiling.StageTimer()
    _stages(ours)
    _stages(theirs)

    assert list(ours.times) == list(theirs.times)
    assert {k: len(v) for k, v in ours.times.items()} == \
        {k: len(v) for k, v in theirs.times.items()}
    assert sorted(ours.totals()) == sorted(theirs.totals())
    layout = re.compile(r'^(\S+)\s+total\s+[\d.]+s\s+mean\s+[\d.]+s\s+'
                        r'n=(\d+)$')
    for mine, jax_line in zip(ours.report().splitlines(),
                              theirs.report().splitlines()):
        assert layout.match(mine).groups() == layout.match(jax_line).groups()
        assert len(mine) == len(jax_line)
    assert all(v >= 0.001 for v in ours.totals().values())


def test_block_and_time_returns_result_and_best():
    result, best = profiling.block_and_time(lambda x: x + 1, 41, repeats=3)

    assert result == 42
    assert 0.0 <= best < 1.0


def test_peaks_on_the_cpu_are_zero():
    assert profiling.peak_flops('cpu') == 0.0
    assert profiling.peak_flops('cpu', 'float32') == 0.0
    assert profiling.peak_hbm_bw('cpu') == 0.0
    if not torch.cuda.is_available():
        assert profiling.peak_flops() == 0.0
        assert profiling.peak_hbm_bw() == 0.0


@pytest.mark.parametrize('name, dtype, flops, hbm', [
    ('NVIDIA H100 80GB HBM3', 'bf16', 989e12, 3.35e12),
    ('NVIDIA H100 80GB HBM3', torch.bfloat16, 989e12, 3.35e12),
    ('NVIDIA H100 80GB HBM3', 'int8', 1979e12, 3.35e12),
    ('NVIDIA H100 80GB HBM3', 'float32', 67e12, 3.35e12),
    ('NVIDIA H100 80GB HBM3', torch.float32, 67e12, 3.35e12),
    ('NVIDIA H100 80GB HBM3', 'tf32', 495e12, 3.35e12),
    ('NVIDIA A100-SXM4-80GB', 'bf16', 0.0, 0.0),
])
def test_peak_table_read_by_device_name(monkeypatch, name, dtype, flops, hbm):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device=None:
                        name)

    assert profiling.peak_flops(None, dtype) == flops
    assert profiling.peak_flops('cuda:0', dtype) == flops
    assert profiling.peak_hbm_bw() == hbm


def test_mfu_on_the_cpu_is_zero_with_its_flops():
    model, feats = _model(), _feats()

    with torch.no_grad():
        fraction, achieved, secs = profiling.mfu(model, feats, repeats=2)

    assert fraction == 0.0
    assert secs > 0
    assert achieved * secs == pytest.approx(_analytic_flops(model))


def test_trace_writes_a_tensorboard_trace(tmp_path):
    audio = torch.zeros(1, 4096)
    from amt_tools_tpu_torch.features import MelSpec
    bank = MelSpec(n_mels=16)._bank(torch.device('cpu'))

    with profiling.trace(str(tmp_path)):
        stft_kernel.stft_power(audio, bank, 2048, 512)

    files = glob.glob(str(tmp_path / '*.pt.trace.json'))
    assert files
    assert 'amt_tools_tpu_torch::stft_power' in open(files[0]).read()
