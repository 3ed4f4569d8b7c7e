"""The ``hpt`` configuration and its cell ``hpt-serve-bf16``: the frozen
cost of kernel G against the port's, the analytic FLOPs against a count by
hand and against ``FlopCounterMode`` of the port's model, and whole runs of
a tiny copy of the cell on the CPU: correct for the port, incorrect for the
control and for the faults the check must catch."""

import json
import time

import pytest
import torch

from benchmark import control, harness
from benchmark.costs import hpt as costs
from benchmark.tests import tiny

SPEC = harness.load_spec()
CONFIG = harness.load_json('configs', 'hpt')

# The tiny cell's limits, read on a CPU at its size: the port's readings
# (features 0.13 dB, logits 0.034) below them, the control's (53 dB, 0.23)
# above
TINY_LIMITS = {'features_err': 1.0, 'logit_err': 0.1, 'notes_bad': 0}


def test_the_gru_cost_is_the_ports():
    from amt_tools_tpu_torch.ops import gru_kernel

    for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        for groups in (1, 2, 8):
            assert costs.gru_scan_cost(64, 6001, 256, size, groups) == (
                gru_kernel.gru_scan_cost(64, 6001, 256, dtype, groups))


def test_gru_launches_of_a_forward():
    launches = costs.gru_launches(CONFIG, 2, 5, 2)
    assert launches == ([costs.gru_scan_cost(2, 5, 256, 2, 8)] * 2 +
                        [costs.gru_scan_cost(2, 5, 256, 2, 2)] * 2)


def test_forward_flops_by_hand():
    # A frame of one stack: the convs at widths 229, 114, 57, 28
    convs = 2 * 9 * ((1 * 48 + 48 * 48) * 229 + (48 * 64 + 64 * 64) * 114 +
                     (64 * 96 + 96 * 96) * 57 + (96 * 128 + 128 * 128) * 28)
    fc5 = 2 * 1792 * 768
    gru = (2 * (2 * 768 * 768 + 2 * 256 * 768) +
           2 * (2 * 512 * 768 + 2 * 256 * 768))
    head = 2 * 512 * 88
    conditioning = (2 * (2 * 176 * 768 + 2 * 256 * 768) +
                    2 * (2 * 264 * 768 + 2 * 256 * 768) + 2 * head)
    per_frame = 4 * (convs + fc5 + gru + head) + conditioning
    assert costs.forward_flops(CONFIG, 3, 7) == 21 * per_frame
    # About 98 TFLOP a batch of the cell: 64 clips of 6,001 frames
    assert 95e12 < costs.forward_flops(CONFIG, 64, 6001) < 100e12


def test_forward_flops_match_the_ports_counted_flops():
    from torch.utils.flop_counter import FlopCounterMode

    from amt_tools_tpu_torch.models import RegressCRNN

    model = RegressCRNN().eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.randn(2, 1, 229, 5))
    assert counter.get_total_flops() == pytest.approx(
        costs.forward_flops(CONFIG, 2, 5), rel=1e-9)


def test_the_cell_loads_by_name():
    ctx = harness.Context('hpt-serve-bf16', 1, False, 'cpu')
    assert ctx.config['reduced'] == [] and ctx.config['family'] == 'hpt'
    assert ctx.traffic['batch'] == 64 and ctx.traffic['clip_seconds'] == 60
    assert ctx.workload['capacity'] >= 2048
    names = [m['name'] for m in harness.cell_metrics(SPEC, 'hpt-serve-bf16',
                                                      1)]
    for name in ('mfu.serve', 'device.idle.serve', 'gru.device_ms.serve',
                 'gru_roofline.serve', 'features.device_ms.serve',
                 'acoustic.device_ms.serve', 'decode.device_ms.serve',
                 'decode.host_ms.serve', 'decode.idle_ms.serve',
                 'features_roofline', 'models.device_ms.serve',
                 'decode.host_ms'):
        assert name in names
    assert [m['name'] for m in harness.cell_metrics(
        SPEC, 'hpt-serve-bf16', 0)] == ['audio_s_per_s', 'setup_s']


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """A tiny copy of the cell: 2 clips of 0.5 s, at the published
    widths."""

    path = tmp_path_factory.mktemp('hpt-cells')
    tiny.write(path, 'configs', 'hpttiny.json', dict(CONFIG, name='hpttiny'))
    tiny.write(path, 'traffic', 'piano-hpt-tiny.json',
               dict(harness.load_json('traffic', 'piano-64x60s'), batch=2,
                    pool=2, clip_seconds=0.5))
    tiny.write(path, 'workloads', 'hpt-serve-tiny.json',
               dict(harness.load_json('workloads', 'hpt-serve-bf16'),
                    config='hpttiny', traffic='piano-hpt-tiny', trace_items=2,
                    limits=TINY_LIMITS))
    tiny.write(path, 'reference', 'hpttiny.py',
               'from benchmark.reference.hpt import *  # noqa: F401,F403\n')

    return path


@pytest.mark.parametrize('trace', [0, 1])
def test_a_tiny_cpu_run_is_correct(root, trace):
    torch.manual_seed(0)
    result, checks = harness.run(SPEC, 'hpt-serve-tiny', 2 ** 31 + 11, 0.5,
                                 trace, 'cpu', time.perf_counter(), root=root)
    json.dumps(result)
    assert result['correct'] is True, result['checks']
    assert result['attempted'] > 0 and result['failed'] == 0
    assert result['metrics'] == {}


@pytest.mark.parametrize('stand_in', ['control', 'half_batch',
                                      'answer_altered'])
def test_the_control_and_the_faults_fail_the_check(root, stand_in):
    torch.manual_seed(0)
    result, checks = control.run('hpt-serve-tiny', 2 ** 31 + 11, 0.5, 'cpu',
                                 stand_in, root)
    assert result['correct'] is False
    if stand_in == 'control':
        assert result['failed'] == 0
        assert any(value > limit for _, value, limit in checks), checks


def test_the_reference_decodes_what_it_serves():
    """``served`` reads back the rows ``decode`` gives: the frames from the
    times (a shift moves a time by under half a frame), and -1 velocities
    for a result without them."""

    from benchmark.reference import hpt

    hop = CONFIG['hop_length'] / CONFIG['sample_rate']
    result = ([60.0, 61.0], [[(10 + 0.49) * hop, (14 - 0.3) * hop],
                             [(3 - 0.2) * hop, 5 * hop]], [64, 3])
    assert hpt.served(result, CONFIG).tolist() == [[61, 3, 5, 3],
                                                   [60, 10, 14, 64]]
    assert hpt.served(result[:2], CONFIG)[:, 3].tolist() == [-1, -1]
