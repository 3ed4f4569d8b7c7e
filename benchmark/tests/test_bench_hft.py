"""The ``hft`` configuration and its cell ``hft-serve-bf16``: the files
found by name, the analytic FLOPs against a count by hand and against
``FlopCounterMode`` of the port's serving forward, the attention's least
work, and whole runs of a tiny copy of the cell on the CPU: correct for
the port, incorrect for the control and for the faults the check must
catch."""

import json
import time

import pytest
import torch

from benchmark import control, harness
from benchmark.costs import hft as costs
from benchmark.tests import tiny

SPEC = harness.load_spec()
CONFIG = harness.load_json('configs', 'hft')

# The tiny copy's widths: the published ones cost about 0.5 TFLOP a
# segment-batch of two clips on the CPU
TINY = {'n_bin': 32, 'n_margin': 4, 'n_frame': 8, 'hid_dim': 32,
        'n_layers': 2, 'n_heads': 2, 'pf_dim': 64, 'n_velocity': 16}

# The tiny cell's limits, read on a CPU at its size over three seeds: the
# port's readings (features 1.1e-3 to 1.6e-3, logits 0.016 to 0.026)
# below them, the control's (features 7.06 to 7.27, logits 0.082 to
# 0.088) above
TINY_LIMITS = {'features_err': 0.1, 'logit_err': 0.05, 'notes_bad': 0}


def test_forward_flops_by_hand():
    # A frame of a segment at the published widths
    front = 2 * 256 * 61 * 4 * 5 + 2 * 256 * 244 * 256
    layer = 8 * 256 ** 3 + 4 * 256 ** 3 + 4 * 256 * 256 * 512
    encoder = 3 * layer
    cross = 2 * 256 * 256 * (2 * 88 + 2 * 256) + 4 * 88 * 256 * 256
    self_notes = 2 * 256 * 256 * 4 * 88 + 4 * 88 * 88 * 256
    ffn_notes = 4 * 88 * 256 * 512
    # The first layer's query projection of the learned queries runs once
    # a forward, not a frame
    query = 2 * 88 * 256 * 256
    decoder = 3 * (cross + ffn_notes) + 2 * self_notes - query
    time_token = 8 * 256 * 256 + 4 * 128 * 256 + 4 * 256 * 512
    time = 3 * 88 * time_token
    heads = 2 * 88 * 256 * 131
    per_frame = front + encoder + decoder + time + heads
    assert costs.frame_flops(CONFIG) == per_frame == 1931319296
    # 3 clips of 200 frames: 2 segments each
    assert costs.forward_flops(CONFIG, 3, 200) == (3 * 2 * 128 * per_frame +
                                                   query)
    # 118.7 TFLOP a batch of the cell: 16 clips of 3,751 frames, 480
    # segments
    assert costs.forward_flops(CONFIG, 16, 3751) == pytest.approx(
        118.660e12, rel=1e-4)


def test_forward_flops_match_the_ports_counted_flops():
    from torch.utils.flop_counter import FlopCounterMode

    from amt_tools_tpu_torch.models import HFTransformer

    config = dict(CONFIG, **TINY)
    model = HFTransformer(**{key: config[key] for key in (
        'n_bin', 'n_margin', 'n_frame', 'hid_dim', 'n_layers', 'n_heads',
        'pf_dim', 'n_velocity')}).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.randn(2, 1, 32, 13))
    assert counter.get_total_flops() == pytest.approx(
        costs.forward_flops(config, 2, 13), rel=1e-9)


def test_attention_cost_of_a_forward():
    calls = costs.attention_cost(CONFIG, 16, 3751, 2)
    assert len(calls) == 11
    rows = 480 * 128
    assert calls[0] == (4.0 * rows * 256 * 256 * 256,
                        2.0 * rows * 256 * (2 * 256 + 2 * 256))
    assert calls[3] == (4.0 * rows * 88 * 256 * 256,
                        2.0 * rows * 256 * (2 * 88 + 2 * 256))
    assert calls[6] == (4.0 * rows * 88 * 88 * 256,
                        2.0 * rows * 256 * 4 * 88)
    assert calls[8] == (4.0 * 480 * 88 * 128 * 128 * 256,
                        2.0 * 480 * 88 * 256 * 4 * 128)
    # The score and value products are 16.5% of the forward's FLOPs
    share = sum(f for f, _ in calls) / costs.forward_flops(CONFIG, 16, 3751)
    assert 0.16 < share < 0.17


def test_the_cell_loads_by_name():
    ctx = harness.Context('hft-serve-bf16', 1, False, 'cpu')
    assert ctx.config['reduced'] == [] and ctx.config['family'] == 'hft'
    assert ctx.traffic['batch'] == 16 and ctx.traffic['clip_seconds'] == 60
    assert ctx.workload['capacity'] == 2048 and ctx.workload['chips'] == 1
    names = [m['name'] for m in harness.cell_metrics(SPEC, 'hft-serve-bf16',
                                                      1)]
    assert names == ['features_roofline', 'models.device_ms.serve',
                     'decode.host_ms', 'device.idle.serve', 'mfu.serve',
                     'features.device_ms.serve', 'acoustic.device_ms.serve',
                     'decode.device_ms.serve', 'decode.host_ms.serve',
                     'decode.idle_ms.serve', 'transformer.device_ms.serve',
                     'attention_roofline.serve']
    assert [m['name'] for m in harness.cell_metrics(
        SPEC, 'hft-serve-bf16', 0)] == ['audio_s_per_s', 'setup_s']


def test_the_reference_parameters_are_the_ports():
    from amt_tools_tpu_torch.models import HFTransformer
    from benchmark.reference import hft

    state = HFTransformer().state_dict()
    spec = hft.parameters(CONFIG)
    assert [name for name, _, _ in spec] == list(state)
    assert all(tuple(shape) == tuple(state[name].shape)
               for name, shape, _ in spec)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """A tiny copy of the cell: 2 clips of 0.5 s (32 frames, 4 segments
    each) at the tiny widths."""

    path = tmp_path_factory.mktemp('hft-cells')
    tiny.write(path, 'configs', 'hfttiny.json',
               dict(CONFIG, name='hfttiny', **TINY))
    tiny.write(path, 'traffic', 'piano-hft-tiny.json',
               dict(harness.load_json('traffic', 'piano-16x60s'), batch=2,
                    pool=2, clip_seconds=0.5))
    tiny.write(path, 'workloads', 'hft-serve-tiny.json',
               dict(harness.load_json('workloads', 'hft-serve-bf16'),
                    config='hfttiny', traffic='piano-hft-tiny', trace_items=2,
                    limits=TINY_LIMITS))
    tiny.write(path, 'reference', 'hfttiny.py',
               'from benchmark.reference.hft import *  # noqa: F401,F403\n')

    return path


@pytest.mark.parametrize('trace', [0, 1])
def test_a_tiny_cpu_run_is_correct(root, trace):
    torch.manual_seed(0)
    result, checks = harness.run(SPEC, 'hft-serve-tiny', 2 ** 31 + 13, 0.5,
                                 trace, 'cpu', time.perf_counter(), root=root)
    json.dumps(result)
    assert result['correct'] is True, result['checks']
    assert result['attempted'] > 0 and result['failed'] == 0
    assert result['metrics'] == {}


@pytest.mark.parametrize('stand_in', ['control', 'half_batch',
                                      'answer_altered'])
def test_the_control_and_the_faults_fail_the_check(root, stand_in):
    torch.manual_seed(0)
    result, checks = control.run('hft-serve-tiny', 2 ** 31 + 13, 0.5, 'cpu',
                                 stand_in, root)
    assert result['correct'] is False
    if stand_in == 'control':
        assert result['failed'] == 0
        assert any(value > limit for _, value, limit in checks), checks


def test_the_reference_decodes_class_velocities():
    """A hand-built clip: one key's onset peak at frame 5 whose largest
    velocity logit is class 93 there; the notes read class 93."""

    from benchmark.reference import hft

    frames = 20
    logits = {key: torch.full((frames, 88), -8.0)
              for key in ('frame', 'reg_onset', 'reg_offset')}
    logits['reg_onset'][3:8, 1] = torch.tensor([-1.0, 0.5, 3.0, 0.5, -1.0])
    logits['frame'][5:12, 1] = 3.0
    logits['velocity'] = torch.zeros(frames, 88, 128)
    logits['velocity'][..., 7] = 1.0
    logits['velocity'][5, 1, 93] = 2.0
    assert hft.decode(logits, CONFIG).tolist() == [[22, 5, 12, 93]]
