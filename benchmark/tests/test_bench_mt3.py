"""The ``mt3`` configuration and its cell ``mt3-serve-bf16``: the files
found by name, the analytic FLOPs and bytes against a count from the
widths and against ``FlopCounterMode`` of the port's forward, and whole
runs of a tiny copy of the cell on the CPU: correct for the port,
incorrect for the faults the check must catch."""

import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.costs import mt3 as costs
from benchmark.tests import tiny

SPEC = harness.load_spec()
CONFIG = harness.load_json('configs', 'mt3')

# The tiny copy's widths: 2 + 2 layers, width 64, 2 heads of 16, MLP 128,
# 16 mels, 16-frame segments, 12 tokens a segment
TINY = {'n_mels': 16, 'emb_dim': 64, 'num_heads': 2, 'head_dim': 16,
        'mlp_dim': 128, 'num_encoder_layers': 2, 'num_decoder_layers': 2,
        'input_length': 16, 'outputs_length': 12}

# The tiny cell's limits, read on a CPU at its size over three seeds: the
# port's readings below them (features 1.1e-4 to 2.6e-4: the plain STFT's
# float32 DFT product against the reference's rfft, in the quietest bins
# within the compared 80 dB of each frame; bf16 logits 0.0070 to 0.0080)
TINY_LIMITS = {'features_err': 0.01, 'logit_err': 0.05, 'tokens_bad': 0,
               'rows_ended': 0, 'notes_bad': 0}


def test_forward_flops_by_hand():
    """A segment at the published widths: 22.8 GFLOP of encoder, 3.2 of
    cross keys and values, 58.2 MFLOP a token over 1,024 tokens."""

    layer = 8 * 512 * 384 + 4 * 512 * 384 + 6 * 512 * 1024
    encoder = 512 * (2 * 512 * 512 + 8 * layer)
    cross = 512 * 8 * 4 * 512 * 384
    steps = sum(8 * (12 * 512 * 384 + 4 * (t + 1) * 384 + 4 * 512 * 384 +
                     6 * 512 * 1024) + 2 * 512 * 1536 for t in range(1024))
    assert costs.encoder_flops(CONFIG) == encoder == 22_817_013_760
    assert costs.cross_flops(CONFIG) == cross == 3_221_225_472
    assert costs.segment_flops(CONFIG) == encoder + cross + steps
    assert steps / 1024 == pytest.approx(58.2e6, rel=2e-3)
    assert costs.segment_flops(CONFIG) == pytest.approx(85.6e9, rel=1e-3)
    # A batch of the cell: 64 clips of 60 s, 7,501 frames, 15 segments each
    assert costs.segments(CONFIG, 7501) == 15
    assert costs.forward_flops(CONFIG, 64, 7501) == pytest.approx(82.2e12,
                                                                  rel=1e-3)


def test_forward_flops_match_the_ports_counted_flops():
    """``FlopCounterMode`` over the port's encode and cached decode, at the
    tiny widths, every row to the cap: the analytic count."""

    from torch.utils.flop_counter import FlopCounterMode

    from amt_tools_tpu_torch.models import Seq2SeqTranscriber

    config = dict(CONFIG, **TINY)
    model = Seq2SeqTranscriber(max_len=12, **{key: config[key] for key in (
        'n_mels', 'emb_dim', 'num_heads', 'head_dim', 'mlp_dim',
        'num_encoder_layers', 'num_decoder_layers', 'vocab_size')}).eval()
    with torch.no_grad():
        model.decoder.logits_dense.weight[1] = 0.0
        with FlopCounterMode(display=False) as counter:
            tokens = model(torch.randn(3, 1, 16, 16))
    assert tokens.shape == (3, 12)
    assert counter.get_total_flops() == 3 * costs.segment_flops(config)


def test_generate_and_attention_cost():
    rows = 64 * 15
    calls = costs.generate_cost(CONFIG, 64, 7501, 2)
    assert len(calls) == 1 + 1024
    assert calls[0] == (float(rows * 3_221_225_472),
                        2.0 * (rows * 512 * 512 + 8 * 768 * 512 +
                               rows * 512 * 8 * 768))
    weights = 2 * 8 * (6 * 384 * 512 + 3 * 1024 * 512 + 3 * 512) + \
        2 * 512 + 4 * 1536 * 512
    position = 2 * rows * 8 * 768
    assert calls[1] == (float(rows * costs.step_flops(CONFIG, 0)),
                        float(weights + position * 513))
    assert calls[1024][1] == float(weights + position * 1536)
    # 12.4 TB a batch from the caches: 3.7 s at 3.35 TB/s
    assert sum(b for _, b in calls[1:]) == pytest.approx(12.4e12, rel=2e-3)
    encoder = costs.attention_cost(CONFIG, 64, 7501, 2)
    assert len(encoder) == 8
    assert encoder[0] == (4.0 * rows * 512 * 512 * 384,
                          2.0 * rows * 384 * 4 * 512)


def test_features_cost_counts_each_segments_frames():
    from benchmark.costs.kernels import mel_stage_cost

    flops, num_bytes = costs.features_cost(CONFIG, 64, 960000)
    rows = 64 * 15
    want = mel_stage_cost(rows, 65536, 2048, 128, 512)
    # 512 frames a segment where the centred count makes 513
    assert flops == pytest.approx(want[0] * 512 / 513, rel=1e-12)
    assert num_bytes == want[1] - 4 * rows * 512


def test_the_cell_loads_by_name():
    ctx = harness.Context('mt3-serve-bf16', 1, False, 'cpu')
    assert ctx.config['reduced'] == [] and ctx.config['family'] == 'mt3'
    assert ctx.traffic['batch'] == 64 and ctx.traffic['clip_seconds'] == 60
    assert ctx.workload['capacity'] == 1024 and ctx.workload['chips'] == 1
    assert ctx.workload['driver'] == 'generate'
    names = [m['name'] for m in harness.cell_metrics(SPEC, 'mt3-serve-bf16',
                                                      1)]
    assert names == ['features_roofline', 'models.device_ms.serve',
                     'decode.host_ms', 'device.idle.serve', 'mfu.serve',
                     'features.device_ms.serve', 'decode.host_ms.serve',
                     'decode.idle_ms.serve', 'transformer.device_ms.serve',
                     'attention_roofline.serve', 'generate.device_ms.serve',
                     'generate_roofline.serve', 'generate.idle_ms.serve']
    assert [m['name'] for m in harness.cell_metrics(
        SPEC, 'mt3-serve-bf16', 0)] == ['audio_s_per_s', 'setup_s']


def test_the_reference_parameters_are_the_ports():
    from amt_tools_tpu_torch.models import Seq2SeqTranscriber
    from benchmark.reference import mt3

    state = Seq2SeqTranscriber().state_dict()
    spec = mt3.parameters(CONFIG)
    assert [name for name, _, _ in spec] == list(state)
    assert all(tuple(shape) == tuple(state[name].shape)
               for name, shape, _ in spec)


def test_the_features_check_parts_rounding_from_faults():
    """``features_err`` at the cell's features, on 4.096 s of its traffic:
    the port's float32 features (the CPU's plain STFT) read far under the
    cell's limit, which the raw largest gap, at bins near the 1e-5 floor,
    does not; a gain 10% off and the reference's own bf16 frames (the
    control's features) read over it."""

    import numpy as np

    from benchmark.drivers.generate import features_error
    from benchmark.programs import mt3 as program
    from benchmark.reference import mt3 as reference
    from benchmark.reference import plain
    from benchmark.traffic import notes

    limit = harness.load_json('workloads', 'mt3-serve-bf16')['limits'][
        'features_err']
    traffic = harness.load_json('traffic', 'piano-64x60s')
    seconds = 4.096
    audio = notes.render(traffic, notes.draw_notes(
        traffic, 1, seconds, np.random.RandomState(5)), 16000,
        int(seconds * 16000), 'cpu')
    with torch.no_grad(), plain.exact_float32():
        served = program.features(CONFIG).process(
            reference.segments_of(audio, CONFIG))
        exact = reference.features(audio, CONFIG)
        rough = reference.features(audio, CONFIG, 'bf16')
    assert served.shape == exact.shape == (1, 1, 512, 512)
    assert features_error(served, exact) < limit / 10
    assert float((served - exact).abs().max()) > limit
    assert features_error(served + np.log(1.1), exact) > limit
    assert features_error(rough, exact) > 10 * limit


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """A tiny copy of the cell: 2 clips of 0.5 s (4 segments each) at the
    tiny widths."""

    path = tmp_path_factory.mktemp('mt3-cells')
    tiny.write(path, 'configs', 'mt3tiny.json',
               dict(CONFIG, name='mt3tiny', **TINY))
    tiny.write(path, 'traffic', 'piano-mt3-tiny.json',
               dict(harness.load_json('traffic', 'piano-64x60s'), batch=2,
                    pool=2, clip_seconds=0.5))
    tiny.write(path, 'workloads', 'mt3-serve-tiny.json',
               dict(harness.load_json('workloads', 'mt3-serve-bf16'),
                    config='mt3tiny', traffic='piano-mt3-tiny', capacity=12,
                    trace_items=2, limits=TINY_LIMITS))
    tiny.write(path, 'reference', 'mt3tiny.py',
               'from benchmark.reference.mt3 import *  # noqa: F401,F403\n')

    return path


def _run(root, seed=2 ** 31 + 13, trace=0):
    torch.manual_seed(0)
    result, checks = harness.run(SPEC, 'mt3-serve-tiny', seed, 0.5, trace,
                                 'cpu', time.perf_counter(), root=root)
    json.dumps(result)

    return result, checks


@pytest.mark.parametrize('trace', [0, 1])
def test_a_tiny_cpu_run_is_correct(root, trace):
    result, checks = _run(root, trace=trace)
    assert result['correct'] is True, result['checks']
    assert result['attempted'] > 0 and result['failed'] == 0
    assert result['metrics'] == {}
    assert [name for name, _, _ in checks] == [
        'features_err', 'logit_err', 'tokens_bad', 'rows_ended', 'notes_bad']


def _flip_a_token(pipeline):
    forward = pipeline.model.forward

    def flipped(feats, max_len=None):
        tokens = forward(feats, max_len)
        tokens[:, 3] = (tokens[:, 3] + 1) % 1536
        return tokens

    pipeline.model.forward = flipped


def _end_a_row(pipeline):
    forward = pipeline.model.forward

    def ended(feats, max_len=None):
        tokens = forward(feats, max_len)
        tokens[:, 5] = 1
        tokens[:, 6:] = 0
        return tokens

    pipeline.model.forward = ended


def _alter_a_note(pipeline):
    finalize = pipeline.finalize

    def altered(handle):
        return [(pitches + 1, intervals, velocities)
                for pitches, intervals, velocities in finalize(handle)]

    pipeline.finalize = altered


def _drop_a_clip(pipeline):
    finalize = pipeline.finalize
    pipeline.finalize = lambda handle: finalize(handle)[:-1]


@pytest.mark.parametrize('fault,check', [
    (_flip_a_token, 'tokens_bad'), (_end_a_row, 'rows_ended'),
    (_alter_a_note, 'notes_bad'), (_drop_a_clip, None)],
    ids=['flipped_token', 'row_ended_early', 'altered_note', 'dropped_clip'])
def test_the_faults_fail_the_check(root, monkeypatch, fault, check):
    program = harness.load_code('programs', 'mt3', root)
    serving = program.serving

    def planted(*args):
        pipeline = serving(*args)
        fault(pipeline)
        return pipeline

    monkeypatch.setattr(program, 'serving', planted)
    result, checks = _run(root)
    assert result['correct'] is False
    if check is None:
        assert result['failed'] > 0
    else:
        assert result['checks'][check]['value'] > 0, result['checks']
