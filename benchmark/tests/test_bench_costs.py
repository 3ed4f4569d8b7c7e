"""The frozen cost functions and the analytic FLOP counts, against counts
worked by hand at small shapes, and against the port's own cost functions
and ``FlopCounterMode`` of the port's models as second witnesses."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.costs import kernels, onsets_frames2, peaks, tabcnn


def test_stft_cost_by_hand():
    # 5 frames of n_fft 8: 2.5 * 8 * 3 + 8 + 3 * 5 = 83 operations each;
    # audio 16, window 8, twiddles 2 * 6, power 5 x 5 floats
    assert kernels.twiddles(8) == 6
    assert kernels.stft_cost(1, 16, 8, 4, 5) == (415.0, 244.0)


def test_lstm_costs_by_hand():
    # 6 row-steps of H = 4: 2 * 6 * 4 * 16 operations
    assert kernels.scan_cost(2, 3, 4, 2) == (768.0, 368.0)
    assert kernels.scan_cost(2, 3, 4, 2, residuals=True) == (768.0, 848.0)
    assert kernels.bptt_cost(2, 3, 4, 4) == (768.0, 1216.0)


def test_cqt_flops_by_hand():
    # Three octaves of one bin, each a 4-point real FFT (20) and 8 a bin
    assert kernels.cqt_flops_per_frame([3, 6, 12, 0]) == 84.0


def test_least_seconds_takes_the_longer_bound():
    assert kernels.least_seconds(10.0, 100.0, 1.0, 10.0) == 10.0
    assert kernels.least_seconds(30.0, 100.0, 1.0, 10.0) == 30.0
    assert kernels.least_seconds(10.0, 300.0, 1.0, 10.0) == 30.0


def test_peaks_of_the_h100():
    rates, bandwidth = peaks.peaks('NVIDIA H100 80GB HBM3')
    assert rates['bf16'] == 989e12 and rates['float32'] == 67e12
    assert bandwidth == 3.35e12
    assert peaks.peaks('cpu') is None


def test_the_copies_equal_the_ports_cost_functions():
    from amt_tools_tpu_torch.ops import cqt_kernel, lstm_kernel, stft_kernel

    assert kernels.stft_cost(3, 96000, 2048, 512, 1025) == stft_kernel.cost(
        3, 96000, 2048, 512, 1025)
    for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        for residuals in (False, True):
            assert kernels.scan_cost(8, 625, 256, size, residuals) == (
                lstm_kernel.scan_cost(8, 625, 256, dtype,
                                      residuals=residuals))
        assert kernels.bptt_cost(8, 625, 256, size) == lstm_kernel.bptt_cost(
            8, 625, 256, dtype)
    lengths = [23001, 11501, 5751, 2875, 1437, 719, 359]
    assert kernels.cqt_flops_per_frame(lengths) == (
        cqt_kernel.fft_flops_per_frame(lengths))


OF2 = dict(harness.load_json('configs', 'of2'), model_complexity=2,
           n_mels=8, num_keys=4)
TAB = dict(harness.load_json('configs', 'tabcnn'), n_bins=12)


def test_of2_forward_flops_by_hand():
    # A frame: three stacks of 4608 + 147456 + 147456 + 131072, the onset
    # and offset BiLSTMs 1310720 each, the refinement 286720, heads 10240
    per_frame = 3 * 430592 + 2 * 1310720 + 286720 + 10240
    assert per_frame == 4210176
    assert onsets_frames2.forward_flops(OF2, 2, 5) == 10 * per_frame
    assert onsets_frames2.step_flops(OF2, 2, 5) == 30 * per_frame


def test_tabcnn_flops_by_hand():
    window = 40320 + 1474560 + 1327104 + 49152 + 32256
    assert tabcnn.step_flops(TAB, 2, 5) == 3 * 10 * window
    frames = 5
    whole = (2 * 9 * 32 * 10 * (frames + 6) + 2 * 9 * 32 * 64 * 8 *
             (frames + 4) + 2 * 9 * 64 * 64 * 6 * (frames + 2) +
             frames * (49152 + 32256))
    assert tabcnn.forward_flops(TAB, 1, frames) == whole


def _counted(model, feats):
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(feats)

    return counter.get_total_flops()


def test_of2_flops_match_the_ports_counted_flops():
    """Second witness: the port's model at the small shapes, its products
    counted by ``FlopCounterMode`` (the LSTM op by its registered
    formula)."""

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames2

    profile = tools.PianoProfile()
    config = dict(OF2, num_keys=profile.get_range_len(), n_mels=16)
    model = OnsetsFrames2(dim_in=16, profile=profile, model_complexity=2)
    feats = model.pre_proc({'features': torch.rand(2, 1, 16, 5)})['features']
    counted = _counted(model.eval(), feats)
    assert counted == pytest.approx(onsets_frames2.forward_flops(config, 2, 5),
                                    rel=1e-9)


def test_tabcnn_flops_match_the_ports_counted_flops():
    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import TabCNN

    model = TabCNN(dim_in=12, profile=tools.GuitarProfile(num_frets=19),
                   fullseq=True).eval()
    feats = model.pre_proc({'features': torch.rand(1, 1, 12, 5)})['features']
    assert _counted(model, feats) == pytest.approx(
        tabcnn.forward_flops(TAB, 1, 5), rel=1e-9)


def test_cqt_lengths_are_the_references():
    from benchmark.reference import plain

    config = harness.load_json('configs', 'tabcnn')
    _, taps = plain.wavelet_bank(config)
    assert list(tabcnn.wavelet_lengths(config)) == list(taps)
    flops, num_bytes = tabcnn.features_cost(config, 1, 22050)
    assert flops > 0 and num_bytes == 4 * (22050 + 2 * taps.sum() +
                                           192 * 44)
    assert math.isclose(kernels.least_seconds(flops, num_bytes, 67e12,
                                              3.35e12),
                        num_bytes / 3.35e12)
