"""The High-resolution Piano Transcription note model
(``models/hpt.py``), its features (``features.MelSpec`` with ``fmin``,
``fmax``, ``absolute_db`` and ``pad_mode='reflect'``) and the benchmark's
copy of the plain reference, against the tests' plain reference
(``tests/hpt_reference.py``), on the CPU.

The model's eval forward is held to the reference on seeded random weights
at the published widths (a few frames, 2 clips), every head compared, in
float32 to float32 rounding and in bf16 to bf16's; the features to float32
rounding of the dB values; the benchmark's reference (``benchmark/
reference/hpt.py``) to this one on one input. The model groups its ten
BiGRUs into four calls of kernel G's op a forward.
"""

import numpy as np
import pytest
import torch

import hpt_reference as ref
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import RegressCRNN
from amt_tools_tpu_torch.ops import gru as gru_layers
from amt_tools_tpu_torch.ops import gru_kernel

torch.set_num_threads(2)

CONFIG = {'sample_rate': 16000, 'n_fft': 2048, 'hop_length': 160,
          'n_mels': 229, 'fmin': 30, 'fmax': 8000, 'onset_threshold': 0.3,
          'offset_threshold': 0.3, 'frame_threshold': 0.1, 'lowest_key': 21}


def _state(seed=1):
    """The model's seeded initial weights with random norm statistics (bn0's
    at the scale of dB features), as the published names give them."""

    model = RegressCRNN(generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    state = {}
    for name, value in model.state_dict().items():
        if name.startswith('bn0.running_mean'):
            value = -40.0 + 5.0 * torch.randn(value.shape, generator=g)
        elif name.startswith('bn0.running_var'):
            value = 300.0 + 100.0 * torch.rand(value.shape, generator=g)
        elif name.endswith('running_mean'):
            value = 0.1 * torch.randn(value.shape, generator=g)
        elif name.endswith('running_var'):
            value = 0.5 + torch.rand(value.shape, generator=g)
        elif name.endswith('.weight') and value.dim() == 1:
            value = 1.0 + 0.1 * torch.randn(value.shape, generator=g)
        elif 'fc.bias' in name or name.endswith('.bias'):
            value = value + 0.05 * torch.randn(value.shape, generator=g)
        state[name] = value.clone()

    return state


def _audio(clips=2, samples=1600, seed=2):
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(samples) / 16000.0
    tones = torch.stack([0.2 * torch.sin(2 * np.pi * f * t) for f in
                         (220.0, 523.3)[:clips]])
    return tones + 0.01 * torch.randn(clips, samples, generator=g)


def _mel():
    return MelSpec(hop_length=160, fmin=30, fmax=8000, absolute_db=True,
                   pad_mode='reflect')


def test_state_dict_names_are_the_published_ones():
    names = list(RegressCRNN().state_dict())
    for name in ['bn0.running_var', 'frame_model.conv_block1.conv1.weight',
                 'reg_onset_model.conv_block4.bn2.running_mean',
                 'reg_offset_model.fc5.weight', 'velocity_model.bn5.bias',
                 'frame_model.gru.weight_hh_l1_reverse',
                 'velocity_model.fc.bias', 'reg_onset_gru.bias_ih_l0',
                 'reg_onset_fc.weight', 'frame_gru.weight_ih_l0_reverse',
                 'frame_fc.bias']:
        assert name in names
    assert not any(n.endswith('num_batches_tracked') or
                   n.endswith('conv1.bias') or n.endswith('fc5.bias')
                   for n in names)
    # 20.2 M parameters, the published model's
    count = sum(v.numel() for v in RegressCRNN().parameters())
    assert 20.1e6 < count < 20.3e6


def test_features_match_the_reference():
    audio = _audio(samples=8000)
    audio[:, 4000:] = 0.0
    with torch.no_grad():
        got = _mel().process(audio)
        want = ref.features(audio, CONFIG)
    assert got.shape == want.shape == (2, 1, 229, 51)
    assert float((got - want).abs().max()) < 2e-3
    # Absolute dB: no per-clip reference and no floor under the maximum,
    # only the 1e-10 power floor at -100 dB, which the silence reaches
    assert float(want.max()) > 0.0 and float(want.min()) == -100.0
    assert torch.equal(got[..., -5:], want[..., -5:])


def test_mel_bank_spans_fmin_to_fmax():
    from amt_tools_tpu_torch.ops import spectral

    bank = spectral.mel_filterbank(16000, 2048, 229, fmin=30, fmax=8000)
    assert np.allclose(bank, ref.mel_bank(16000, 2048, 229, 30, 8000),
                       rtol=1e-6, atol=1e-9)
    bins = np.linspace(0, 8000, 1025)
    assert bins[np.nonzero(bank[0])[0][0]] > 30.0


@pytest.mark.parametrize('dtype, tolerance', [(None, 2e-6), (torch.bfloat16,
                                                             6e-2)])
def test_eval_forward_matches_the_reference(dtype, tolerance):
    """Every head at the published widths over 11 frames of 2 clips. bf16:
    the features round to bf16 once and every product reads bf16
    operands, so the logits move by a few bf16 ulps of their spread."""

    state = _state()
    model = RegressCRNN(dtype=dtype).eval()
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        feats = ref.features(_audio(), CONFIG)
        got = model(feats)
        want = ref.forward(state, feats)
    assert list(got) == list(ref.HEADS)
    for key in ref.HEADS:
        assert got[key].shape == want[key].shape == (2, 11, 88)
        spread = float(want[key].std())
        assert float((got[key].float() - want[key]).abs().max()) <= (
            tolerance * max(spread, float(want[key].abs().max())))


def test_the_forward_groups_its_gru_layers(monkeypatch):
    """Ten BiGRUs, four calls of kernel G's op: the stacks' first layers
    (8 directions), their second layers, then the onset and the frame
    conditioning (2 each)."""

    groups = []

    def spy(xw, w_h, b_hn, reverse_from):
        groups.append((xw.shape[0], reverse_from))
        return gru_kernel.gru_scan_grouped(xw, w_h, b_hn, reverse_from)

    monkeypatch.setattr(gru_layers, 'gru_scan_grouped', spy)
    model = RegressCRNN(dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        model(torch.randn(1, 1, 229, 5))
    assert groups == [(8, 4), (8, 4), (2, 1), (2, 1)]


def test_train_forward_runs_and_differentiates():
    model = RegressCRNN().train()
    out = model(torch.randn(2, 1, 229, 6),
                generator=torch.Generator().manual_seed(0))
    sum(v.square().mean() for v in out.values()).backward()
    assert model.frame_model.conv_block1.conv1.weight.grad is not None
    assert model.reg_onset_gru.weight_hh_l0.grad.abs().sum() > 0
    assert float(model.bn0.running_mean.abs().sum()) > 0


def test_benchmark_reference_matches_the_tests_reference():
    """The benchmark's copy (features, float32 forward and decode) gives
    this reference's numbers on one input."""

    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import harness
    from benchmark.reference import hpt, plain

    config = harness.load_json('configs', 'hpt')
    state = _state(seed=3)
    audio = _audio(samples=2400)
    with torch.no_grad(), plain.exact_float32():
        feats = hpt.features(audio, config)
        assert torch.allclose(feats, ref.features(audio, CONFIG), rtol=0,
                              atol=1e-4)
        got = hpt.forward(state, feats, config)
        want = ref.forward(state, feats)
    for key in ref.HEADS:
        assert torch.allclose(got[key], want[key], rtol=1e-5, atol=1e-6)

    curves = {key: torch.sigmoid(want[key][0]).numpy() for key in ref.HEADS}
    rows = [(r[0], r[1], r[3], r[5]) for r in ref.decode(curves, CONFIG)]
    held = hpt.decode({key: want[key][0] for key in ref.HEADS}, config)
    assert sorted(tuple(r) for r in held.tolist()) == sorted(rows)
    assert rows
    assert {name for name, _, _ in hpt.parameters(config)} == set(state)
