"""Each plain reference against the port at a small size on the CPU (the
test imports both; the references import nothing of the port): features,
forward logits, the training loss and its gradients, the decode, and the
controls' rounding."""

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import of2, plain, tabcnn

OF2 = dict(harness.load_json('configs', 'of2'), model_complexity=2,
           lstm_units=128)
TAB = harness.load_json('configs', 'tabcnn')


def _audio(config, seconds, clips=2, seed=0):
    from benchmark.traffic import notes

    traffic = dict(harness.load_json('traffic', 'piano-128x60s'),
                   pitch_low=40, pitch_high=83)
    num = int(seconds * config['sample_rate'])
    drawn = notes.draw_notes(traffic, clips, seconds,
                             np.random.RandomState(seed))

    return notes.render(traffic, drawn, config['sample_rate'], num, 'cpu')


def _of2_model(params, dtype=None):
    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames2

    model = OnsetsFrames2(dim_in=OF2['n_mels'], profile=tools.PianoProfile(),
                          model_complexity=2, dtype=dtype)
    model.load_state_dict(params, strict=True)

    return model


def _tab_model(params, fullseq):
    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import TabCNN

    model = TabCNN(dim_in=TAB['n_bins'],
                   profile=tools.GuitarProfile(num_frets=19), fullseq=fullseq)
    model.load_state_dict(params, strict=True)

    return model


def test_mel_features_match_the_port():
    from amt_tools_tpu_torch.features import MelSpec

    audio = _audio(OF2, 2.0)
    mel = MelSpec(sample_rate=16000, hop_length=512, n_mels=229, htk=True)
    with torch.no_grad():
        got = mel.process(audio)
    want = of2.features(audio, OF2)
    assert got.shape == want.shape == (2, 1, 229, 63)
    assert float((got - want).abs().max()) < 1e-4


def test_cqt_features_match_the_port():
    from benchmark.programs import tabcnn as program

    audio = _audio(TAB, 2.0)
    with torch.no_grad():
        got = program.features(TAB).process(audio)
    want = tabcnn.features(audio, TAB)
    assert got.shape == want.shape == (2, 1, 192, 87)
    assert float((got - want).abs().max()) < 1e-4


def test_of2_forward_matches_the_port():
    params = weights.make(of2.parameters(OF2), 4, 'cpu')
    feats = of2.features(_audio(OF2, 1.0), OF2)
    model = _of2_model(params).eval()
    with torch.no_grad():
        got = model(model.pre_proc({'features': feats})['features'])
        want = of2.forward(params, feats, OF2)
    for key in want:
        scale = float(want[key].abs().max())
        assert float((got[key] - want[key]).abs().max()) < 1e-4 * scale


def test_of2_training_loss_and_gradients_match_the_port():
    from amt_tools_tpu_torch.models.common import run_on_batch

    params = weights.make(of2.parameters(OF2), 5, 'cpu')
    feats = of2.features(_audio(OF2, 1.0), OF2)
    frames = feats.shape[-1]
    rng = np.random.RandomState(0)
    maps = [of2.targets([(60, 0.1, 0.5), (64, 0.3, 0.9)], frames, OF2, 'cpu',
                        rng) for _ in range(2)]
    batch = {'features': feats,
             **{key: torch.stack([m[key] for m in maps]) for key in maps[0]}}

    model = _of2_model(params)
    got = run_on_batch(model, batch, train=True,
                       generator=torch.Generator().manual_seed(9))
    got['loss']['loss_total'].backward()

    leaves = {name: params[name].clone().requires_grad_(True)
              for name, _ in model.named_parameters()}
    want = of2.loss(dict(params, **leaves), batch, OF2, 'float32',
                    torch.Generator().manual_seed(9))
    want.backward()

    assert float(got['loss']['loss_total'].detach()) == pytest.approx(
        float(want.detach()), rel=1e-5)
    # Against the leaf's gradient or the median leaf's, whichever is
    # larger: a conv bias ahead of a train-mode norm has none to rounding
    median = float(np.median([float(leaf.grad.norm())
                              for leaf in leaves.values()]))
    for name, param in model.named_parameters():
        ref = leaves[name].grad
        assert float((param.grad - ref).norm()) <= 1e-3 * max(
            float(ref.norm()), median), name


@pytest.mark.parametrize('fullseq', [True, False])
def test_tabcnn_forward_matches_the_port(fullseq):
    params = weights.make(tabcnn.parameters(TAB), 6, 'cpu')
    feats = tabcnn.features(_audio(TAB, 0.5), TAB)
    model = _tab_model(params, fullseq).eval()
    with torch.no_grad():
        got = model(model.pre_proc({'features': feats})['features'])
        want = tabcnn.forward(params, feats, TAB)
    diff = (got['tablature'] - want['tablature']).abs().max()
    assert float(diff) < 1e-4 * float(want['tablature'].abs().max())


def test_tabcnn_training_loss_matches_the_port():
    from amt_tools_tpu_torch.models.common import run_on_batch

    params = weights.make(tabcnn.parameters(TAB), 7, 'cpu')
    feats = tabcnn.features(_audio(TAB, 0.5), TAB)
    rng = np.random.RandomState(1)
    tabs = [tabcnn.targets([(50, 0.05, 0.3)], feats.shape[-1], TAB, 'cpu',
                           rng)['tablature'] for _ in range(2)]
    batch = {'features': feats, 'tablature': torch.stack(tabs)}
    model = _tab_model(params, fullseq=False)
    got = run_on_batch(model, batch, train=True,
                       generator=torch.Generator().manual_seed(3))
    want = tabcnn.loss(params, batch, TAB, 'float32',
                       torch.Generator().manual_seed(3))
    assert float(got['loss']['loss_total'].detach()) == pytest.approx(
        float(want.detach()), rel=1e-5)


def test_piano_decode_matches_the_ports():
    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops import decode

    gen = torch.Generator().manual_seed(2)
    logits = {key: (torch.randn(40, 88, generator=gen) * 2 - 1.5).to(
        torch.bfloat16) for key in ('multi_pitch', 'onsets')}
    mp = decode.threshold(decode.sigmoid(logits['multi_pitch'].T))
    on = decode.threshold(decode.sigmoid(logits['onsets'].T))
    bufs = [b.numpy() for b in decode.notes_on_device(mp, on, capacity=1024)]
    times = np.arange(40) * 512 / 16000
    served = decode.notes_from_device(*bufs, times, tools.PianoProfile())

    want = of2.decode(logits, OF2)
    assert len(want) > 10
    assert plain.note_mismatches(of2.served(served, OF2), want) == 0


def test_tablature_decode_matches_the_ports():
    from benchmark.programs import tabcnn as program

    params = weights.make(tabcnn.parameters(TAB), 8, 'cpu')
    tabcnn_model = _tab_model(params, fullseq=True)
    gen = torch.Generator().manual_seed(4)
    logits = torch.randn(30, 126, generator=gen).to(torch.bfloat16)
    logits[:, 20::21] += 1.0  # silence often
    from amt_tools_tpu_torch.serving import TablaturePipeline

    pipeline = TablaturePipeline(tabcnn_model, program.features(TAB),
                                 device='cpu')
    tablature = tabcnn_model.tablature_out.finalize_output(logits[None])
    served = pipeline.decode_tablature(tablature,
                                       np.arange(30) * 512 / 22050)[0]
    want = tabcnn.decode({'tablature': logits}, TAB)
    assert len(want) > 5
    assert plain.note_mismatches(tabcnn.served(served, TAB), want) == 0


def test_a_changed_note_is_a_mismatch():
    notes = np.array([[60, 1, 5], [62, 3, 9]])
    assert plain.note_mismatches(notes, notes) == 0
    assert plain.note_mismatches(notes, notes[:1]) == 1
    assert plain.note_mismatches(notes + [[1, 0, 0], [0, 0, 0]], notes) == 2


@pytest.mark.parametrize('precision,bits', [('tf32', 10), ('bf16', 7)])
def test_rounding_keeps_the_mantissa_bits(precision, bits):
    x = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    rounded = plain.round_to(x, precision)
    rel = ((rounded - x).abs() / x.abs()).max()
    assert 0 < float(rel) <= 2.0 ** -(bits + 1)


def test_fp8_rounding_scales_to_the_largest_value():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    rounded = plain.round_to(x, 'fp8')
    assert float(rounded.abs().max()) == pytest.approx(float(x.abs().max()),
                                                       rel=1e-6)
    big = x.abs() > 0.1
    rel = ((rounded - x).abs() / x.abs())[big].max()
    assert 2.0 ** -6 < float(rel) <= 2.0 ** -4


def test_rounding_passes_the_gradient():
    x = torch.randn(5, requires_grad=True)
    plain.round_to(x, 'tf32').sum().backward()
    assert torch.equal(x.grad, torch.ones(5))
