"""hFT-Transformer (``models/hft.py``, ``ops/attention.py``), its features
(``features.MelSpec`` with ``log_offset``) and its decode through
``serving.RegressionPipeline`` (class velocities, thresholds from the
arguments), against the tests' plain reference (``tests/hft_reference.py``,
the published per-segment inference) on the CPU.

The port runs every segment of a batch at once and stitches the outputs
back; the reference runs one clip and one segment at a time. The model is
held to it on seeded random weights at a small size (``hid_dim`` 32, 2
heads, 32 bins, margin 4, 8-frame segments, 12 notes), both output sets,
clips of whole segments, of a part segment and shorter than one segment.
"""

import math

import numpy as np
import pytest
import torch

import hft_reference as ref
import hpt_reference
from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import HFTransformer
from amt_tools_tpu_torch.models.hft import pad_segments
from amt_tools_tpu_torch.ops import attention

torch.set_num_threads(2)

SMALL = {'n_bin': 32, 'n_margin': 4, 'n_frame': 8, 'cnn_channel': 4,
         'cnn_kernel': 5, 'hid_dim': 32, 'n_layers': 2, 'n_heads': 2,
         'pf_dim': 64, 'n_note': 12, 'n_velocity': 16,
         'pad_value': math.log(1e-8)}
FEATURES = {'sample_rate': 16000, 'n_fft': 2048, 'hop_length': 256,
            'fmin': 0.0, 'fmax': 8000.0, 'log_offset': 1e-8}
DECODE = {'onset_threshold': 0.5, 'offset_threshold': 0.5,
          'frame_threshold': 0.5, 'lowest_key': 60}


def _model(config=SMALL, dtype=None, seed=1):
    """The port's model at ``config``'s widths, its LayerNorms' weights and
    biases drawn too (the default init leaves them 1 and 0)."""

    keys = {k: v for k, v in config.items() if k != 'n_note'}
    model = HFTransformer(profile=tools.PianoProfile(60, 59 + config['n_note']),
                          dtype=dtype, generator=torch.Generator()
                          .manual_seed(seed), **keys).eval()
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, value in model.named_parameters():
            if 'layer_norm' in name:
                value.add_(0.1 * torch.randn(value.shape, generator=g))

    return model


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _feats(clips, frames, seed=2):
    """Log-mel-like features: silence at the pad value, louder bins above."""

    g = torch.Generator().manual_seed(seed)
    x = -18.0 + 6.0 * torch.rand(clips, 1, SMALL['n_bin'], frames,
                                 generator=g)
    return x + 10.0 * (torch.rand(x.shape, generator=g) < 0.1)


def test_state_dict_names_are_the_published_ones():
    model = HFTransformer()
    names = list(model.state_dict())
    for name in ['encoder_spec2midi.conv.weight',
                 'encoder_spec2midi.tok_embedding_freq.bias',
                 'encoder_spec2midi.pos_embedding_freq.weight',
                 'encoder_spec2midi.layers_freq.2.layer_norm.weight',
                 'encoder_spec2midi.layers_freq.0.self_attention.fc_q.weight',
                 'encoder_spec2midi.layers_freq.1.positionwise_feedforward.'
                 'fc_2.bias',
                 'decoder_spec2midi.pos_embedding_freq.weight',
                 'decoder_spec2midi.layer_zero_freq.encoder_attention.fc_k.'
                 'weight',
                 'decoder_spec2midi.layers_freq.1.self_attention.fc_o.bias',
                 'decoder_spec2midi.layers_freq.0.encoder_attention.fc_v.bias',
                 'decoder_spec2midi.fc_onset_freq.weight',
                 'decoder_spec2midi.fc_velocity_freq.bias',
                 'decoder_spec2midi.pos_embedding_time.weight',
                 'decoder_spec2midi.layers_time.2.positionwise_feedforward.'
                 'fc_1.weight',
                 'decoder_spec2midi.fc_mpe_time.weight',
                 'decoder_spec2midi.fc_velocity_time.weight']:
        assert name in names
    assert not any('layer_zero_freq.self_attention' in n for n in names)
    assert len(names) == 165
    # About 5.5 M parameters at the published widths
    assert 5.5e6 < sum(v.numel() for v in model.parameters()) < 5.53e6
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes['encoder_spec2midi.conv.weight'] == (4, 1, 1, 5)
    assert shapes['encoder_spec2midi.tok_embedding_freq.weight'] == (256, 244)
    assert shapes['decoder_spec2midi.fc_velocity_time.weight'] == (128, 256)


def test_published_names_load_strictly():
    """A state dict under the published names, as another copy of the
    model gives it, loads with ``strict=True`` and gives that copy's
    outputs."""

    source, target = _model(seed=3), _model(seed=4)
    target.load_state_dict(dict(source.state_dict()), strict=True)
    feats = _feats(1, 12)
    with torch.no_grad():
        want, got = source(feats), target(feats)
    for key in want:
        assert torch.equal(got[key], want[key])
    with pytest.raises(RuntimeError):
        renamed = {k.replace('layers_time', 'time_layers'): v
                   for k, v in source.state_dict().items()}
        target.load_state_dict(renamed, strict=True)


def _mel(n_mels):
    return MelSpec(hop_length=256, n_mels=n_mels, htk=True, fmin=0.0,
                   fmax=8000.0, log_offset=1e-8)


@pytest.mark.parametrize('n_mels', [32, 256])
def test_features_match_the_reference(n_mels):
    """The natural log of mel + 1e-8 on the HTK scale with Slaney's area
    norm, 0 Hz to 8 kHz (torchaudio's ``MelSpectrogram(mel_scale='htk',
    norm='slaney')``). Tolerances: 1e-4 where the reference reads above -5
    (float32 rounding of the log of a loud bin), 1e-2 everywhere. Kernel
    A's plain framed product and the reference's rfft round the power
    apart by about 1e-7 of the frame's energy; in a bin whose power is
    about the offset, 1e-8, that gap is a share of the whole, and its log
    moves by up to 6e-3 (256 bins; 2e-3 at 32). Silence reads log(1e-8) in
    both."""

    g = torch.Generator().manual_seed(5)
    t = torch.arange(8000) / 16000.0
    audio = torch.stack([0.2 * torch.sin(2 * np.pi * 440.0 * t),
                         0.05 * torch.randn(8000, generator=g)])
    audio[:, 5000:] = 0.0
    config = dict(FEATURES, n_bin=n_mels)
    with torch.no_grad():
        got = _mel(n_mels).process(audio)
        want = ref.features(audio, config)
    assert got.shape == want.shape == (2, 1, n_mels, 32)
    gap = (got - want).abs()
    assert float(gap.max()) < 1e-2
    assert float(gap[want > -5.0].max()) < 1e-4
    assert float(want.min()) == pytest.approx(math.log(1e-8))
    assert float(got[..., -5:].max()) == pytest.approx(math.log(1e-8))


def test_mel_bank_is_htk_with_slaney_norm():
    from amt_tools_tpu_torch.ops import spectral

    bank = spectral.mel_filterbank(16000, 2048, 256, fmin=0.0, fmax=8000.0,
                                   htk=True)
    assert np.allclose(bank, ref.mel_bank(16000, 2048, 256, 0.0, 8000.0),
                       rtol=1e-6, atol=1e-9)


def test_one_log_scale_at_a_time():
    with pytest.raises(ValueError):
        MelSpec(absolute_db=True, log_offset=1e-8)


@pytest.mark.parametrize('frames', [16, 21, 5],
                         ids=['whole segments', 'a part segment',
                              'shorter than a segment'])
def test_eval_forward_matches_the_reference(frames):
    """Both output sets, every segmenting case, float32. Tolerance 2e-5 of
    each head's largest logit: the same float32 products, batched over
    segments and with the four heads fused into one product, sum in
    another order; two layers of 2 heads over 32 bins move a logit by a
    few float32 ulps of the LayerNorm outputs feeding it."""

    model = _model()
    feats = _feats(2, frames)
    with torch.no_grad(), hpt_reference.exact_float32():
        got = model(feats, freq_heads=True)
        want_a, want_b = ref.forward(_params(model), feats, SMALL)
    for suffix, want in (('_freq', want_a), ('', want_b)):
        for key, value in want.items():
            mine = got[key + suffix]
            assert mine.shape == value.shape
            assert value.shape[:3] == (2, frames, SMALL['n_note'])
            gap = float((mine - value).abs().max())
            assert gap < 2e-5 * float(value.abs().max()), (key + suffix, gap)
    assert set(got) == {key + suffix for key in want_b
                        for suffix in ('', '_freq')}


def test_the_serving_forward_skips_heads_a():
    model = _model()
    with torch.no_grad():
        got = model(_feats(1, 9))
    assert set(got) == {'frame', 'reg_onset', 'reg_offset', 'velocity'}


def test_bf16_forward_matches_the_reference():
    """bf16 products and activations with float32 LayerNorm statistics:
    each head's RMS gap under 3% of the reference logits' spread. Every
    product reads bf16 operands and every activation rounds to bf16 (2^-9
    relative) once a layer; four LayerNorms and the attention's softmax
    carry that to the logits as about 1% of their spread."""

    model = _model(dtype=torch.bfloat16)
    feats = _feats(2, 21)
    with torch.no_grad(), hpt_reference.exact_float32():
        got = model(feats)
        _, want = ref.forward(_params(model), feats, SMALL)
    for key, value in want.items():
        assert got[key].dtype == torch.bfloat16
        rms = float((got[key].float() - value).pow(2).mean().sqrt())
        assert rms < 0.03 * float(value.std()), key


def test_counters_of_a_forward():
    """11 attention calls a forward at the published depth of 3 (3
    frequency self, 3 cross, 2 pitch self, 3 time self), all on the plain
    route on the CPU; the segments and their padded frames."""

    model = _model(dict(SMALL, n_layers=3))
    before = {k: getattr(attention.attention, k)
              for k in attention.KINDS + ('plain',)}
    segments, padded = pad_segments.segments, pad_segments.padded_frames
    with torch.no_grad():
        model(_feats(3, 21))
    calls = {k: getattr(attention.attention, k) - before[k] for k in before}
    assert calls == {'frequency_self': 3, 'cross': 3, 'pitch_self': 2,
                     'time_self': 3, 'plain': 11}
    assert pad_segments.segments - segments == 3 * 3
    assert pad_segments.padded_frames - padded == 3 * 3


def test_the_cells_clip_makes_30_segments():
    """A 60 s clip at 62.5 frames a second: 3,751 frames, 30 segments of
    128, 89 frames of padding."""

    mel = MelSpec(hop_length=256, n_mels=256, htk=True, fmax=8000.0,
                  log_offset=1e-8)
    frames = len(mel.get_times(np.zeros(960000, dtype=np.float32)))
    assert frames == 3751
    feats = torch.zeros(2, 256, frames)
    segments, padded = pad_segments.segments, pad_segments.padded_frames
    out, count = pad_segments(feats, 128, 32, math.log(1e-8))
    assert count == 30 and out.shape == (2, 256, 32 + 30 * 128 + 32)
    assert pad_segments.segments - segments == 60
    assert pad_segments.padded_frames - padded == 2 * 89
    assert float(out[..., :32].max()) == float(out[..., -121:].min()) == (
        pytest.approx(math.log(1e-8)))


def test_attention_checks_its_kind():
    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError):
        attention.attention(q, q, q, 'sideways')


def test_the_plain_attention_is_the_published_product():
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(3, 2, n, 8, generator=g) for n in (5, 7, 7))
    want = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(8), -1) @ v
    got = attention.attention(q, k, v, 'cross')
    assert torch.allclose(got, want, atol=1e-6)


def _class_rows(logits, config):
    """The loop decode (``hpt_reference.decode``) of one clip's logits:
    sigmoid curves and the argmax velocity class."""

    curves = {key: torch.sigmoid(logits[key]).float().numpy()
              for key in ('frame', 'reg_onset', 'reg_offset')}
    curves['velocity'] = logits['velocity'].argmax(-1).float().numpy()

    return hpt_reference.decode(curves, config, velocity_scale=1)


@pytest.mark.parametrize('dtype', [None, torch.bfloat16])
def test_the_pipeline_serves_class_velocities(dtype):
    """``RegressionPipeline`` over the model at thresholds of 0.5: the
    served notes are the loop decode of the logits the pipeline's forward
    gave, velocities the argmax class."""

    from amt_tools_tpu_torch.serving import RegressionPipeline

    model = _model(dtype=dtype)
    decoder = model.decoder_spec2midi
    with torch.no_grad():
        # Sharp onset and offset curves around a low level, notes held
        for head, bias in (('onset', -3.0), ('offset', -3.0), ('mpe', 0.5)):
            layer = getattr(decoder, f'fc_{head}_time')
            layer.weight *= 30.0
            layer.bias.fill_(bias)
    pipeline = RegressionPipeline(model, _mel(SMALL['n_bin']), capacity=256,
                                  device='cpu', onset_threshold=0.5,
                                  offset_threshold=0.5, frame_threshold=0.5)
    raw = {}
    pipeline.model.register_forward_hook(lambda m, a, out: raw.update(out))
    audio = 0.1 * torch.randn(2, 6000, generator=torch.Generator()
                              .manual_seed(7))
    served = pipeline(audio)

    hop = 256 / 16000
    total = 0
    for b, clip in enumerate(served):
        want = _class_rows({k: v[b] for k, v in raw.items()}, DECODE)
        pitches, intervals, velocities = clip
        got = sorted((int(p), int(np.rint(on / hop)), int(np.rint(off / hop)),
                      int(v)) for p, (on, off), v in zip(pitches, intervals,
                                                        velocities))
        assert got == [(r[0], r[1], r[3], r[5]) for r in want]
        assert all(0 <= v < SMALL['n_velocity'] for v in velocities)
        total += len(want)
    assert total > 0 and pipeline.notes_decoded == total


def test_class_velocities_are_the_argmax_class():
    """A hand-built clip: one key's onset peak at frame 5 with class 93
    the largest logit there, and class 7 everywhere else."""

    from amt_tools_tpu_torch.ops import decode

    frames, keys, classes = 20, 3, 128
    onset = torch.full((1, keys, frames), 0.01)
    onset[0, 1, 3:8] = torch.tensor([0.2, 0.6, 0.9, 0.6, 0.2])
    frame = torch.zeros(1, keys, frames)
    frame[0, 1, 5:12] = 0.9
    logits = torch.zeros(1, frames, keys, classes)
    logits[..., 7] = 1.0
    logits[0, 5, 1, 93] = 2.0
    levels = logits.argmax(-1).float().transpose(-1, -2)
    arrays = [a.numpy() for a in decode.regression_events_on_device(
        frame, onset, torch.zeros_like(onset), levels, 8,
        onset_threshold=0.5, offset_threshold=0.5, frame_threshold=0.5)]
    pitches, intervals, velocities = decode.regression_notes_from_device(
        *(a[0] for a in arrays), num_frames=frames, frame_seconds=1.0,
        low=60, velocity_scale=1)
    assert pitches.tolist() == [61.0] and velocities.tolist() == [93]
    assert np.rint(intervals).tolist() == [[5.0, 12.0]]


def test_the_benchmark_reference_matches_this_one():
    """``benchmark/reference/hft.py`` (blocks of segments, every segment of
    a block at once) against this file's loop over segments, on one
    input: float32 rounding (2e-5 of each head's largest logit, as
    above)."""

    from benchmark.reference import hft as bench_ref

    config = dict(SMALL, num_keys=SMALL['n_note'])
    model = _model()
    feats = _feats(2, 21)
    with torch.no_grad(), hpt_reference.exact_float32():
        got = bench_ref.forward(_params(model), feats, config, block=2)
        _, want = ref.forward(_params(model), feats, SMALL)
    for key, value in want.items():
        gap = float((got[key] - value).abs().max())
        assert gap < 2e-5 * float(value.abs().max()), key
