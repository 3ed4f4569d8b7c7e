"""MT3's piano transcriber on a card: the bf16 encode and a cached greedy
decode at the cell's row count against the float32 reference, the fused
attention route and its counters, ``Seq2SeqPipeline`` end to end, and
the paths hFT-Transformer and High-resolution Piano Transcription share
with it (``ops/attention.py``, ``features/mel.py``) computing what they
computed before those files took MT3's options.

Every test here needs a CUDA device and skips without one; like
``tests/test_torch_cuda.py`` it imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mt3.py

Tolerances:
- the bf16 step logits at the cell's 960 rows against the float32
  reference (``tests/mt3_reference.py``, teacher forced over the served
  tokens, no cache, TF32 off) on 8 of the rows: RMS gap under 0.05 of the
  reference logits' spread. bf16 products, activations, keys and values
  through 8 + 8 pre-norm layers move the logits by a few percent of their
  spread;
- the encoder output of those rows: RMS gap under 0.05 of its spread, for
  the same reason;
- served tokens against the argmax of the served logits, and notes
  against the reference decode of the served tokens: equal;
- the shared paths: bit for bit.
"""

import numpy as np
import pytest
import torch

import mt3_reference as ref
from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import Seq2SeqTranscriber
from amt_tools_tpu_torch.ops import attention, stft_kernel
from amt_tools_tpu_torch.serving import Seq2SeqPipeline
from amt_tools_tpu_torch.tools import event_codec as codec

pytestmark = pytest.mark.cuda

FEATURES = {'sample_rate': 16000, 'n_fft': 2048, 'hop_length': 128,
            'n_mels': 512, 'fmin': 20.0, 'fmax': 7600.0, 'log_floor': 1e-5,
            'input_length': 512, 'num_heads': 6, 'num_encoder_layers': 8,
            'num_decoder_layers': 8}
# The fused kernels' names in a trace: flash, memory-efficient, cuDNN
ATTENTION_KERNELS = ('flash_fwd', 'fmha_cutlass', 'sdpa')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the fused attention kernels)')
    with tools.exact_fp32():
        yield torch.device('cuda')


def _model(device, seed=1):
    """The published widths in bf16, RMS scales drawn near 1, EOS's logit
    0 (the cell's calibration: every row decodes to the cap)."""

    model = Seq2SeqTranscriber(dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, value in model.named_parameters():
            if name.endswith('norm.weight'):
                value.add_(0.1 * torch.randn(value.shape, generator=g))
        model.decoder.logits_dense.weight[codec.EOS] = 0.0

    return model.to(device).eval()


def _mel():
    return MelSpec(sample_rate=16000, hop_length=128, n_mels=512, n_fft=2048,
                   center=False, pad_end=True, magnitude=True,
                   filterbank='tf', fmin=20.0, fmax=7600.0, log_floor=1e-5)


def _feats(rows, device, seed=2):
    g = torch.Generator(device=device).manual_seed(seed)
    return -8.0 + 6.0 * torch.rand(rows, 1, 512, 512, generator=g,
                                   device=device)


def _gap(got, want):
    return float((got.float() - want).pow(2).mean().sqrt() / want.std())


def test_encode_and_generate_at_the_cells_rows(cuda):
    """960 rows, 64 greedy steps: the step logits of 8 rows against the
    reference's teacher-forced forward over their tokens."""

    model = _model(cuda)
    feats = _feats(960, cuda)
    rows = torch.tensor([0, 101, 202, 333, 404, 555, 777, 959], device=cuda)
    steps = []
    model.decoder.logits_dense.register_forward_hook(
        lambda module, args, out: steps.append(out.index_select(0, rows)))
    with torch.inference_mode():
        encoded = model.encode(feats)
        tokens = model.generate(encoded, 64)
    assert tokens.shape == (960, 64)
    assert not bool((tokens == codec.EOS).any())
    steps = torch.stack(steps, dim=1)
    assert torch.equal(tokens[rows], steps.argmax(-1))

    params = {k: v.detach().float() for k, v in model.state_dict().items()}
    with torch.no_grad(), ref.exact_float32():
        want_encoded = ref.encode(params, feats[rows], FEATURES)
        want = ref.logits(params, want_encoded, tokens[rows], FEATURES)
    assert _gap(encoded[0][rows], want_encoded) < 0.05
    assert _gap(steps, want) < 0.05


def test_fewer_rows_replay_the_kept_graphs(cuda):
    """The serving call at 960 rows captures the step graphs; a decode of
    333 of its rows' keys and values replays them, the other rows padding,
    and gives those rows' tokens bit for bit: the graphs compute each row
    on its own."""

    model = _model(cuda)
    feats = _feats(960, cuda)
    with torch.inference_mode():
        tokens = model(feats, 16)
        kept = model.decoder._kept
        _, kv = model.encode(feats)
        fewer = model.generate((None, kv[300:633]), 16)
    assert model.decoder._kept is kept and kept.rows == 960
    assert fewer.shape == (333, 16)
    assert torch.equal(fewer, tokens[300:633])


def _counts():
    return {k: getattr(attention.attention, k)
            for k in attention.KINDS + ('plain',)}


def test_counters_and_no_math_backend(cuda):
    """A forward of 6 steps: 8 encoder self-attentions, 8 self- and 8
    cross-attentions a step, each one fused kernel; no softmax kernel."""

    model = _model(cuda)
    feats = _feats(64, cuda)
    with torch.inference_mode():
        model(feats, 6)
        torch.cuda.synchronize()
        before = _counts()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            tokens = model(feats, 6)
            torch.cuda.synchronize()
    after = _counts()
    assert tokens.shape == (64, 6)
    assert {k: after[k] - before[k] for k in before} == {
        'frequency_self': 0, 'cross': 0, 'pitch_self': 0, 'time_self': 0,
        'encoder_self': 8, 'decoder_self': 48, 'decoder_cross': 48,
        'plain': 0}
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    fused = [n for n in names if any(k in n for k in ATTENTION_KERNELS)]
    assert len(fused) == 8 + 2 * 8 * 6, sorted(set(names))
    assert not any('softmax' in n.lower() for n in names)


def test_the_pipeline_serves_the_decode_of_its_tokens(cuda):
    """Two clips of 10 s (3 segments each, the last padded), 48 tokens a
    segment: the served notes are the reference decode of the served
    tokens, segment by segment from each segment's start."""

    model = _model(cuda)
    pipeline = Seq2SeqPipeline(model, _mel(), capacity=48, device=cuda)
    kept = []
    model.register_forward_hook(lambda m, a, out: kept.append(out.cpu()))
    g = torch.Generator(device=cuda).manual_seed(7)
    audio = 0.1 * torch.randn(2, 160000, generator=g, device=cuda)
    served = pipeline(audio)
    tokens, = kept
    assert tokens.shape == (6, 48) and pipeline.segments == 6
    assert (pipeline.decode_steps, pipeline.rows_ended) == (48, 0)
    invalid = 0
    for c, (pitches, intervals, velocities) in enumerate(served):
        want = []
        for s in range(3):
            found, bad = ref.decode_segment(tokens[3 * c + s], s * 4.096,
                                            4.096)
            want += found
            invalid += bad
        assert sorted(zip(pitches.tolist(), intervals[:, 0].tolist(),
                          intervals[:, 1].tolist(),
                          velocities.tolist())) == sorted(want)
    assert pipeline.tokens_invalid == invalid


def test_the_features_match_the_reference(cuda):
    """Kernel A on frames padded at the end, the magnitude, TensorFlow's
    bank and the floored log against the reference's rfft: within 0.05
    (the log of the quietest unfloored bins, where the two FFTs' float32
    rounding differs)."""

    g = torch.Generator(device=cuda).manual_seed(5)
    t = torch.arange(100000, device=cuda) / 16000.0
    audio = (0.2 * torch.sin(2 * np.pi * 440.0 * t) +
             0.01 * torch.randn(2, 100000, generator=g, device=cuda))
    size = 512 * 128
    segments = torch.nn.functional.pad(audio, (0, 2 * size - 100000)).view(
        -1, size)
    with torch.inference_mode():
        got = _mel().process(segments)
    with ref.exact_float32():
        want = ref.features(audio, FEATURES)
    assert got.shape == want.shape == (4, 1, 512, 512)
    assert float((got - want).abs().max()) < 0.05


def test_hft_attention_is_the_unscaled_call(cuda):
    """hFT's calls (no scale, no mask) are ``scaled_dot_product_attention``
    with its defaults under the three fused backends, bit for bit, as
    before the scale and the mask became arguments."""

    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(480, 4, 128, 64, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    with torch.inference_mode():
        got = attention.attention(q, k, v, 'time_self')
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            want = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    assert torch.equal(got, want)


@pytest.mark.parametrize('options', [
    {'hop_length': 160, 'fmin': 30, 'fmax': 8000, 'absolute_db': True,
     'pad_mode': 'reflect'},
    {'hop_length': 256, 'n_mels': 256, 'htk': True, 'fmax': 8000,
     'log_offset': 1e-8}], ids=['hpt', 'hft'])
def test_the_other_mels_are_unchanged(cuda, options):
    """HPT's and hFT's features: kernel A's power, the Slaney bank's
    product and their scale, each step as before MT3's options, bit for
    bit."""

    mel = MelSpec(**options)
    g = torch.Generator(device=cuda).manual_seed(6)
    audio = 0.1 * torch.randn(3, 96000, generator=g, device=cuda)
    with torch.inference_mode():
        got = mel.process(audio)
        flat = audio
        if options.get('pad_mode') == 'reflect':
            flat = torch.nn.functional.pad(audio, (1024, 1024),
                                           mode='reflect')
        power = stft_kernel.stft_power(
            flat.contiguous(), mel._bank(audio.device), 2048,
            options['hop_length'], center='pad_mode' not in options)
        fb = torch.from_numpy(mel._mel_fb).to(audio.device)
        want = mel.post_proc(torch.matmul(fb, power))
    assert torch.equal(got, want)
