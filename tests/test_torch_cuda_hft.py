"""hFT-Transformer on a card: the bf16 forward at the cell's shapes against
the float32 reference, the fused attention route and its counters, the
add-and-norm kernel (``ops/add_layer_norm.py``) at the cell's shapes and on
the forward's route, and ``RegressionPipeline`` over it and over the
High-resolution model.

Every test here needs a CUDA device and skips without one; like
``tests/test_torch_cuda.py`` it imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_hft.py

Tolerances:
- the bf16 forward at the cell's shapes (16 clips of 3,751 frames, 480
  segments) against the float32 reference (``tests/hft_reference.py``,
  one segment at a time, TF32 off) on two of the clips: every head's RMS
  gap under 0.05 of the reference logits' spread. bf16 products, one bf16
  rounding of each activation, the fused kernels' bf16 softmax weights
  and 9 post-LN layers move the logits by a few percent of their spread;
  the benchmark's control (fp8 products) moves them by far more;
- the fused route in chunks against the plain product in float32: 2e-2
  (bf16 operands, weights and output);
- the served notes against the loop decode of the served logits: equal;
- the add-and-norm kernel against its plain version (PyTorch's add and
  ``F.layer_norm``) at the cell's row shapes: float32 within 1e-6 of the
  row's largest output (both take float32 statistics, in another order of
  sums); bf16 within that and one bf16 ulp of each output (the sum keeps
  its bits, and each output rounds once a float32 value that lies as far
  from the plain version's as a float32 output does: near zero that gap
  is many ulps of the output, hence the 1e-6 term).
"""

import collections
import math

import numpy as np
import pytest
import torch

import hft_reference as ref
import hpt_reference
from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import HFTransformer, RegressCRNN
from amt_tools_tpu_torch.models.hft import pad_segments
from amt_tools_tpu_torch.ops import add_layer_norm as aln
from amt_tools_tpu_torch.ops import attention, decode
from amt_tools_tpu_torch.serving import RegressionPipeline

pytestmark = pytest.mark.cuda

PUBLISHED = {'n_bin': 256, 'n_margin': 32, 'n_frame': 128, 'hid_dim': 256,
             'n_layers': 3, 'n_heads': 4, 'n_note': 88,
             'pad_value': math.log(1e-8)}
# The fused kernels' names in a trace: flash, memory-efficient, cuDNN
ATTENTION_KERNELS = ('flash_fwd', 'fmha_cutlass', 'sdpa')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the fused attention kernels)')
    with tools.exact_fp32():
        yield torch.device('cuda')


def _model(device, dtype=torch.bfloat16, seed=1):
    model = HFTransformer(dtype=dtype,
                          generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, value in model.named_parameters():
            if 'layer_norm' in name:
                value.add_(0.1 * torch.randn(value.shape, generator=g))

    return model.to(device).eval()


def _feats(clips, frames, device, seed=2):
    g = torch.Generator(device=device).manual_seed(seed)
    x = -18.0 + 6.0 * torch.rand(clips, 1, 256, frames, generator=g,
                                 device=device)
    return x + 10.0 * (torch.rand(x.shape, generator=g, device=device) < 0.1)


def _counts():
    return ({k: getattr(attention.attention, k)
             for k in attention.KINDS + ('plain',)},
            pad_segments.segments, pad_segments.padded_frames)


def test_bf16_forward_at_the_cells_shapes(cuda):
    model = _model(cuda)
    feats = _feats(16, 3751, cuda)
    (calls, segments, padded) = _counts()
    norms = aln.add_layer_norm.fused, aln.add_layer_norm.plain
    with torch.inference_mode():
        got = model(feats)
    after, segments_after, padded_after = _counts()
    assert {k: after[k] - calls[k] for k in calls} == {
        'frequency_self': 3, 'cross': 3, 'pitch_self': 2, 'time_self': 3,
        'encoder_self': 0, 'decoder_self': 0, 'decoder_cross': 0,
        'plain': 0}
    assert (aln.add_layer_norm.fused - norms[0],
            aln.add_layer_norm.plain - norms[1]) == (20, 0)
    assert segments_after - segments == 480
    assert padded_after - padded == 16 * 89
    assert got['velocity'].shape == (16, 3751, 88, 128)

    params = {k: v.detach().float() for k, v in model.state_dict().items()}
    with torch.no_grad(), hpt_reference.exact_float32():
        _, want = ref.forward(params, feats[[3, 12]], PUBLISHED)
    for key, value in want.items():
        gap = (got[key][[3, 12]].float() - value).pow(2).mean().sqrt()
        assert float(gap) < 0.05 * float(value.std()), key


def test_the_math_backend_never_runs(cuda):
    """Every attention of a forward is one fused kernel: 11 a forward, no
    softmax kernel and no batched product of the scores."""

    model = _model(cuda)
    feats = _feats(2, 300, cuda)
    with torch.inference_mode():
        model(feats)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            model(feats)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    fused = [n for n in names if any(k in n for k in ATTENTION_KERNELS)]
    assert len(fused) == 11, sorted(set(names))
    assert not any('softmax' in n.lower() for n in names)


def _kernel_names(model, feats):
    """The device kernels of one forward, by name and count."""

    with torch.inference_mode():
        model(feats)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            model(feats)
            torch.cuda.synchronize()

    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)


def test_each_sum_and_norm_is_one_kernel(cuda, monkeypatch):
    """A published-width forward runs the add-and-norm kernel 20 times and
    PyTorch's LayerNorm never; against the same forward on the plain
    version, it runs 20 LayerNorm kernels and 20 add kernels fewer, and
    nothing else differs."""

    model = _model(cuda)
    feats = _feats(2, 300, cuda)
    counts = aln.add_layer_norm.fused, aln.add_layer_norm.plain
    fused = _kernel_names(model, feats)
    assert (aln.add_layer_norm.fused - counts[0],
            aln.add_layer_norm.plain - counts[1]) == (40, 0)
    monkeypatch.setattr(attention, 'add_layer_norm',
                        aln.add_layer_norm_plain)
    plain = _kernel_names(model, feats)

    ours = [n for n in fused if 'add_layer_norm_kernel' in n]
    assert sum(fused[n] for n in ours) == 20, sorted(fused)
    assert not any('vectorized_layer_norm' in n for n in fused), sorted(fused)
    assert fused - plain == collections.Counter({n: fused[n] for n in ours})
    gone = plain - fused
    norms = sum(v for n, v in gone.items() if 'layer_norm' in n)
    adds = sum(v for n, v in gone.items() if 'add' in n.lower() and
               'layer_norm' not in n)
    assert (norms, adds, sum(gone.values())) == (20, 20, 40), sorted(gone)


# The hft-serve-bf16 cell's calls: (y's shape, the residual's): the
# frequency encoder over 480 segments x 128 frames x 256 bins, the
# decoder's first sum with the 88 shared queries and its others, the time
# encoder over 480 x 88 notes x 128 frames
ADD_NORM_SHAPES = {
    'frequency encoder': ((61440, 256, 256), (61440, 256, 256)),
    'first decoder sum': ((61440, 88, 256), (88, 256)),
    'decoder': ((61440, 88, 256), (61440, 88, 256)),
    'time encoder': ((42240, 128, 256), (42240, 128, 256)),
}


def _bf16_ulp(x):
    """The spacing of bf16 values at |x|, in float32 (x > 0)."""

    _, exponent = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), exponent - 8)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', list(ADD_NORM_SHAPES))
def test_add_layer_norm_kernel_matches_plain(cuda, shape, dtype):
    """At the cell's shapes (float32 at a quarter of the leading dim, the
    memory four full-size float32 tensors would take), H kept."""

    y_shape, r_shape = ADD_NORM_SHAPES[shape]
    if dtype == torch.float32:
        y_shape = (y_shape[0] // 4, *y_shape[1:])
        if len(r_shape) == 3:
            r_shape = y_shape
    g = torch.Generator(device=cuda).manual_seed(23)
    y = torch.randn(y_shape, generator=g, device=cuda, dtype=dtype)
    y.mul_(2.0).add_(0.5)
    residual = torch.randn(r_shape, generator=g, device=cuda, dtype=dtype)
    residual.mul_(3.0).sub_(1.0)
    weight = (1.0 + 0.1 * torch.randn(256, generator=g, device=cuda)).to(
        dtype)
    bias = (0.1 * torch.randn(256, generator=g, device=cuda)).to(dtype)

    launches = aln.add_layer_norm.fused
    got = aln.add_layer_norm(y, residual, weight, bias, 1e-5)
    assert aln.add_layer_norm.fused == launches + 1
    want = aln.add_layer_norm_plain(y, residual, weight, bias, 1e-5)
    del y, residual
    assert got.shape == want.shape and got.dtype == want.dtype

    got, want = got.view(-1, 256), want.view(-1, 256)
    for start in range(0, got.shape[0], 1 << 20):
        a = got[start:start + (1 << 20)].float()
        b = want[start:start + (1 << 20)].float()
        allowed = 1e-6 * b.abs().amax(dim=1, keepdim=True)
        if dtype == torch.bfloat16:
            allowed = allowed + _bf16_ulp(
                torch.maximum(a.abs(), b.abs()).clamp_min(1e-30))
        ratio = (a - b).abs() / allowed
        assert bool((ratio <= 1.0).all()), float(ratio.max())
    del got, want
    torch.cuda.empty_cache()


def test_a_shape_no_fused_kernel_takes_raises(cuda):
    """Operands the fused backends refuse (float64, heads of 520 channels)
    raise instead of running the math backend."""

    q = torch.randn(2, 2, 8, 520, device=cuda, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        attention.attention(q, q, q, 'cross')


def test_more_sequences_than_a_launch_takes(cuda):
    """Above 65,535 sequences a call runs the fused kernel on chunks of at
    most 65,535 (a grid dimension's limit), and equals the plain product
    in float32 within 2e-2: bf16 operands, bf16 softmax weights before the
    value product and a bf16 output, on outputs of magnitude about 1."""

    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(70000, 2, 8, 64, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    before = attention.attention.plain
    with torch.inference_mode():
        got = attention.attention(q, k, v, 'time_self')
    assert attention.attention.plain == before
    want = attention._plain(q.float(), k.float(), v.float())
    assert got.shape == want.shape == (70000, 2, 8, 64)
    assert float((got.float() - want).abs().max()) < 2e-2


def _sharp(model):
    """Sharp onset and offset curves around a low level, notes held."""

    decoder = model.decoder_spec2midi
    with torch.no_grad():
        for head, scale, bias in (('onset', 30.0, -3.0),
                                  ('offset', 30.0, -3.0), ('mpe', 1.0, 0.5)):
            layer = getattr(decoder, f'fc_{head}_time')
            layer.weight *= scale
            layer.bias.fill_(bias)

    return model


def _rows(served, hop):
    return [sorted((int(p), int(np.rint(on / hop)), int(np.rint(off / hop)),
                    int(v)) for p, (on, off), v in zip(*clip))
            for clip in served]


def test_the_pipeline_serves_hft_notes(cuda):
    model = _sharp(_model(cuda))
    mel = MelSpec(hop_length=256, n_mels=256, htk=True, fmin=0.0, fmax=8000.0,
                  log_offset=1e-8)
    pipeline = RegressionPipeline(model, mel, capacity=2048, device=cuda,
                                  onset_threshold=0.5, offset_threshold=0.5,
                                  frame_threshold=0.5)
    raw = {}
    pipeline.model.register_forward_hook(lambda m, a, out: raw.update(out))
    g = torch.Generator(device=cuda).manual_seed(7)
    audio = 0.1 * torch.randn(3, 160000, generator=g, device=cuda)
    served = pipeline(audio)

    config = {'onset_threshold': 0.5, 'offset_threshold': 0.5,
              'frame_threshold': 0.5, 'lowest_key': 21}
    total = 0
    for b, got in enumerate(_rows(served, 256 / 16000)):
        curves = {key: torch.sigmoid(raw[key][b]).float().cpu().numpy()
                  for key in ('frame', 'reg_onset', 'reg_offset')}
        curves['velocity'] = raw['velocity'][b].argmax(-1).float().cpu(
            ).numpy()
        want = hpt_reference.decode(curves, config, velocity_scale=1)
        assert got == [(r[0], r[1], r[3], r[5]) for r in want]
        total += len(want)
    assert total > 0 and pipeline.notes_decoded == total


def test_the_hpt_pipeline_decodes_with_the_published_settings(cuda):
    """``RegressionPipeline``'s defaults serve the High-resolution model as
    the decode's published settings do: its notes equal the device and
    host stages run on the served logits with the thresholds 0.3, 0.3 and
    0.1, sigmoid velocities and ``velocity_scale`` 128."""

    model = RegressCRNN(dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for head in (model.reg_onset_fc, model.reg_offset_model.fc):
            head.weight *= 40.0
            head.bias.fill_(-4.0)
    mel = MelSpec(hop_length=160, fmin=30, fmax=8000, absolute_db=True,
                  pad_mode='reflect')
    pipeline = RegressionPipeline(model, mel, capacity=2048, device=cuda)
    raw = {}
    pipeline.model.register_forward_hook(lambda m, a, out: raw.update(out))
    g = torch.Generator(device=cuda).manual_seed(8)
    audio = 0.1 * torch.randn(4, 96000, generator=g, device=cuda)
    served = pipeline(audio)

    maps = {key: torch.sigmoid(value).float().transpose(-1, -2)
            for key, value in raw.items()}
    arrays = [a.cpu().numpy() for a in decode.regression_events_on_device(
        maps['frame'], maps['reg_onset'], maps['reg_offset'],
        maps['velocity'], 2048, 0.3, 0.3, 0.1)]
    frames = raw['frame'].shape[1]
    total = 0
    for b, clip in enumerate(served):
        want = decode.regression_notes_from_device(
            *(a[b] for a in arrays), num_frames=frames,
            frame_seconds=160 / 16000, low=21, max_frames=600,
            velocity_scale=128)
        for got, expected in zip(clip, want):
            assert np.array_equal(got, expected)
        total += len(want[0])
    assert total > 0
