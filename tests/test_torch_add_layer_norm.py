"""The post-LN sublayers' residual add and LayerNorm
(``ops/add_layer_norm.py``) and its route (``ops.attention._PostLN``), on
the CPU.

- The plain version, the op's CPU implementation and the wrapper equal,
  bit for bit, the ops the layers ran before the kernel existed:
  ``F.layer_norm(y + residual)``, a (R, H) residual broadcast over y's
  leading dims, in float32 and bf16.
- The wrapper refuses what the kernel does not take: a width that is not a
  multiple of 8 or is above 2048, another dtype, mismatched widths or
  dtypes, a residual that is not y's trailing dims, strided inputs.
- The fake implementation gives the output's shape, dtype and device on
  fake CUDA tensors, and the registered cost counts y and the residual
  read once and the output written once, at the hft-serve-bf16 cell's
  shapes.
- The route: on fake CUDA tensors (``FakeTensorMode``, no card needed) a
  layer that autograd does not record reaches the kernel's op once a
  sublayer; a recorded norm, and every layer on the CPU, run the plain
  version, counted.
- hFT-Transformer at a small size gives the logits of the layers as they
  were written before, bit for bit, and counts 20 plain calls a forward at
  3 layers a stack.

The kernel itself runs only on a card: ``tests/test_torch_cuda_hft.py``.
"""

import math

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import functional_call

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import HFTransformer
from amt_tools_tpu_torch.ops import add_layer_norm as aln
from amt_tools_tpu_torch.ops import attention, cuda_build

torch.set_num_threads(2)

EPS = 1e-5


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same_bits(got, want):
    return (got.dtype == want.dtype and got.shape == want.shape and
            torch.equal(_bits(got), _bits(want)))


def _inputs(width, dtype, broadcast, seed=0, leading=(3, 5)):
    """A sublayer output, its residual (y's shape, or (R, H) broadcast over
    y's first dim), and the norm's weight and bias in the dtype."""

    g = torch.Generator().manual_seed(seed + width)
    y = (2.0 * torch.randn(*leading, width, generator=g) + 0.5).to(dtype)
    shape = leading[1:] if broadcast else leading
    residual = (3.0 * torch.randn(*shape, width, generator=g) - 1.0).to(dtype)
    weight = (1.0 + 0.1 * torch.randn(width, generator=g)).to(dtype)
    bias = (0.1 * torch.randn(width, generator=g)).to(dtype)

    return y, residual, weight, bias


@pytest.mark.parametrize('route', ['plain', 'op', 'wrapper'])
@pytest.mark.parametrize('broadcast', [False, True],
                         ids=['full', 'broadcast'])
@pytest.mark.parametrize('width', [32, 256])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_the_cpu_routes_are_the_eager_ops(dtype, width, broadcast, route):
    y, residual, weight, bias = _inputs(width, dtype, broadcast)
    call = {'plain': aln.add_layer_norm_plain,
            'op': aln.add_layer_norm_op,
            'wrapper': aln.add_layer_norm}[route]

    got = call(y, residual, weight, bias, EPS)
    want = F.layer_norm(y + residual.expand_as(y), (width,), weight, bias,
                        EPS)

    assert _same_bits(got, want)


def _good(width=16, dtype=torch.bfloat16):
    return [torch.zeros(2, 3, width, dtype=dtype),
            torch.zeros(3, width, dtype=dtype),
            torch.ones(width, dtype=dtype), torch.zeros(width, dtype=dtype)]


@pytest.mark.parametrize('error, change', [
    (ValueError, lambda a: _good(width=12)),
    (ValueError, lambda a: _good(width=2056)),
    (ValueError, lambda a: [a[0][0, 0, 0], *a[1:]]),
    (TypeError, lambda a: _good(dtype=torch.float16)),
    (TypeError, lambda a: _good(dtype=torch.float64)),
    (TypeError, lambda a: [a[0], a[1].float(), *a[2:]]),
    (TypeError, lambda a: [*a[:2], a[2].float(), a[3]]),
    (ValueError, lambda a: [a[0], torch.zeros(3, 24, dtype=a[1].dtype),
                            *a[2:]]),
    (ValueError, lambda a: [a[0], torch.zeros(2, 16, dtype=a[1].dtype),
                            *a[2:]]),
    (ValueError, lambda a: [a[0], torch.zeros(1, 2, 3, 16,
                                              dtype=a[1].dtype), *a[2:]]),
    (ValueError, lambda a: [*a[:2], a[2][:8], a[3]]),
    (ValueError, lambda a: [*a[:3], torch.zeros(24, dtype=a[3].dtype)]),
    (ValueError, lambda a: [a[0].transpose(0, 1).contiguous().transpose(
        0, 1), *a[1:]]),
    (ValueError, lambda a: [a[0], torch.zeros(3, 32, dtype=a[1].dtype)[
        :, ::2], *a[2:]]),
    (ValueError, lambda a: [*a[:2], torch.ones(32, dtype=a[2].dtype)[::2],
                            a[3]]),
], ids=['width 12', 'width 2056', 'a scalar y', 'float16', 'float64',
        'residual dtype', 'weight dtype', 'residual width', 'residual rows',
        'residual dims', 'weight width', 'bias width', 'strided y',
        'strided residual', 'strided weight'])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(error, change):
    with pytest.raises(error):
        aln.add_layer_norm(*change(_good()), EPS)


@pytest.mark.parametrize('broadcast', [False, True],
                         ids=['full', 'broadcast'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fake_gives_shape_dtype_and_device(dtype, broadcast):
    with FakeTensorMode():
        args = [torch.empty(a.shape, dtype=a.dtype, device='cuda')
                for a in _inputs(256, dtype, broadcast, leading=(4, 88))]
        out = aln.add_layer_norm(*args, EPS)

    assert out.device.type == 'cuda' and out.dtype == dtype
    assert out.shape == (4, 88, 256) and out.is_contiguous()


# The hft-serve-bf16 cell's calls (480 segments of 128 frames, 88 notes,
# H 256, bf16): rows, residual rows, and y and the residual read and the
# output written once, with the weight and bias
@pytest.mark.parametrize('shape, residual, num_bytes', [
    ((61440, 256, 256), (61440, 256, 256), 24_159_192_064),
    ((61440, 88, 256), (88, 256), 5_536_527_360),
    ((61440, 88, 256), (61440, 88, 256), 8_304_722_944),
    ((42240, 128, 256), (42240, 128, 256), 8_304_722_944),
], ids=['frequency encoder', 'first decoder sum', 'decoder', 'time encoder'])
def test_the_cost_counts_two_reads_and_a_write(shape, residual, num_bytes):
    with FakeTensorMode():
        args = [torch.empty(s, dtype=torch.bfloat16, device='cuda')
                for s in (shape, residual, (256,), (256,))]
        packet = torch.ops.amt_tools_tpu_torch.add_layer_norm
        flops, counted = cuda_build.OP_COSTS[packet](*args, EPS)

    rows = math.prod(shape[:-1])
    assert (flops, counted) == (0.0, num_bytes)
    assert counted == 2 * 256 * (2 * rows + math.prod(residual[:-1]) + 2)


class _Spy:
    """Counts the calls that reach the kernel's op."""

    def __init__(self, monkeypatch):
        self.calls = 0
        self.op = aln.add_layer_norm_op
        monkeypatch.setattr(aln, 'add_layer_norm_op', self)

    def __call__(self, *args):
        self.calls += 1
        return self.op(*args)


def _layer(kind):
    g = torch.Generator().manual_seed(3)
    if kind == 'encoder':
        return attention.EncoderLayer(32, 2, 64, 'time_self', g), 2
    if kind == 'decoder zero':
        return attention.DecoderLayerZero(32, 2, 64, g), 2
    return attention.DecoderLayer(32, 2, 64, g), 3


@pytest.mark.parametrize('case, kernel', [
    ('cuda no_grad', True), ('cuda inference', True),
    ('cpu no_grad', False), ('cpu recorded', False)])
@pytest.mark.parametrize('kind', ['encoder', 'decoder zero', 'decoder'])
def test_the_route_of_each_sublayer(monkeypatch, kind, case, kernel):
    """On CUDA where autograd does not record, every sublayer's sum and norm
    reach the kernel's op; on the CPU the plain version, counted in
    ``add_layer_norm.plain``. (Without a card, fake CUDA tensors run no
    autograd records: :func:`test_a_recorded_norm_on_cuda_runs_the_plain_
    version` covers that route.)"""

    spy = _Spy(monkeypatch)
    layer, sublayers = _layer(kind)
    device = case.split()[0]
    context = (torch.enable_grad() if 'recorded' in case else
               torch.inference_mode() if 'inference' in case else
               torch.no_grad())
    plain = aln.add_layer_norm.plain

    with FakeTensorMode():
        state = {name: torch.empty(t.shape, device=device,
                                   requires_grad=True)
                 for name, t in layer.named_parameters()}
        x = torch.empty(4, 5, 32, dtype=torch.bfloat16, device=device)
        enc = torch.empty(4, 7, 32, dtype=torch.bfloat16, device=device)
        # The shared (Q, E) queries on the CPU; fake CUDA tensors take no
        # index, so (N, Q, E) ones there
        queries = torch.empty(*(() if device == 'cpu' else (4,)), 5, 32,
                              device=device)
        args = {'encoder': (x,), 'decoder zero': (enc, queries),
                'decoder': (enc, x)}
        with context:
            out = functional_call(layer, state,
                                  (*args[kind], torch.bfloat16))

    assert out.shape == (4, 5, 32) and out.dtype == torch.bfloat16
    assert spy.calls == (sublayers if kernel else 0)
    assert aln.add_layer_norm.plain - plain == (0 if kernel else sublayers)


@pytest.mark.parametrize('case, kernel', [
    ('no_grad', True), ('inference', True), ('weight recorded', False),
    ('input recorded', False)])
def test_a_recorded_norm_on_cuda_runs_the_plain_version(monkeypatch, case,
                                                        kernel):
    """``_PostLN._norm`` on fake CUDA float32 tensors: the kernel's op
    where autograd does not record; the plain version (a stand-in here,
    which records nothing) where grad is on and the norm's parameters or
    the sublayer's output require grad."""

    spy = _Spy(monkeypatch)
    monkeypatch.setattr(attention, 'add_layer_norm_plain',
                        lambda y, *args: torch.empty_like(y))
    context = (torch.enable_grad() if 'recorded' in case else
               torch.inference_mode() if case == 'inference' else
               torch.no_grad())
    plain = aln.add_layer_norm.plain

    with FakeTensorMode():
        post = attention._PostLN(32)
        post.layer_norm.weight, post.layer_norm.bias = (
            torch.nn.Parameter(torch.empty(32, device='cuda'),
                               requires_grad=case == 'weight recorded')
            for _ in range(2))
        y = torch.empty(4, 5, 32, device='cuda',
                        requires_grad=case == 'input recorded')
        with context:
            out = post._norm(y, torch.empty(5, 32, device='cuda'),
                             torch.float32)

    assert out.shape == (4, 5, 32)
    assert spy.calls == int(kernel)
    assert aln.add_layer_norm.plain - plain == int(not kernel)


# The layers' forwards as they were written before the kernel existed: the
# residual sum, then F.layer_norm
def _norm_before(self, x, dtype):
    norm = self.layer_norm
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(dtype),
                        norm.bias.to(dtype), norm.eps)


def _encoder_before(self, src, dtype=None):
    dtype = src.dtype if dtype is None else dtype
    src = _norm_before(self, src + self.self_attention(src, src, dtype),
                       dtype)
    return _norm_before(self, src + self.positionwise_feedforward(src, dtype),
                        dtype)


def _decoder_zero_before(self, enc_src, trg, dtype=None):
    dtype = enc_src.dtype if dtype is None else dtype
    trg = _norm_before(self, trg.to(dtype) +
                       self.encoder_attention(trg, enc_src, dtype), dtype)
    return _norm_before(self, trg + self.positionwise_feedforward(trg, dtype),
                        dtype)


def _decoder_before(self, enc_src, trg, dtype=None):
    dtype = trg.dtype if dtype is None else dtype
    trg = _norm_before(self, trg + self.self_attention(trg, trg, dtype),
                       dtype)
    trg = _norm_before(self, trg + self.encoder_attention(trg, enc_src,
                                                          dtype), dtype)
    return _norm_before(self, trg + self.positionwise_feedforward(trg, dtype),
                        dtype)


SMALL = {'n_bin': 32, 'n_margin': 4, 'n_frame': 8, 'hid_dim': 32,
         'n_layers': 3, 'n_heads': 2, 'pf_dim': 64, 'n_velocity': 16}


@pytest.mark.parametrize('dtype', [None, torch.bfloat16])
def test_hft_gives_the_logits_of_the_layers_before(monkeypatch, dtype):
    model = HFTransformer(profile=tools.PianoProfile(60, 71), dtype=dtype,
                          generator=torch.Generator().manual_seed(1),
                          **SMALL).eval()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, value in model.named_parameters():
            if 'layer_norm' in name:
                value.add_(0.1 * torch.randn(value.shape, generator=g))
    feats = -18.0 + 6.0 * torch.rand(2, 1, 32, 21, generator=g)

    plain = aln.add_layer_norm.plain
    with torch.no_grad():
        got = model(feats)
    assert aln.add_layer_norm.plain - plain == 20

    for cls, forward in ((attention.EncoderLayer, _encoder_before),
                         (attention.DecoderLayerZero, _decoder_zero_before),
                         (attention.DecoderLayer, _decoder_before)):
        monkeypatch.setattr(cls, 'forward', forward)
    with torch.no_grad():
        want = model(feats)

    assert got.keys() == want.keys()
    for key in want:
        assert _same_bits(got[key], want[key]), key
