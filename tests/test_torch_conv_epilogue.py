"""The conv blocks' eval epilogue (``ops/conv_epilogue.py``) and its route
(``ops.layers.conv_block``), on the CPU.

- The op's plain version equals, bit for bit, the eager ops the acoustic
  stacks ran before the kernel existed: the conv bias added in x's dtype,
  BatchNorm's float32 copy updated in place and cast back, ReLU, the (1, 2)
  max-pool. NaN, infinities and signed zeros are planted; bits are compared,
  so a NaN must stay a NaN where the eager ops keep it.
- The fake implementation gives the output's shape and dtype, on fake CUDA
  tensors and under ``torch.export``.
- The route: on fake CUDA tensors (``FakeTensorMode``, no card needed) an
  eval forward that autograd does not record calls the op once a block; a
  recorded forward, a train-mode forward and an int8 conv do not.
- The stacks' layout (``ops.layers.stack_layout``): channels-last, counted,
  for a CUDA eval forward of float convs that autograd does not record; x
  itself for the CPU, a recorded forward, train mode and an int8 conv.
- On the CPU the stacks' eval and train forwards run the eager ops, bit for
  bit those written out here.

The kernel itself runs only on a card: ``tests/test_torch_cuda.py``.
"""

import io

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import functional_call

from amt_tools_tpu_torch.models import onsetsframes
from amt_tools_tpu_torch.models.onsetsframes import (AcousticModel,
                                                     GroupedAcousticModel)
from amt_tools_tpu_torch.ops import conv_epilogue as ce
from amt_tools_tpu_torch.ops import layers

torch.set_num_threads(1)

EPS = 1e-5
SPECIALS = (float('nan'), float('inf'), -float('inf'), -0.0, 0.0, 1e-40,
            -1e-40)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same_bits(got, want):
    return (got.dtype == want.dtype and got.shape == want.shape and
            torch.equal(_bits(got), _bits(want)))


def _inputs(shape, dtype, seed):
    """A bias-free conv output with the special values planted, and the
    block's conv bias and eval BatchNorm vectors; channel 0 passes a signed
    zero through to the ReLU (mean 0, scale 1, biases -0.0)."""

    g = torch.Generator().manual_seed(seed)
    channels = shape[1]
    x = torch.randn(shape, generator=g).to(dtype)
    flat = x.view(-1)
    picks = torch.randperm(flat.numel(), generator=g)[:len(SPECIALS) * 3]
    flat[picks] = torch.tensor(SPECIALS * 3).to(dtype)
    conv_bias = (0.1 * torch.randn(channels, generator=g)).to(dtype)
    mean = 0.3 * torch.randn(channels, generator=g)
    var = torch.rand(channels, generator=g) + 0.5
    weight = torch.randn(channels, generator=g)
    bias = 0.2 * torch.randn(channels, generator=g)
    conv_bias[0], mean[0], var[0], weight[0], bias[0] = (-0.0, 0.0, 1 - EPS,
                                                         1.0, -0.0)

    return x, conv_bias, mean, var, weight, bias


def _eager(x, conv_bias, mean, var, weight, bias, pool):
    """The acoustic block's ops after the conv, as the stacks ran them:
    the conv's bias add, BatchNorm's eval arithmetic, ReLU, the pool."""

    shape = (1, -1, 1, 1)
    x = x + conv_bias.view(shape)
    mul = torch.rsqrt(var + EPS) * weight
    y = x.to(torch.float32, copy=True)
    y.sub_(mean.view(shape)).mul_(mul.view(shape))
    y.add_(bias.view(shape))
    y = F.relu(y.to(x.dtype))

    return F.max_pool2d(y, (1, 2), stride=(1, 2)) if pool else y


@pytest.mark.parametrize('layout', [torch.contiguous_format,
                                    torch.channels_last])
@pytest.mark.parametrize('shape', [(2, 48, 1, 229), (1, 96, 1876, 7),
                                   (2, 144, 3, 114), (1, 48, 1876, 229),
                                   (2, 96, 5, 229)])
@pytest.mark.parametrize('pool', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plain_equals_the_eager_block(shape, pool, dtype, layout):
    """On NCHW and on channels-last tensors, the two layouts cuDNN gives
    the stacks' convs on the card (the serving pipelines' and that of
    (B, T, F, 1) features), which the output keeps."""

    x, conv_bias, mean, var, weight, bias = _inputs(shape, dtype, sum(shape))
    x = x.contiguous(memory_format=layout)
    mul = torch.rsqrt(var + EPS) * weight

    got = ce.conv_epilogue(x, conv_bias, mean, mul, bias, pool)
    want = _eager(x, conv_bias, mean, var, weight, bias, pool)

    assert _same_bits(got, want) and got.stride() == want.stride()
    assert got.is_contiguous(memory_format=layout)
    assert torch.isnan(got).any() and torch.isinf(got).any()


def _good(dtype=torch.bfloat16, channels=4, width=7):
    x = torch.zeros(2, channels, 3, width, dtype=dtype)
    vectors = [torch.zeros(channels) for _ in range(3)]
    return [x, torch.zeros(channels, dtype=dtype), *vectors]


@pytest.mark.parametrize('error, change', [
    (ValueError, lambda a: [a[0][0], *a[1:]]),
    (TypeError, lambda a: [a[0].half(), a[1].half(), *a[2:]]),
    (TypeError, lambda a: [a[0], a[1].float(), *a[2:]]),
    (TypeError, lambda a: [*a[:2], a[2].double(), *a[3:]]),
    (ValueError, lambda a: [*a[:3], torch.zeros(5), a[4]]),
    (ValueError, lambda a: [a[0].transpose(2, 3).contiguous().transpose(
        2, 3), *a[1:]]),
    (ValueError, lambda a: [*a[:2], torch.zeros(8)[::2], *a[3:]]),
], ids=['3d', 'float16', 'bias dtype', 'mean dtype', 'mul shape',
        'strided x', 'strided mean'])
def test_op_checks_its_inputs(error, change):
    with pytest.raises(error):
        ce.conv_epilogue(*change(_good()), False)


def test_pool_needs_a_width_of_two():
    with pytest.raises(ValueError):
        ce.conv_epilogue(*_good(width=1), True)
    assert ce.conv_epilogue(*_good(width=1), False).shape == (2, 4, 3, 1)


@pytest.mark.parametrize('layout', [torch.contiguous_format,
                                    torch.channels_last])
@pytest.mark.parametrize('width', [229, 114, 7])
@pytest.mark.parametrize('pool', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fake_gives_shape_dtype_and_layout(width, pool, dtype, layout):
    with FakeTensorMode():
        args = _good(dtype, channels=48, width=width)
        args = [torch.empty(a.shape, dtype=a.dtype, device='cuda',
                            memory_format=layout if a.dim() == 4 else
                            torch.contiguous_format) for a in args]
        out = ce.conv_epilogue(*args, pool)

    assert out.device.type == 'cuda' and out.dtype == dtype
    assert out.shape == (2, 48, 3, width // 2 if pool else width)
    assert out.is_contiguous(memory_format=layout)


class _Epilogue(torch.nn.Module):
    def __init__(self, pool):
        super().__init__()
        self.pool = pool

    def forward(self, x, conv_bias, mean, mul, bias):
        return ce.conv_epilogue(x, conv_bias, mean, mul, bias, self.pool)


@pytest.mark.parametrize('pool', [False, True])
def test_export_keeps_the_op_with_a_symbolic_batch(pool):
    x, conv_bias, mean, var, weight, bias = _inputs((3, 48, 5, 229),
                                                    torch.bfloat16, 1)
    args = (x, conv_bias, mean, torch.rsqrt(var + EPS) * weight, bias)
    batch = torch.export.Dim('batch')

    program = torch.export.export(
        _Epilogue(pool), args, strict=False,
        dynamic_shapes=({0: batch}, None, None, None, None))
    node = next(n for n in program.graph.nodes
                if str(n.target).startswith('amt_tools_tpu_torch.'))
    value = node.meta['val']
    assert value.dtype == torch.bfloat16
    assert value.shape[1:] == (48, 5, 114 if pool else 229)

    buf = io.BytesIO()
    torch.export.save(program, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue())).module()
    assert _same_bits(loaded(*args), _eager(x, conv_bias, mean, var, weight,
                                            bias, pool))


def _model(kind, quant=False, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(5)
    if kind == 'grouped':
        model = GroupedAcousticModel(16, 8, heads=3, model_complexity=1,
                                     dtype=dtype, generator=g)
    else:
        model = AcousticModel(16, 8, model_complexity=1, dtype=dtype,
                              generator=g, quant=quant)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, layers.BatchNorm):
                channels = module.running_mean.shape[0]
                module.running_mean.copy_(0.3 * torch.randn(channels,
                                                            generator=g))
                module.running_var.copy_(torch.rand(channels, generator=g) +
                                         0.5)
                module.weight.copy_(torch.randn(channels, generator=g))
                module.bias.copy_(0.2 * torch.randn(channels, generator=g))
            if isinstance(module, torch.nn.Conv2d) and module.bias is not None:
                module.bias.copy_(0.1 * torch.randn(module.bias.shape,
                                                    generator=g))

    return model


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls ``conv_block`` makes to the epilogue op."""

    seen = []

    def spy(*args, **kwargs):
        seen.append(args[-1])
        return ce.conv_epilogue(*args, **kwargs)

    monkeypatch.setattr(layers, 'conv_epilogue', spy)
    return seen


def _fake_cuda_forward(model, mode):
    """The eval model's forward on fake CUDA tensors, under
    ``torch.no_grad()`` ('eval') or ``torch.inference_mode()``
    ('inference'). Without a card, fake CUDA tensors run no autograd
    records, no train-mode BatchNorm and no int8 layer:
    :func:`test_route_decision` covers those."""

    with FakeTensorMode():
        state = {name: torch.empty(t.shape, dtype=t.dtype, device='cuda')
                 for name, t in [*model.named_parameters(),
                                 *model.named_buffers()]}
        feats = torch.empty(2, 12, 16, 1, device='cuda')
        context = (torch.inference_mode() if mode == 'inference' else
                   torch.no_grad())
        with context:
            return functional_call(model.eval(), state, (feats,))


@pytest.mark.parametrize('mode', ['eval', 'inference'])
@pytest.mark.parametrize('kind', ['per-head', 'grouped'])
def test_eval_forward_takes_the_kernel_once_a_block(kind, mode, calls):
    out = _fake_cuda_forward(_model(kind), mode)

    assert calls == [False, True, True]
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize('case, eager', [
    ('eval', False), ('inference', False), ('float32', False),
    ('recorded', True), ('input recorded', True), ('train', True),
    ('int8', True), ('float16', True), ('cpu', True)])
def test_route_decision(case, eager):
    """Whether ``conv_block`` runs the eager ops: a recorded forward
    (parameters or input requiring grad, grad enabled), a train-mode norm,
    an int8 conv (``Conv_1`` of an int8 stack), a float16 conv and the CPU
    do."""

    dtype = {'float32': torch.float32,
             'float16': torch.float16}.get(case, torch.bfloat16)

    model = _model('per-head', quant=case == 'int8').eval()
    if case == 'input recorded':
        model.requires_grad_(False)
    if case == 'train':
        model.train()
    conv = model.Conv_1 if case == 'int8' else model.Conv_0
    norm = model.BatchNorm_1 if case == 'int8' else model.BatchNorm_0
    channels = 16 if case == 'int8' else 1
    context = (torch.enable_grad() if 'recorded' in case else
               torch.inference_mode() if case == 'inference' else
               torch.no_grad())

    with FakeTensorMode():
        x = torch.empty(2, channels, 12, 16,
                        device='cpu' if case == 'cpu' else 'cuda',
                        requires_grad=case == 'input recorded')
        with context:
            assert layers._eager_block(x, conv, norm, dtype) == eager


def _blocks(model):
    return [(getattr(model, f'Conv_{i}'), getattr(model, f'BatchNorm_{i}'))
            for i in range(3)]


@pytest.mark.parametrize('conv', ['float', 'int8'])
@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('grad', ['no_grad', 'recorded'])
@pytest.mark.parametrize('device', ['cpu', 'cuda'])
def test_stack_layout_decision(device, grad, train, conv):
    """``stack_layout`` puts a stack's input channels-last, and counts it,
    only for a CUDA input to an eval-mode stack of float convs that autograd
    does not record; every other case (the CPU, a recorded forward, train
    mode, an int8 ``Conv_1``) gets x itself back, the serving pipelines'
    transposed view."""

    model = _model('per-head', quant=conv == 'int8').train(train)
    context = torch.enable_grad() if grad == 'recorded' else torch.no_grad()
    counted = layers.stack_layout.channels_last

    with FakeTensorMode():
        # (B, C, F, T) features as the pipelines hand them to the stacks
        x = torch.empty(2, 1, 16, 12, device=device).permute(0, 1, 3, 2)
        with context:
            out = layers.stack_layout(x, model, _blocks(model),
                                      torch.bfloat16)

    channels_last = (device, grad, train, conv) == ('cuda', 'no_grad', False,
                                                   'float')
    assert layers.stack_layout.channels_last == counted + channels_last
    if channels_last:
        assert out.shape == x.shape
        assert out.is_contiguous(memory_format=torch.channels_last)
    else:
        assert out is x


@pytest.mark.parametrize('mode', ['eval', 'inference'])
@pytest.mark.parametrize('kind', ['per-head', 'grouped'])
def test_fake_cuda_eval_forward_runs_the_stack_channels_last(kind, mode,
                                                              monkeypatch):
    """On fake CUDA tensors an eval forward counts one channels-last stack,
    whose first block receives the features channels-last. (What layout
    cuDNN then gives the conv outputs, and the valid lengths' mask, which
    builds its frame index on the device, show on a card only:
    ``tests/test_torch_cuda.py``.)"""

    layouts = []

    def spy(x, *args, **kwargs):
        layouts.append(x.is_contiguous(memory_format=torch.channels_last))
        return layers.conv_block(x, *args, **kwargs)

    monkeypatch.setattr(onsetsframes, 'conv_block', spy)
    counted = layers.stack_layout.channels_last

    out = _fake_cuda_forward(_model(kind), mode)

    assert layers.stack_layout.channels_last == counted + 1
    assert len(layouts) == 3 and layouts[0]
    assert out.dtype == torch.bfloat16


def _block_before_the_kernel(x, conv, norm, pool, dtype=None):
    """``conv_block`` as the stacks ran it before the kernel: the eager
    ops, BatchNorm's eval arithmetic written out."""

    x = layers.conv2d_same(x, conv, dtype)
    if norm.training:
        x = norm(x, dtype)
    else:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(norm.running_var + norm.eps) * norm.weight
        y = x.to(torch.float32, copy=True)
        y.sub_(norm.running_mean.view(shape)).mul_(mul.view(shape))
        y.add_(norm.bias.view(shape))
        x = y.to(x.dtype)
    x = F.relu(x)

    return F.max_pool2d(x, (1, 2), stride=(1, 2)) if pool else x


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', ['per-head', 'grouped'])
def test_cpu_forwards_run_the_eager_ops(kind, dtype, train, calls,
                                        monkeypatch):
    model = _model(kind, dtype=dtype if dtype != torch.float32 else None)
    model.dropout = False
    model.train(train)
    g = torch.Generator().manual_seed(9)
    feats = torch.rand(2, 12, 16, 1, generator=g)
    lengths = torch.tensor([12, 7])

    def forward():
        state = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            out = model(feats, lengths=lengths)
        model.load_state_dict(state)
        return out

    got = forward()
    monkeypatch.setattr(onsetsframes, 'conv_block',
                        _block_before_the_kernel)
    want = forward()

    assert calls == []
    assert _same_bits(got, want)


# The average pool and the bias-free conv (the High-resolution Piano
# Transcription model's ConvBlocks), and its fc5 through the (rows, N, 1, 1)
# view


def _eager_avg(x, conv_bias, mean, var, weight, bias, pool):
    """The eager ops of a bias-free block (``conv_bias`` None) or one with a
    bias, average-pooled: BatchNorm's eval arithmetic, ReLU,
    ``F.avg_pool2d``."""

    shape = (1, -1, 1, 1)
    if conv_bias is not None:
        x = x + conv_bias.view(shape)
    mul = torch.rsqrt(var + EPS) * weight
    y = x.to(torch.float32, copy=True)
    y.sub_(mean.view(shape)).mul_(mul.view(shape))
    y.add_(bias.view(shape))
    y = F.relu(y.to(x.dtype))

    return F.avg_pool2d(y, (1, 2), stride=(1, 2)) if pool else y


@pytest.mark.parametrize('layout', [torch.contiguous_format,
                                    torch.channels_last])
@pytest.mark.parametrize('shape', [(2, 48, 3, 229), (1, 64, 5, 114),
                                   (2, 96, 4, 57), (1, 128, 3, 28),
                                   (3, 8, 2, 7)])
@pytest.mark.parametrize('with_bias', [False, True])
@pytest.mark.parametrize('pool', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plain_average_pool_and_no_bias_equal_the_eager_ops(
        shape, with_bias, pool, dtype, layout):
    x, conv_bias, mean, var, weight, bias = _inputs(shape, dtype,
                                                    sum(shape) + 7)
    x = x.contiguous(memory_format=layout)
    conv_bias = conv_bias if with_bias else None
    mul = torch.rsqrt(var + EPS) * weight

    got = ce.conv_epilogue(x, conv_bias, mean, mul, bias, pool, avg=True)
    want = _eager_avg(x, conv_bias, mean, var, weight, bias, pool)

    assert _same_bits(got, want) and got.stride() == want.stride()
    assert got.is_contiguous(memory_format=layout)


def test_no_bias_keeps_signed_zeros():
    """A bias-free conv adds nothing, where adding a zero bias would turn
    -0.0 into +0.0 on the way to the norm."""

    x = torch.tensor([-0.0, 0.0, -1.0, 2.0]).view(1, 1, 1, 4)
    zero = torch.zeros(1)
    got = ce.conv_epilogue(x, None, zero, torch.ones(1), torch.tensor([-0.0]),
                           False)
    assert _same_bits(got, F.relu(x))


@pytest.mark.parametrize('pool', [False, True])
def test_cost_counts_the_vectors_of_a_bias_free_conv(pool):
    with_bias = ce.cost((2, 48, 3, 229), torch.bfloat16, pool)
    without = ce.cost((2, 48, 3, 229), torch.bfloat16, pool, conv_bias=False)
    assert with_bias[1] - without[1] == 2 * 48
    assert with_bias == ce.cost((2, 48, 3, 229), torch.bfloat16, pool, True)


@pytest.mark.parametrize('avg', [False, True])
def test_fake_average_pool_gives_the_pooled_shape(avg):
    with FakeTensorMode():
        x = torch.empty(2, 48, 3, 229, dtype=torch.bfloat16, device='cuda',
                        memory_format=torch.channels_last)
        vectors = [torch.empty(48, device='cuda') for _ in range(3)]
        out = ce.conv_epilogue(x, None, *vectors, True, avg)
    assert out.shape == (2, 48, 3, 114)
    assert out.is_contiguous(memory_format=torch.channels_last)


def test_the_hpt_conv_block_takes_the_kernel_twice(monkeypatch):
    """On fake CUDA tensors in eval, a ConvBlock's two convs each run one
    pass of the epilogue with no conv bias, the second average-pooled, and
    fc5's norm and ReLU one more, unpooled; on the CPU the eager ops, bit
    for bit the plain version's."""

    from amt_tools_tpu_torch.models import hpt

    seen = []

    def spy(x, conv_bias, mean, mul, bias, pool, avg=False):
        seen.append((conv_bias is None, pool, avg, tuple(x.shape)))
        return ce.conv_epilogue(x, conv_bias, mean, mul, bias, pool, avg)

    monkeypatch.setattr(layers, 'conv_epilogue', spy)
    class Embed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.stack = hpt.AcousticCRNN(229, 88, dtype=torch.bfloat16)

        def forward(self, x):
            return self.stack.embed(x)

    model = Embed().eval()
    with FakeTensorMode():
        state = {name: torch.empty(t.shape, dtype=t.dtype, device='cuda')
                 for name, t in [*model.named_parameters(),
                                 *model.named_buffers()]}
        x = torch.empty(2, 1, 5, 229, device='cuda')
        with torch.no_grad():
            out = functional_call(model, state, (x,))
    assert out.shape == (2, 5, 768) and out.dtype == torch.bfloat16
    assert seen[:2] == [(True, False, False, (2, 48, 5, 229)),
                        (True, True, True, (2, 48, 5, 229))]
    assert len(seen) == 9 and seen[-1] == (True, False, False,
                                           (10, 768, 1, 1))
