"""Kernels A-G, the conv blocks' eval epilogue and the post-LN add and
norm as custom ops of ``torch.ops.amt_tools_tpu_torch``, on the CPU.

Each op (kernels B, E and F, one op each over (G, B, T, ·) tensors:
one sequence as one group, plain, masked, carried and carried over no
frames, and three groups, masked or not; the epilogue, pooled or not; the
add and norm, its residual full or broadcast) passes
``torch.library.opcheck`` (schema, fake implementation against the real
one, autograd registration, a trace with symbolic shapes), equals its plain
version bit for bit, survives ``torch.export`` save and load inside a tiny
module, and reports to ``FlopCounterMode`` exactly its cost function's
FLOPs. The cost functions reproduce the bound column of the kernel table
(PERF.md) at the main-path shapes. Inputs are seeded numpy arrays at small
shapes; the CPU route of every op is its plain version.
"""

import io

import numpy as np
import pytest
import torch
from torch.library import opcheck
from torch.utils.flop_counter import FlopCounterMode

from amt_tools_tpu_torch.features import CQT, MelSpec
from amt_tools_tpu_torch.ops import (add_layer_norm, conv_epilogue,
                                     cqt_kernel, cuda_build, gru_kernel,
                                     lstm_kernel, stft_kernel)

torch.set_num_threads(1)

HIDDEN = 16
FRAMES = 7
# Published H100 SXM peaks (PERF.md's bound column divides by these)
BYTES_PER_S, FP32, BF16 = 3.35e12, 67e12, 989e12


def _tensor(rng, *shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)


def _cases():
    """(label, op, args, plain) for every op and schema: ``plain()`` is the
    kernel's plain version on the same inputs."""

    rng = np.random.RandomState(0)
    mel = MelSpec(n_mels=16)
    bank = mel._bank(torch.device('cpu'))
    audio = _tensor(rng, 2, 3000, scale=0.1)

    full = CQT(sample_rate=22050, hop_length=512, n_bins=48,
               bins_per_octave=12)
    grouped = CQT(sample_rate=22050, hop_length=512, n_bins=48,
                  bins_per_octave=12, grouped=True, group_size=12)
    cqt_bank = full._bank(torch.device('cpu'))
    stack = grouped._bank(torch.device('cpu'))
    guitar = _tensor(rng, 2, 4000, scale=0.1)
    supports = list(grouped._group_supports)
    bins = list(grouped._group_bins)

    cases = [
        ('A', stft_kernel.stft_power_op, (audio, bank, 2048, 512, True),
         lambda: stft_kernel.stft_power_plain(audio, bank, 2048, 512)),
        ('C', cqt_kernel.cqt_mag_op,
         (guitar, cqt_bank, full._support, 512, 'bf16x3'),
         lambda: cqt_kernel.cqt_mag_plain(guitar, cqt_bank, full._support,
                                          512, 'high')),
        ('D', cqt_kernel.cqt_mag_grouped_op,
         (guitar, stack, supports, bins, 512, 'ffma'),
         lambda: cqt_kernel.cqt_mag_grouped_plain(guitar, stack, supports,
                                                  bins, 512, True)),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        xw = _tensor(rng, 3, FRAMES, 4 * HIDDEN, scale=0.5, dtype=dtype)
        wh = _tensor(rng, HIDDEN, 4 * HIDDEN, scale=0.2, dtype=dtype)
        lengths = torch.tensor([FRAMES, 3, 0], dtype=torch.int32)
        c0 = _tensor(rng, 3, HIDDEN, scale=0.5)
        h0 = _tensor(rng, 3, HIDDEN, scale=0.5)
        dc = _tensor(rng, 3, HIDDEN, scale=0.1)
        out, gates, c_seq = lstm_kernel.lstm_scan_residuals_plain(xw, wh)
        dout = _tensor(rng, 3, FRAMES, HIDDEN, scale=0.1, dtype=dtype)
        wht = wh.t().contiguous()
        # One sequence is one group (reverse_from 1 forward, 0 reversed);
        # each op returns a list, the carry's outputs last
        x1, w1, wht1, carry = xw[None], wh[None], wht[None], (c0[None],
                                                               h0[None])
        res1 = gates[None], c_seq[None], dout[None], wht1
        empty = xw[None, :, :0].contiguous()
        no_frames = tuple(t[None, :, :0].contiguous()
                          for t in (gates, c_seq, dout)) + (wht1,)

        def one(*results):
            return [x[None] for r in results
                    for x in (r if isinstance(r, tuple) else (r,))]

        cases += [
            (f'B {name}', lstm_kernel.lstm_scan_op,
             (x1, w1, 1, None, None, None),
             lambda xw=xw, wh=wh: one(lstm_kernel.lstm_scan_plain(xw, wh))),
            (f'B {name} masked', lstm_kernel.lstm_scan_op,
             (x1, w1, 0, lengths, None, None),
             lambda xw=xw, wh=wh, n=lengths: one(lstm_kernel.lstm_scan_plain(
                 xw, wh, True, n))),
            (f'B {name} carried', lstm_kernel.lstm_scan_op,
             (x1, w1, 1, lengths, *carry),
             lambda xw=xw, wh=wh, n=lengths, c=(c0, h0): one(
                 *lstm_kernel.lstm_scan_plain(xw, wh, False, n, c,
                                              return_carry=True))),
            (f'B {name} carried, no frames', lstm_kernel.lstm_scan_op,
             (empty, w1, 1, None, *carry),
             lambda wh=wh, c=(c0, h0), xw=xw: one(
                 *lstm_kernel.lstm_scan_plain(xw[:, :0], wh, False, None, c,
                                              return_carry=True))),
            (f'E {name}', lstm_kernel.lstm_scan_residuals_op,
             (x1, w1, 0, None, None, None),
             lambda xw=xw, wh=wh: one(
                 *lstm_kernel.lstm_scan_residuals_plain(xw, wh, True))),
            (f'E {name} masked', lstm_kernel.lstm_scan_residuals_op,
             (x1, w1, 0, lengths, None, None),
             lambda xw=xw, wh=wh, n=lengths: one(
                 *lstm_kernel.lstm_scan_residuals_plain(xw, wh, True, n))),
            (f'E {name} carried', lstm_kernel.lstm_scan_residuals_op,
             (x1, w1, 0, lengths, *carry),
             lambda xw=xw, wh=wh, n=lengths, c=(c0, h0): one(
                 *lstm_kernel.lstm_scan_residuals_plain(
                     xw, wh, True, n, c, return_carry=True))),
            (f'E {name} carried, no frames',
             lstm_kernel.lstm_scan_residuals_op,
             (empty, w1, 1, None, *carry),
             lambda wh=wh, c=(c0, h0), xw=xw: one(
                 *lstm_kernel.lstm_scan_residuals_plain(
                     xw[:, :0], wh, False, None, c, return_carry=True))),
            (f'F {name}', lstm_kernel.lstm_bptt_op,
             (*res1, 1, None, None, None, None),
             lambda g=gates, c=c_seq, d=dout, w=wht:
             one(lstm_kernel.lstm_bptt_plain(g, c, d, w))),
            (f'F {name} masked', lstm_kernel.lstm_bptt_op,
             (*res1, 0, lengths, None, None, None),
             lambda g=gates, c=c_seq, d=dout, w=wht, n=lengths:
             one(lstm_kernel.lstm_bptt_plain(g, c, d, w, True, n))),
            (f'F {name} carried', lstm_kernel.lstm_bptt_op,
             (*res1, 1, lengths, *carry, dc[None]),
             lambda g=gates, c=c_seq, d=dout, w=wht, n=lengths,
             k=(c0, h0, dc): one(*lstm_kernel.lstm_bptt_plain(
                 g, c, d, w, False, n, k))),
            (f'F {name} carried, no frames', lstm_kernel.lstm_bptt_op,
             (*no_frames, 1, None, *carry, dc[None]),
             lambda g=gates, c=c_seq, d=dout, w=wht, k=(c0, h0, dc):
             one(*lstm_kernel.lstm_bptt_plain(g[:, :0], c[:, :0], d[:, :0],
                                              w, False, None, k))),
        ]
        # Three groups, the last reversed
        gxw = _tensor(rng, 3, 3, FRAMES, 4 * HIDDEN, scale=0.5, dtype=dtype)
        gwh = _tensor(rng, 3, HIDDEN, 4 * HIDDEN, scale=0.2, dtype=dtype)
        _, ggates, gc = lstm_kernel.lstm_scan_residuals_grouped_plain(
            gxw, gwh, 2)
        gdout = _tensor(rng, 3, 3, FRAMES, HIDDEN, scale=0.1, dtype=dtype)
        gwht = gwh.transpose(1, 2).contiguous()
        cases += [
            (f'B {name} grouped', lstm_kernel.lstm_scan_op,
             (gxw, gwh, 2, None, None, None),
             lambda x=gxw, w=gwh: [
                 lstm_kernel.lstm_scan_grouped_plain(x, w, 2)]),
            (f'B {name} grouped masked', lstm_kernel.lstm_scan_op,
             (gxw, gwh, 2, lengths, None, None),
             lambda x=gxw, w=gwh, n=lengths: [
                 lstm_kernel.lstm_scan_grouped_plain(x, w, 2, n)]),
            (f'E {name} grouped', lstm_kernel.lstm_scan_residuals_op,
             (gxw, gwh, 2, None, None, None),
             lambda x=gxw, w=gwh: list(
                 lstm_kernel.lstm_scan_residuals_grouped_plain(x, w, 2))),
            (f'E {name} grouped masked', lstm_kernel.lstm_scan_residuals_op,
             (gxw, gwh, 2, lengths, None, None),
             lambda x=gxw, w=gwh, n=lengths: list(
                 lstm_kernel.lstm_scan_residuals_grouped_plain(x, w, 2, n))),
            (f'F {name} grouped', lstm_kernel.lstm_bptt_op,
             (ggates, gc, gdout, gwht, 2, None, None, None, None),
             lambda g=ggates, c=gc, d=gdout, w=gwht: [
                 lstm_kernel.lstm_bptt_grouped_plain(g, c, d, w, 2)]),
            (f'F {name} grouped masked', lstm_kernel.lstm_bptt_op,
             (ggates, gc, gdout, gwht, 2, lengths, None, None, None),
             lambda g=ggates, c=gc, d=gdout, w=gwht, n=lengths: [
                 lstm_kernel.lstm_bptt_grouped_plain(g, c, d, w, 2, n)]),
        ]

    # The conv blocks' eval epilogue on a channels-last conv output, an odd
    # width, unpooled and pooled
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        x = _tensor(rng, 2, 16, 3, 7, dtype=dtype).contiguous(
            memory_format=torch.channels_last)
        conv_bias = _tensor(rng, 16, scale=0.1, dtype=dtype)
        vectors = [_tensor(rng, 16, scale=0.3) for _ in range(3)]
        for pool in (False, True):
            args = (x, conv_bias, *vectors, pool)
            cases.append((f'epilogue {name}{" pooled" if pool else ""}',
                          conv_epilogue.conv_epilogue_op, args,
                          lambda a=args: conv_epilogue.conv_epilogue_plain(
                              *a)))
        # A bias-free conv, average-pooled (the hpt model's ConvBlocks)
        args = (x, None, *vectors, True, True)
        cases.append((f'epilogue {name} bias-free average',
                      conv_epilogue.conv_epilogue_op, args,
                      lambda a=args: conv_epilogue.conv_epilogue_plain(*a)))

    # Kernel G over three groups, the last two reversed
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        xw = _tensor(rng, 3, 2, FRAMES, 3 * HIDDEN, scale=0.5, dtype=dtype)
        wh = _tensor(rng, 3, HIDDEN, 3 * HIDDEN, scale=0.2, dtype=dtype)
        bhn = _tensor(rng, 3, HIDDEN, scale=0.1)
        cases.append((f'G {name} grouped', gru_kernel.gru_scan_grouped_op,
                      (xw, wh, bhn, 1),
                      lambda x=xw, w=wh, b=bhn: gru_kernel.gru_scan_plain(
                          x, w, b, 1)))

    # The post-LN add and norm, a residual of y's shape and one broadcast
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        y = _tensor(rng, 2, 3, 16, dtype=dtype)
        weight = _tensor(rng, 16, dtype=dtype)
        bias = _tensor(rng, 16, scale=0.1, dtype=dtype)
        for label, residual in (('', _tensor(rng, 2, 3, 16, dtype=dtype)),
                                (' broadcast', _tensor(rng, 3, 16,
                                                       dtype=dtype))):
            args = (y, residual, weight, bias, 1e-5)
            cases.append((f'add-norm {name}{label}',
                          add_layer_norm.add_layer_norm_op, args,
                          lambda a=args: add_layer_norm.add_layer_norm_plain(
                              *a)))

    return cases


CASES = _cases()
IDS = [case[0] for case in CASES]


def _same(got, want):
    if isinstance(want, torch.Tensor):
        return (got.dtype == want.dtype and got.shape == want.shape and
                torch.equal(got, want))
    return len(got) == len(want) and all(_same(g, w)
                                         for g, w in zip(got, want))


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_opcheck(case):
    _, op, args, _ = case

    report = opcheck(op, args)

    assert all(v == 'SUCCESS' for v in report.values()), report


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_op_equals_its_plain_version(case):
    _, op, args, plain = case

    assert _same(op(*args), plain())


def test_carried_op_returns_no_input():
    """The carry of zero steps is the input's, copied: an op may not return
    an input or a view of one."""

    for label in ('B float32 carried, no frames',
                  'E float32 carried, no frames',
                  'F float32 carried, no frames'):
        _, op, args, _ = next(c for c in CASES if c[0] == label)
        outputs = op(*args)
        inputs = [a.data_ptr() for a in args if isinstance(a, torch.Tensor)]
        assert not any(x.data_ptr() in inputs for x in outputs
                       if x.numel()), label


class _Calls(torch.nn.Module):
    """A tiny module that calls one op on its tensor inputs."""

    def __init__(self, op, args):
        super().__init__()
        self.op = op
        self.static = {i: a for i, a in enumerate(args)
                       if not isinstance(a, torch.Tensor) and a is not None}
        self.slots = [i for i, a in enumerate(args)
                      if isinstance(a, torch.Tensor)]
        self.count = len(args)

    def forward(self, *tensors):
        args = [None] * self.count
        for i, t in zip(self.slots, tensors):
            args[i] = t
        for i, a in self.static.items():
            args[i] = a
        return self.op(*args)


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_op_through_torch_export(case):
    _, op, args, plain = case
    tensors = tuple(a for a in args if isinstance(a, torch.Tensor))

    program = torch.export.export(_Calls(op, args), tensors, strict=False)
    assert any(str(node.target).startswith('amt_tools_tpu_torch.')
               for node in program.graph.nodes)

    buf = io.BytesIO()
    torch.export.save(program, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue()))

    assert _same(loaded.module()(*tensors), plain())


def _cost(label, args):
    if label == 'A':
        audio, bank, n_fft, hop, center = args
        return stft_kernel.cost(*audio.shape, n_fft, hop, bank.shape[1] // 2,
                                center)
    if label.startswith('epilogue'):
        return conv_epilogue.cost(args[0].shape, args[0].dtype, args[5],
                                  conv_bias=args[1] is not None)
    if label.startswith('add-norm'):
        y, residual, _, _, _ = args
        return add_layer_norm.cost(y.numel() // 16, residual.numel() // 16,
                                   16, y.dtype)
    if label.startswith('G'):
        xw = args[0]
        groups, batch, frames, three_h = xw.shape
        return gru_kernel.gru_scan_cost(batch, frames, three_h // 3,
                                        xw.dtype, groups)
    if label == 'C':
        audio, bank, _, hop, _ = args
        return cqt_kernel.cost(*audio.shape, hop, bank)
    if label == 'D':
        audio, stack, supports, bins, hop, _ = args
        return cqt_kernel.cost(*audio.shape, hop, stack, supports, bins)
    # a launch costs its groups times one sequence's
    groups, batch, frames, four_h = args[0].shape
    lengths = args[5] if label.startswith('F') else args[3]
    steps = None if lengths is None else int(lengths.sum())
    if label.startswith('F'):
        cost = lstm_kernel.bptt_cost(batch, frames, four_h // 4,
                                     args[2].dtype,
                                     carried='carried' in label, steps=steps)
    else:
        cost = lstm_kernel.scan_cost(
            batch, frames, four_h // 4, args[0].dtype,
            residuals=label.startswith('E'), carried='carried' in label,
            steps=steps)
    return groups * cost[0], groups * cost[1]


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_flop_counter_reads_the_cost_function(case):
    label, op, args, _ = case

    with FlopCounterMode(display=False) as counter:
        op(*args)

    flops, num_bytes = _cost(label, args)
    assert counter.get_total_flops() == int(round(flops))
    packet = getattr(torch.ops.amt_tools_tpu_torch, op._name)
    assert cuda_build.OP_COSTS[packet](*args) == (flops, num_bytes)


def _bound(cost, peak):
    return max(cost[1] / BYTES_PER_S, cost[0] / peak) * 1e3


@pytest.mark.parametrize('label, cost, peak, bound', [
    ('A', lambda: stft_kernel.cost(128, 960000, 2048, 512, 1025), FP32,
     0.441),
    ('B bf16', lambda: lstm_kernel.scan_cost(128, 1876, 256, torch.bfloat16),
     BF16, 0.184),
    ('B f32', lambda: lstm_kernel.scan_cost(128, 1876, 256, torch.float32),
     FP32, 1.879),
    ('E f32', lambda: lstm_kernel.scan_cost(8, 625, 256, torch.float32,
                                            residuals=True), FP32, 0.039),
    ('E bf16', lambda: lstm_kernel.scan_cost(8, 625, 256, torch.bfloat16,
                                             residuals=True), BF16, 0.012),
    ('F f32', lambda: lstm_kernel.bptt_cost(8, 625, 256, torch.float32),
     FP32, 0.039),
    ('F bf16', lambda: lstm_kernel.bptt_cost(8, 625, 256, torch.bfloat16),
     BF16, 0.015),
])
def test_cost_functions_reproduce_the_bound_column(label, cost, peak, bound):
    assert round(_bound(cost(), peak), 3) == bound


@pytest.mark.parametrize('grouped, bound', [(False, 0.150), ('auto', 0.144)])
def test_cqt_cost_reproduces_the_bound_column(grouped, bound):
    """Kernels C and D at the guitar serving recipe: 64 clips of 60 s at
    22.05 kHz, 192 bins at 24 an octave (the full bank, and the grouped
    stack)."""

    cqt = CQT(sample_rate=22050, hop_length=512, n_bins=192,
              bins_per_octave=24, exact='high', grouped=grouped)
    bank = cqt._bank(torch.device('cpu'))
    groups = (() if cqt._groups is None else
              (cqt._group_supports, cqt._group_bins))

    assert round(_bound(cqt_kernel.cost(64, 1323000, 512, bank, *groups),
                        FP32), 3) == bound


def test_twiddle_bytes_of_the_cost_are_the_table():
    tables = stft_kernel.cost(1, 0, 2048, 512, 1025)[1] / 4 - 1025
    assert 4 * (tables - 2048) == stft_kernel.fft_twiddles(2048).nbytes


def test_fake_implementations_launch_and_count_nothing():
    """On meta tensors each op runs its fake implementation: the shapes of
    the real outputs, no kernel launch, no count."""

    wrappers = (stft_kernel.stft_power, lstm_kernel.lstm_scan,
                lstm_kernel.lstm_scan_residuals, lstm_kernel.lstm_bptt,
                cqt_kernel.cqt_mag, cqt_kernel.cqt_mag_grouped)
    before = [w.launches for w in wrappers]
    for _, op, args, plain in CASES:
        meta = [a.to('meta') if isinstance(a, torch.Tensor) else a
                for a in args]
        got, want = op(*meta), plain()
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        assert [(g.shape, g.dtype) for g in got] == \
            [(w.shape, w.dtype) for w in want]
        assert all(g.device.type == 'meta' for g in got)

    assert [w.launches for w in wrappers] == before


def test_require_plain_passes_fake_tensors_and_refuses_subclasses():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = torch.empty(2, 3)
    cuda_build.require_plain('stft_power', audio=fake)

    class Wrapped(torch.Tensor):
        pass

    with pytest.raises(TypeError, match='plain tensors'):
        cuda_build.require_plain('stft_power',
                                 audio=torch.empty(2).as_subclass(Wrapped))
