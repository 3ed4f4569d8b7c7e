"""Kernel G's plain version and the BiGRU layers (``ops/gru_kernel.py``,
``ops/gru.py``) on the CPU.

- ``gru_scan_plain`` against ``torch.nn.GRU`` in float32, both directions:
  the kernel's numerics are the library's step (float32 h, the r, z and n
  gates, ``n + z (h - n)``), so they agree to float32 rounding.
- Grouped equals per-stream: a group's recurrence is its own.
- ``BiGRU`` holds ``torch.nn.GRU``'s parameters under its names and gives its
  outputs; ``bigru_layers`` over several BiGRUs equals each alone.
- The op: its input checks, its fake implementation's shape, its cost, its
  plain route on the CPU, and on fake CUDA tensors (no card needed) one
  launch a grouped layer; where autograd records, the plain version and its
  gradients.

The kernel itself runs only on a card: ``tests/test_torch_cuda.py``.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from amt_tools_tpu_torch.ops import gru as gru_layers
from amt_tools_tpu_torch.ops import gru_kernel as gk
from amt_tools_tpu_torch.ops.gru import BiGRU, bigru_layers

torch.set_num_threads(1)


def _nn_gru(input_size, hidden, layers, seed=0):
    torch.manual_seed(seed)
    return torch.nn.GRU(input_size, hidden, num_layers=layers,
                        batch_first=True, bidirectional=True)


def _kernel_inputs(ref, layer, suffix, x):
    """One direction of ``ref`` as the kernel takes it: projections with
    b_ih and the r and z hidden biases, W_hh transposed, b_hn."""

    w_ih = getattr(ref, f'weight_ih_l{layer}{suffix}')
    w_hh = getattr(ref, f'weight_hh_l{layer}{suffix}')
    b_ih = getattr(ref, f'bias_ih_l{layer}{suffix}')
    b_hh = getattr(ref, f'bias_hh_l{layer}{suffix}')
    hidden = w_hh.shape[1]
    bias = b_ih + torch.cat([b_hh[:2 * hidden], torch.zeros(hidden)])
    xw = x @ w_ih.t() + bias

    return xw, w_hh.t().contiguous(), b_hh[2 * hidden:].contiguous()


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('batch,frames,hidden', [(3, 17, 16), (1, 40, 32),
                                                 (4, 9, 48)])
def test_plain_equals_nn_gru_in_float32(batch, frames, hidden, reverse):
    ref = _nn_gru(10, hidden, 1, seed=hidden + frames)
    x = torch.randn(batch, frames, 10, generator=torch.Generator()
                    .manual_seed(batch))
    with torch.no_grad():
        want = ref(x)[0][..., hidden:] if reverse else ref(x)[0][..., :hidden]
        xw, w_h, b_hn = _kernel_inputs(ref, 0, '_reverse' if reverse else '',
                                       x)
        got = gk.gru_scan_plain(xw[None], w_h[None], b_hn[None],
                                0 if reverse else 1)[0]

    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse_from', [0, 2, 3, 5])
def test_grouped_equals_per_stream(dtype, reverse_from):
    g = torch.Generator().manual_seed(reverse_from)
    groups, batch, frames, hidden = 5, 2, 11, 16
    xw = torch.randn(groups, batch, frames, 3 * hidden, generator=g).to(dtype)
    w_h = (0.25 * torch.randn(groups, hidden, 3 * hidden, generator=g)).to(
        dtype)
    b_hn = 0.1 * torch.randn(groups, hidden, generator=g)

    got = gk.gru_scan_grouped(xw, w_h, b_hn, reverse_from)
    for s in range(groups):
        alone = gk.gru_scan_grouped(xw[s:s + 1].contiguous(),
                                    w_h[s:s + 1].contiguous(),
                                    b_hn[s:s + 1].contiguous(),
                                    0 if s >= reverse_from else 1)
        assert torch.equal(got[s], alone[0])
    assert got.dtype == dtype and got.shape == (groups, batch, frames, hidden)


def test_bf16_rounds_h_for_the_product_and_the_output():
    """In bf16 the product reads h rounded to bf16 and the output is h
    rounded; h itself stays float32 across the steps."""

    g = torch.Generator().manual_seed(7)
    xw = torch.randn(1, 2, 6, 48, generator=g)
    w_h = 0.3 * torch.randn(1, 16, 48, generator=g)
    b_hn = 0.1 * torch.randn(1, 16, generator=g)
    got = gk.gru_scan_plain(xw.bfloat16(), w_h.bfloat16(), b_hn, 1)

    h = torch.zeros(2, 16)
    w = w_h[0].bfloat16().float()
    for t in range(6):
        hp = h.bfloat16().float() @ w
        x = xw[0, :, t].bfloat16().float()
        r = torch.sigmoid(x[:, :16] + hp[:, :16])
        z = torch.sigmoid(x[:, 16:32] + hp[:, 16:32])
        n = torch.tanh(x[:, 32:] + r * (hp[:, 32:] + b_hn[0]))
        h = n + z * (h - n)
        assert torch.equal(got[0, :, t], h.bfloat16())


@pytest.mark.parametrize('layers', [1, 2])
def test_bigru_is_nn_gru_by_name_and_value(layers):
    ref = _nn_gru(12, 16, layers)
    ours = BiGRU(12, 16, num_layers=layers)
    assert list(ours.state_dict()) == sorted(ref.state_dict(), key=list(
        ours.state_dict()).index)
    assert set(ours.state_dict()) == set(ref.state_dict())
    ours.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn(3, 13, 12)
    with torch.no_grad():
        got, want = ours(x), ref(x)[0]

    assert got.shape == want.shape == (3, 13, 32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_bigru_draws_nn_gru_s_initial_range():
    gru = BiGRU(8, 64, generator=torch.Generator().manual_seed(3))
    for value in gru.state_dict().values():
        assert value.abs().max() <= 64 ** -0.5
        assert value.abs().max() > 0.9 * 64 ** -0.5


def test_bigru_layers_group_equals_each_alone():
    grus = [BiGRU(10, 16, num_layers=2,
                  generator=torch.Generator().manual_seed(s))
            for s in range(3)]
    inputs = [torch.randn(2, 7, 10, generator=torch.Generator().manual_seed(
        10 + s)) for s in range(3)]
    with torch.no_grad():
        together = bigru_layers(grus, inputs)
        for gru, x, got in zip(grus, inputs, together):
            assert torch.equal(got, gru(x))


def test_bigru_layers_refuse_mixed_widths():
    with pytest.raises(ValueError):
        bigru_layers([BiGRU(4, 16), BiGRU(4, 32)],
                     [torch.zeros(1, 2, 4)] * 2)


def test_gradients_flow_through_the_plain_version():
    ref = _nn_gru(6, 16, 1)
    ours = BiGRU(6, 16)
    ours.load_state_dict(ref.state_dict())
    x = torch.randn(2, 5, 6, requires_grad=True)
    ours(x).square().sum().backward()
    ref_x = x.detach().clone().requires_grad_(True)
    ref(ref_x)[0].square().sum().backward()

    assert torch.allclose(x.grad, ref_x.grad, rtol=1e-4, atol=1e-6)
    for name, p in ref.named_parameters():
        assert torch.allclose(getattr(ours, name).grad, p.grad, rtol=1e-4,
                              atol=1e-6)


def _good(groups=2, batch=3, frames=4, hidden=16, dtype=torch.float32):
    return [torch.zeros(groups, batch, frames, 3 * hidden, dtype=dtype),
            torch.zeros(groups, hidden, 3 * hidden, dtype=dtype),
            torch.zeros(groups, hidden)]


@pytest.mark.parametrize('error, change', [
    (ValueError, lambda a: [a[0][0], *a[1:], 1]),
    (ValueError, lambda a: [a[0], a[1][:, :8], a[2], 1]),
    (ValueError, lambda a: [*a[:2], a[2][:, :8], 1]),
    (TypeError, lambda a: [a[0].half(), a[1].half(), a[2], 1]),
    (TypeError, lambda a: [a[0], a[1].bfloat16(), a[2], 1]),
    (TypeError, lambda a: [*a[:2], a[2].double(), 1]),
    (ValueError, lambda a: [*a, 3]),
    (ValueError, lambda a: [a[0].transpose(1, 2).contiguous().transpose(
        1, 2), *a[1:], 1]),
], ids=['rank', 'w_h shape', 'b_hn shape', 'float16', 'w_h dtype',
        'b_hn dtype', 'reverse_from', 'strided xw'])
def test_op_checks_its_inputs(error, change):
    with pytest.raises(error):
        gk.gru_scan_grouped(*change(_good()))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fake_gives_the_output_shape(dtype):
    with FakeTensorMode():
        args = [torch.empty(a.shape, dtype=a.dtype, device='cuda')
                for a in _good(dtype=dtype)]
        out = gk.gru_scan_grouped_op(*args, 1)
    assert out.shape == (2, 3, 4, 16) and out.dtype == dtype
    assert out.device.type == 'cuda'


def test_cost_counts_the_recurrent_product():
    # 6 row-steps of H = 16 in 2 groups: 2 * 6 * 16 * 48 operations a group
    flops, num_bytes = gk.gru_scan_cost(2, 3, 16, torch.bfloat16, groups=2)
    assert flops == 2 * 2.0 * 6 * 16 * 48
    assert num_bytes == 2 * (2 * (6 * 48 + 16 * 48 + 6 * 16) + 4 * 16)
    from torch.utils.flop_counter import FlopCounterMode

    args = _good(batch=2, frames=3)
    with FlopCounterMode(display=False) as counter:
        gk.gru_scan_grouped(*args, 1)
    assert counter.get_total_flops() == 2 * 6 * 16 * 48 * 2


@pytest.mark.parametrize('hidden,dtype,supported', [
    (256, torch.bfloat16, True), (256, torch.float32, True),
    (512, torch.bfloat16, True), (528, torch.bfloat16, False),
    (368, torch.float32, False), (24, torch.bfloat16, False),
    (256, torch.float16, False)])
def test_supported_widths(hidden, dtype, supported):
    assert gk.gru_supported(hidden, dtype) is supported


def test_geometry_and_plan_at_the_serving_shape():
    geometry = gk.gru_geometry(256, torch.bfloat16, 16)
    assert geometry['threads'] == 128 and geometry['units'] == 32
    assert geometry['bytes'] == sum(geometry['parts'].values()) == 77312
    plan = gk.cluster_plan(64, 256, torch.bfloat16, 30, groups=2)
    assert (plan['rows'], plan['clusters'], plan['waves']) == (5, 26, 1)
    # 16 rows would take 32 clusters, two waves; 22 rows (three n-tiles)
    # take 24, one wave
    plan = gk.cluster_plan(64, 256, torch.bfloat16, 30, groups=8)
    assert (plan['rows'], plan['clusters'], plan['waves']) == (22, 24, 1)
    assert plan['smem_bytes'] == 88448


def test_a_grouped_layer_is_one_call_of_the_op(monkeypatch):
    """Where autograd does not record, each grouped layer calls the op once
    (one launch of kernel G on the card), with the forward directions
    first; where autograd records, the plain version runs instead."""

    calls = []

    def spy(xw, w_h, b_hn, reverse_from):
        calls.append((tuple(xw.shape), reverse_from))
        return gk.gru_scan_grouped(xw, w_h, b_hn, reverse_from)

    monkeypatch.setattr(gru_layers, 'gru_scan_grouped', spy)
    grus = [BiGRU(12, 16, num_layers=2) for _ in range(3)]
    inputs = [torch.randn(2, 5, 12) for _ in grus]
    with torch.no_grad():
        bigru_layers(grus, inputs)
    assert calls == [((6, 2, 5, 48), 3), ((6, 2, 5, 48), 3)]
    calls.clear()
    with torch.inference_mode():
        bigru_layers(grus, inputs)
    assert len(calls) == 2
    calls.clear()
    bigru_layers(grus, inputs)
    assert calls == []




def test_an_unsupported_width_goes_to_the_kernel_and_raises(monkeypatch):
    """Where autograd does not record, a layer calls the op at every width,
    with no plain loop chosen by width; on CUDA tensors kernel G raises for
    a width it does not take (H = 24), so no plain loop runs on the card."""

    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(gru_layers, 'gru_scan_grouped',
                        spy('kernel', gk.gru_scan_grouped))
    monkeypatch.setattr(gru_layers, 'gru_scan_plain',
                        spy('plain', gk.gru_scan_plain))
    with torch.no_grad():
        BiGRU(12, 24)(torch.randn(2, 5, 12))
    assert calls == ['kernel']
    with FakeTensorMode():
        xw = torch.empty((2, 2, 5, 72), device='cuda')
        w_h = torch.empty((2, 24, 72), device='cuda')
        b_hn = torch.empty((2, 24), device='cuda')
        with pytest.raises(ValueError, match='hidden a multiple of 16'):
            gk._launch(xw, w_h, b_hn, 1)
