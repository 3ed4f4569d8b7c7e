"""At which width a LSTM layer runs the kernels, decided from its shape.

``ops.lstm_kernel.scan_supported`` says where kernels B, E and F launch on
the card: H a multiple of 16, at most 1024, and one row's buffers within a
block's shared memory. On a CUDA tensor the layers run any other width up
to 1024 through the kernels zero-padded to the next multiple of 16
(``ops.lstm.kernel_width`` and ``padded_recurrence``), where the JAX layers
fall back to their XLA scan (``amt_tools_tpu/ops/lstm.py:235-240``); the
card test of that route is in ``tests/test_torch_cuda.py``. Here: the
predicate, the width chosen, and the padded recurrence's outputs and
autograd gradients against the unpadded one through the kernels' plain
versions at H = 24 and 40 (the added units are zero throughout; float32
products over more zero terms in another blocking through 30 steps: 1e-6
float32, and bf16 outputs equal).
"""

import pytest
import torch

from amt_tools_tpu_torch.models.onsetsframes import LanguageModel
from amt_tools_tpu_torch.ops import lstm as lstm_layers
from amt_tools_tpu_torch.ops.lstm_kernel import (MAX_HIDDEN, lstm_scan,
                                                 lstm_scan_grad,
                                                 scan_supported)

torch.set_num_threads(1)

TOL = 1e-6


@pytest.mark.parametrize('hidden,supported', [
    (24, False),    # not a multiple of 16
    (16, True),
    (256, True),    # the recipe's width
    (1024, True),   # MAX_HIDDEN, W_h streamed
    (1040, False),  # above MAX_HIDDEN
])
def test_scan_supported(hidden, supported):
    for dtype in (torch.float32, torch.bfloat16):
        assert scan_supported(hidden, dtype) is supported
    assert MAX_HIDDEN == 1024


def test_scan_supported_rejects_degenerate_widths():
    assert not scan_supported(0, torch.float32)
    assert not scan_supported(8, torch.float32)


@pytest.mark.parametrize('hidden,width', [
    (24, 32), (40, 48), (48, 48), (1, 16), (1000, 1008), (1024, 1024),
    (1030, 1030),  # above MAX_HIDDEN: not padded, the kernels raise
])
def test_kernel_width(hidden, width):
    for dtype in (torch.float32, torch.bfloat16):
        assert lstm_layers.kernel_width(hidden, dtype) == width


def test_every_width_up_to_max_hidden_runs_the_kernels():
    for dtype in (torch.float32, torch.bfloat16):
        for hidden in range(1, MAX_HIDDEN + 1):
            assert scan_supported(lstm_layers.kernel_width(hidden, dtype),
                                  dtype), hidden


@pytest.mark.parametrize('hidden', [24, 40])
@pytest.mark.parametrize('reverse', [False, True])
def test_padded_recurrence_matches_the_unpadded_one(hidden, reverse):
    """Outputs and gradients of the padded recurrence against kernel B's
    plain version and the custom VJP over E's and F's plain versions at
    the layer's own width."""

    g = torch.Generator().manual_seed(hidden)
    xw = torch.randn(3, 30, 4 * hidden, generator=g)
    w_h = torch.randn(hidden, 4 * hidden, generator=g) * 0.2
    dout = torch.randn(3, 30, hidden, generator=g)
    width = lstm_layers.kernel_width(hidden, torch.float32)

    xw_a, w_a = xw.clone().requires_grad_(), w_h.clone().requires_grad_()
    out = lstm_layers.padded_recurrence(xw_a, w_a, reverse, width)
    (out * dout).sum().backward()

    xw_b, w_b = xw.clone().requires_grad_(), w_h.clone().requires_grad_()
    ref = lstm_scan_grad(xw_b, w_b, reverse)
    (ref * dout).sum().backward()

    assert out.shape == (3, 30, hidden)
    torch.testing.assert_close(out, ref, rtol=0, atol=TOL)
    torch.testing.assert_close(xw_a.grad, xw_b.grad, rtol=0, atol=TOL)
    torch.testing.assert_close(w_a.grad, w_b.grad, rtol=0, atol=TOL)

    with torch.no_grad():
        torch.testing.assert_close(
            lstm_layers.padded_recurrence(xw, w_h, reverse, width),
            lstm_scan(xw, w_h, reverse), rtol=0, atol=TOL)
        bf16 = xw.to(torch.bfloat16)
        assert torch.equal(
            lstm_layers.padded_recurrence(bf16, w_h, reverse, width),
            lstm_scan(bf16, w_h.to(torch.bfloat16), reverse))


def test_cpu_layers_keep_the_kernels_plain_versions(monkeypatch):
    """On the CPU the layers call the kernels' wrappers at their own width,
    which take their plain versions; padding is only for the card."""

    def refuse(*args):
        raise AssertionError('a CPU layer padded its recurrence')

    monkeypatch.setattr(lstm_layers, '_padded_scan', refuse)
    model = LanguageModel(40, 48, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = model(torch.randn(2, 9, 40))
    assert out.shape == (2, 9, 48)
