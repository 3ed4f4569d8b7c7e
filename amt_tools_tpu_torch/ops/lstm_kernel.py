"""LSTM recurrence: the Hopper kernel and its plain PyTorch version.

Port of the fused Pallas kernel ``amt_tools_tpu/ops/pallas_lstm.py``
(``_lstm_kernel``, called through ``lstm_scan_pallas``), forward only:
the whole-sequence recurrence from a zero carry over hoisted input
projections. :func:`lstm_scan` launches ``csrc/lstm_scan.cu`` for CUDA
tensors and runs :func:`lstm_scan_plain` for CPU tensors.

Numerics follow the Pallas kernel (``pallas_lstm.py:71-109``): the carry is
float32; with bf16 projections the recurrent product reads bf16 ``h`` and
``W_h`` with float32 accumulation, the gates round to bf16 and the sigmoid
takes the tanh form ``0.5 * tanh(0.5 x) + 0.5``. The JAX XLA scan instead
rounds the carry to bf16; the port follows the kernel.
"""

import ctypes

import torch

from . import cuda_build

__all__ = ['lstm_scan', 'lstm_scan_plain']

MAX_HIDDEN = 1024  # the kernel's carry (3 x 4 rows x H floats) fits 48 KB

_SIGNATURES = {
    'lstm_scan': [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p],
}


def _sigmoid_tanh_form(x):
    return 0.5 * torch.tanh(0.5 * x) + 0.5


def lstm_scan_plain(xw, w_h, reverse=False):
    """(B, T, 4H) projections, (H, 4H) weights -> (B, T, H): a loop over T."""

    batch, frames, four_h = xw.shape
    hidden = four_h // 4
    bf16 = xw.dtype == torch.bfloat16

    # bf16 operands are exact in float32, so this is the kernel's product
    # with float32 accumulation
    w = w_h.to(xw.dtype).float()
    h = torch.zeros((batch, hidden), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    out = torch.empty((batch, frames, hidden), dtype=xw.dtype,
                      device=xw.device)

    steps = range(frames - 1, -1, -1) if reverse else range(frames)
    for t in steps:
        gates = xw[:, t].float() + h.to(xw.dtype).float() @ w
        if bf16:
            gates = gates.to(torch.bfloat16)
            i_g = _sigmoid_tanh_form(gates[:, 0 * hidden: 1 * hidden])
            f_g = _sigmoid_tanh_form(gates[:, 1 * hidden: 2 * hidden])
            g_g = torch.tanh(gates[:, 2 * hidden: 3 * hidden])
            o_g = _sigmoid_tanh_form(gates[:, 3 * hidden: 4 * hidden])
            c = f_g.float() * c + (i_g * g_g).float()
            h = o_g.float() * torch.tanh(c)
        else:
            i_g = torch.sigmoid(gates[:, 0 * hidden: 1 * hidden])
            f_g = torch.sigmoid(gates[:, 1 * hidden: 2 * hidden])
            g_g = torch.tanh(gates[:, 2 * hidden: 3 * hidden])
            o_g = torch.sigmoid(gates[:, 3 * hidden: 4 * hidden])
            c = f_g * c + i_g * g_g
            h = o_g * torch.tanh(c)
        out[:, t] = h.to(xw.dtype)

    return out


def _check_inputs(xw, w_h):
    if xw.dim() != 3 or xw.shape[-1] % 4:
        raise ValueError(f'xw must be (B, T, 4H), got shape {tuple(xw.shape)}')
    hidden = xw.shape[-1] // 4
    if tuple(w_h.shape) != (hidden, 4 * hidden):
        raise ValueError(f'w_h must be ({hidden}, {4 * hidden}), got '
                         f'{tuple(w_h.shape)}')
    if xw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'lstm_scan takes float32 or bf16 xw, got {xw.dtype}')
    if w_h.dtype != xw.dtype:
        raise TypeError(f'w_h ({w_h.dtype}) must match xw ({xw.dtype})')
    if xw.device != w_h.device:
        raise ValueError(f'xw on {xw.device} but w_h on {w_h.device}')
    if not (xw.is_contiguous() and w_h.is_contiguous()):
        raise ValueError('lstm_scan takes contiguous xw and w_h')


def lstm_scan(xw, w_h, reverse=False):
    """Whole-sequence LSTM from a zero carry: (B, T, 4H) -> (B, T, H).

    ``xw`` holds the hoisted input projections including the bias, ``w_h``
    the (H, 4H) recurrent kernel in the same dtype (float32 or bf16; gate
    order i, f, g, o). ``reverse`` walks back to front and writes outputs in
    natural order. CUDA tensors go through the Hopper kernel (or raise); CPU
    tensors through :func:`lstm_scan_plain`.
    """

    _check_inputs(xw, w_h)

    if xw.device.type == 'cpu':
        return lstm_scan_plain(xw, w_h, reverse)
    if xw.device.type != 'cuda':
        raise ValueError(f'lstm_scan runs on CUDA or CPU tensors, not '
                         f'{xw.device}')

    batch, frames, four_h = xw.shape
    hidden = four_h // 4
    if hidden > MAX_HIDDEN:
        raise ValueError(f'lstm_scan kernel supports hidden <= {MAX_HIDDEN}, '
                         f'got {hidden}')

    out = torch.empty((batch, frames, hidden), dtype=xw.dtype,
                      device=xw.device)
    if batch == 0 or frames == 0:
        return out

    lib = cuda_build.library('lstm_scan', _SIGNATURES)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.lstm_scan(xw.data_ptr(), w_h.data_ptr(), out.data_ptr(),
                               batch, frames, hidden, int(reverse),
                               int(xw.dtype == torch.bfloat16), stream)
    cuda_build.check(status, 'lstm_scan')
    lstm_scan.launches += 1

    return out


lstm_scan.launches = 0
