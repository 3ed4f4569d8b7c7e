"""STFT power spectrum: the Hopper kernel and its plain PyTorch version.

Port of the fused Pallas kernel ``amt_tools_tpu/ops/pallas_stft.py``
(``_stft_kernel``, called through ``stft_power_pallas``): frame the audio,
contract each frame against the windowed ``[cos | -sin]`` DFT bank of
``spectral.dft_bank`` and write ``re^2 + im^2`` as (B, n_fft//2+1, T).

:func:`stft_power` launches ``csrc/stft_power.cu`` for CUDA tensors and runs
:func:`stft_power_plain` for CPU tensors. Both contract in IEEE float32: a
single bf16 or TF32 pass puts quiet bins of tonal audio tens of dB off (the
reason the Pallas kernel runs a bf16x3 split).
"""

import ctypes

import torch

from . import cuda_build, spectral

__all__ = ['stft_power', 'stft_power_plain']

_SIGNATURES = {
    'stft_power_f32': [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p],
}


def stft_power_plain(audio, bank, n_fft, hop_length, center=True):
    """(B, N) audio -> (B, n_bins, T) power: a framed float32 matmul."""

    frames = spectral.frame_signal(audio, n_fft, hop_length, center=center)
    resp = torch.matmul(frames, bank)

    n_bins = bank.shape[-1] // 2
    re, im = resp[..., :n_bins], resp[..., n_bins:]

    return (re * re + im * im).transpose(-1, -2)


def _check_inputs(audio, bank, n_fft):
    if audio.dim() != 2:
        raise ValueError(f'audio must be (B, N), got shape {tuple(audio.shape)}')
    if audio.dtype != torch.float32 or bank.dtype != torch.float32:
        raise TypeError(f'stft_power takes float32 audio and bank, got '
                        f'{audio.dtype} and {bank.dtype}')
    if bank.dim() != 2 or bank.shape[0] != n_fft or bank.shape[1] % 2:
        raise ValueError(f'bank must be (n_fft={n_fft}, 2 * n_bins), got '
                         f'{tuple(bank.shape)}')
    if audio.device != bank.device:
        raise ValueError(f'audio on {audio.device} but bank on {bank.device}')
    if not (audio.is_contiguous() and bank.is_contiguous()):
        raise ValueError('stft_power takes contiguous audio and bank')


def stft_power(audio, bank, n_fft, hop_length, center=True):
    """Power spectrogram of (B, N) float32 audio -> (B, n_bins, T) float32.

    ``bank`` is ``spectral.dft_bank(n_fft, ...)`` as a float32 tensor on the
    audio's device. CUDA tensors go through the Hopper kernel (or raise);
    CPU tensors through :func:`stft_power_plain`. Any hop works: it need not
    divide n_fft.
    """

    _check_inputs(audio, bank, n_fft)

    if audio.device.type == 'cpu':
        return stft_power_plain(audio, bank, n_fft, hop_length, center)
    if audio.device.type != 'cuda':
        raise ValueError(f'stft_power runs on CUDA or CPU tensors, not '
                         f'{audio.device}')

    batch, num_samples = audio.shape
    n_bins = bank.shape[1] // 2
    frames = spectral.num_frames(num_samples, n_fft, hop_length, center)
    pad_left = n_fft // 2 if center else 0

    out = torch.empty((batch, n_bins, frames), dtype=torch.float32,
                      device=audio.device)
    if batch == 0 or frames == 0:
        return out

    lib = cuda_build.library('stft_power', _SIGNATURES)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.stft_power_f32(audio.data_ptr(), bank.data_ptr(),
                                    out.data_ptr(), batch, num_samples, n_fft,
                                    hop_length, pad_left, frames, n_bins,
                                    stream)
    cuda_build.check(status, 'stft_power')
    stft_power.launches += 1

    return out


stft_power.launches = 0
