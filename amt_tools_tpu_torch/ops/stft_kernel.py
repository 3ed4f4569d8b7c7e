"""STFT power spectrum: the Hopper kernel and its plain PyTorch version.

Port of the fused Pallas kernel ``amt_tools_tpu/ops/pallas_stft.py``
(``_stft_kernel``, called through ``stft_power_pallas``): frame the audio,
window each frame, take its real DFT and write ``re^2 + im^2`` as
(B, n_fft//2+1, T).

:func:`stft_power` launches ``csrc/stft_power.cu`` for CUDA tensors and runs
:func:`stft_power_plain` for CPU tensors. On the card it takes one of two
routes by shape (:func:`stft_route`): a radix-4 FFT in shared memory for a
power-of-two n_fft whose buffers fit a block, a DFT implicit GEMM against the
bank for any other n_fft. Both compute in IEEE float32: a single bf16 or
TF32 pass puts quiet bins of tonal audio tens of dB off (the reason the
Pallas kernel runs a bf16x3 split).
"""

import ctypes

import numpy as np
import torch

from . import cuda_build, spectral

__all__ = ['stft_power', 'stft_power_plain', 'stft_route', 'fft_geometry',
           'fft_tile_frames', 'fft_twiddles']

# FFT route: at most this many frames a block (two blocks share an SM at
# n_fft 2048), within the shared memory a block may use on Hopper (227 KB)
FFT_MAX_TILE_FRAMES = 8
MAX_SHARED_BYTES = 232448

_SIGNATURES = {
    'stft_power_f32': [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p],
    'stft_power_fft_f32': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 +
                          [ctypes.c_void_p],
}

_twiddle_cache = {}


def fft_geometry(n_fft, hop_length, tile_frames):
    """Shared-memory layout of the FFT route's block, which the launch passes
    to the kernel (``csrc/stft_power.cu``): complex frame buffers of
    ``frame_pad`` values a frame (n_fft/2 with one padding value after every
    8, the kernel's ``pad``, and one more), ``z_count`` complex values in
    all; the ``n_tw`` twiddles of :func:`fft_twiddles`; the audio span of
    the tile, ``span_len`` floats with 3 of alignment slack; ``bytes`` in
    all."""

    m = n_fft // 2
    frame_pad = m + m // 8 + 1
    z_count = (tile_frames * frame_pad + 1) // 2 * 2
    n_tw = m // 2 + 1
    width = m
    while width >= 4:
        n_tw += 3 * (width // 4)
        width //= 4
    n_tw += n_tw % 2
    span_len = ((tile_frames - 1) * hop_length + n_fft + 6) // 4 * 4

    return {'frame_pad': frame_pad, 'z_count': z_count, 'n_tw': n_tw,
            'span_len': span_len,
            'bytes': 8 * (z_count + n_tw) + 4 * span_len}


def fft_tile_frames(n_fft, hop_length):
    """Frames a block on the FFT route: the largest power of two up to
    ``FFT_MAX_TILE_FRAMES`` whose buffers fit ``MAX_SHARED_BYTES``; 0 when
    n_fft is no power of two or not even one frame fits."""

    if n_fft < 2 or n_fft & (n_fft - 1):
        return 0
    tile = FFT_MAX_TILE_FRAMES
    while tile and fft_geometry(n_fft, hop_length, tile)['bytes'] > \
            MAX_SHARED_BYTES:
        tile //= 2

    return tile


def stft_route(n_fft, hop_length, n_bins):
    """'fft' where the FFT route takes the shape (a power-of-two n_fft that
    fits, and the full n_fft//2 + 1 bins), else 'dft'."""

    if n_bins == n_fft // 2 + 1 and fft_tile_frames(n_fft, hop_length):
        return 'fft'

    return 'dft'


def fft_twiddles(n_fft):
    """The FFT route's twiddle table, (entries, 2) float32, built in
    float64 and rounded once: for each radix-4 pass over sub-transforms of
    width L (n_fft/2, n_fft/8, ... down to 4), W_L^(j m) = exp(-2 pi i j m / L)
    for m = 1, 2, 3 and j < L/4; then the split's W_N^k, k <= n_fft/4. Padded
    to an even count with a zero."""

    m = n_fft // 2
    parts = []
    width = m
    while width >= 4:
        j = np.arange(width // 4)
        parts += [np.exp(-2j * np.pi * j * mm / width) for mm in (1, 2, 3)]
        width //= 4
    parts.append(np.exp(-2j * np.pi * np.arange(m // 2 + 1) / n_fft))
    table = np.concatenate(parts)
    if len(table) % 2:
        table = np.append(table, 0)

    return np.stack([table.real, table.imag], axis=-1).astype(np.float32)


def _device_twiddles(n_fft, device):
    return cuda_build.cached(
        _twiddle_cache, (n_fft, device),
        lambda: torch.from_numpy(fft_twiddles(n_fft)).to(device))


def stft_power_plain(audio, bank, n_fft, hop_length, center=True):
    """(B, N) audio -> (B, n_bins, T) power: a framed float32 matmul."""

    frames = spectral.frame_signal(audio, n_fft, hop_length, center=center)
    resp = torch.matmul(frames, bank)

    n_bins = bank.shape[-1] // 2
    re, im = resp[..., :n_bins], resp[..., n_bins:]

    return (re * re + im * im).transpose(-1, -2)


def _check_inputs(audio, bank, n_fft):
    cuda_build.require_plain('stft_power', audio=audio, bank=bank)
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
    audio's device. CUDA tensors go through the Hopper kernel (or raise),
    by the route :func:`stft_route` names: the FFT route reads the window
    from the bank's bin-0 cosine column. ``stft_power.launches`` counts both
    routes, ``stft_power.fft_launches`` the FFT route alone. CPU tensors go
    through :func:`stft_power_plain`. Any hop works: it need not divide
    n_fft.
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

    route = stft_route(n_fft, hop_length, n_bins)
    lib = cuda_build.library('stft_power', _SIGNATURES)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == 'fft':
            # The bank's bin-0 cosine column is the (padded) window
            window = bank[:, 0].contiguous()
            twiddles = _device_twiddles(n_fft, audio.device)
            tile = fft_tile_frames(n_fft, hop_length)
            geo = fft_geometry(n_fft, hop_length, tile)
            status = lib.stft_power_fft_f32(
                audio.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
                out.data_ptr(), batch, num_samples, n_fft, hop_length,
                pad_left, frames, tile, geo['frame_pad'], geo['z_count'],
                geo['n_tw'], geo['span_len'], geo['bytes'], stream)
        else:
            status = lib.stft_power_f32(audio.data_ptr(), bank.data_ptr(),
                                        out.data_ptr(), batch, num_samples,
                                        n_fft, hop_length, pad_left, frames,
                                        n_bins, stream)
    cuda_build.check(status, f'stft_power ({route} route)')
    cuda_build.count(stft_power, 'launches',
                     *(('fft_launches',) if route == 'fft' else ()))

    return out


stft_power.launches = 0
stft_power.fft_launches = 0
