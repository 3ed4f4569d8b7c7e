"""CQT magnitudes: the Hopper kernels and their plain PyTorch versions.

Port of the fused Pallas kernels ``amt_tools_tpu/ops/pallas_cqt.py``:

- :func:`cqt_mag` (kernel C, ``_cqt_kernel`` via ``cqt_mag_pallas``): frame
  the audio at the bank's support, centred, contract each frame against the
  ``[cos | -sin]`` wavelet bank of ``spectral.wavelet_bank`` and write
  ``sqrt(re^2 + im^2)`` as (B, n_bins, T);
- :func:`cqt_mag_grouped` (kernel D, ``_cqt_grouped_kernel`` via
  ``cqt_mag_pallas_grouped``): the same transform over support-grouped
  banks, each group framed at its own support and centre, written straight
  into its rows of the (B, n_bins, T) output.

Both launch ``csrc/cqt_mag.cu`` for CUDA tensors and run their plain
version for CPU tensors. ``exact`` selects the contraction, as it selects
the Pallas kernel's passes (``pallas_cqt.py:88-113``), and the kernel's
route (:func:`cqt_route`):

- ``True`` (``'ffma'``): IEEE float32 FMAs, the TPU's 6-pass HIGHEST;
- ``'high'`` (``'bf16x3'``): each float32 patch and bank value splits into
  ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` (round to nearest even), and
  ``hi*hi + hi*lo + lo*hi`` accumulates in float32 on the tensor cores: the
  TPU's bf16x3;
- ``False`` (``'bf16'``): the same body with one pass, ``hi*hi``.

The plain versions compute the same function: the split widens hi and lo
to float32 and takes one IEEE float32 framed matmul a pass. The product of
two bf16 values is exact in float32, so only the order of the sums differs
from the kernel. Nothing here takes TF32. Each wrapper counts its launches
(``launches``) and its launches by route (``ffma_launches``,
``bf16x3_launches``, ``bf16_launches``).
"""

import ctypes

import torch

from . import cuda_build, spectral

__all__ = ['cqt_mag', 'cqt_mag_plain', 'cqt_mag_grouped',
           'cqt_mag_grouped_plain', 'cqt_route', 'split_bf16', 'ROUTES',
           'CHUNK_TAPS']

# The kernel's group table holds at most this many groups
MAX_GROUPS = 32

# Taps a chunk of the tensor-core route (csrc/cqt_mag.cu kTcChunk): what
# lands in shared memory and is split at once
CHUNK_TAPS = 32

# Frames a plain-version matmul takes at once: at 64 clips of 60 s and a
# 24,576-sample support the whole frame matrix would be about 16 GB
FRAME_CHUNK = 256

# exact -> the kernel's route and its bf16 passes (0: IEEE float32 FMAs)
ROUTES = {'ffma': 0, 'bf16x3': 3, 'bf16': 1}

_SIGNATURES = {
    'cqt_mag_f32': [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p],
    'cqt_mag_grouped_f32': [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                            ctypes.c_void_p],
}


def cqt_route(exact):
    """The kernel route of an ``exact`` mode, read as the Pallas kernel
    reads it: ``'bf16x3'`` for 'high', else ``'ffma'`` when true and
    ``'bf16'`` when false."""

    if exact == 'high':
        return 'bf16x3'
    return 'ffma' if exact else 'bf16'


def split_bf16(x):
    """float32 -> (hi, lo) bf16 with ``hi = bf16(x)``, ``lo = bf16(x - hi)``,
    both rounded to nearest even (``pallas_cqt.py:97-105``)."""

    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _contract(chunk, bank, passes):
    """Framed contraction of one chunk of frames in the route's passes."""

    if not passes:
        return torch.matmul(chunk, bank)
    c_hi, c_lo = (part.float() for part in split_bf16(chunk))
    b_hi, b_lo = (part.float() for part in split_bf16(bank))
    acc = torch.matmul(c_hi, b_hi)
    if passes == 3:
        acc = acc + torch.matmul(c_hi, b_lo)
        acc = acc + torch.matmul(c_lo, b_hi)
    return acc


def cqt_mag_plain(audio, bank, support, hop_length, exact=True):
    """(B, N) audio -> (B, n_bins, T) magnitudes: a framed float32 matmul.

    Frames the audio at the bank's support (centred) and contracts
    :data:`FRAME_CHUNK` frames at a time, so at most a (B, chunk, support)
    frame block is materialized (the JAX package's ``spectral.cqt_mag``).
    ``exact='high'`` splits both operands into bf16 hi and lo and sums
    ``hi*hi + hi*lo + lo*hi`` in float32, ``exact=False`` takes ``hi*hi``.
    """

    n_bins = bank.shape[-1] // 2
    passes = ROUTES[cqt_route(exact)]

    frames = spectral.frame_signal(audio, support, hop_length, center=True)
    num_frames = frames.shape[-2]

    out = audio.new_empty(frames.shape[:-2] + (n_bins, num_frames))
    for start in range(0, num_frames, FRAME_CHUNK):
        resp = _contract(frames[..., start: start + FRAME_CHUNK, :], bank,
                         passes)
        re, im = resp[..., :n_bins], resp[..., n_bins:]
        out[..., start: start + FRAME_CHUNK] = torch.sqrt(
            re * re + im * im).transpose(-1, -2)

    return out


def cqt_mag_grouped_plain(audio, bank_stack, supports, bins_per_group,
                          hop_length, exact=True):
    """Grouped banks -> (B, sum(bins_per_group), T): each group's rows of
    ``bank_stack`` and true columns, framed at its own support, then the
    groups' magnitudes concatenated along the bins."""

    gb = bank_stack.shape[-1] // 2
    parts = []
    row0 = 0
    for support, bins in zip(supports, bins_per_group):
        rows = bank_stack[row0: row0 + support]
        bank = torch.cat([rows[:, :bins], rows[:, gb: gb + bins]], dim=1)
        parts.append(cqt_mag_plain(audio, bank, support, hop_length, exact))
        row0 += support

    return torch.cat(parts, dim=-2)


def _check_inputs(audio, bank, rows, name):
    cuda_build.require_plain(name, audio=audio, bank=bank)
    if audio.dim() != 2:
        raise ValueError(f'audio must be (B, N), got shape {tuple(audio.shape)}')
    if audio.dtype != torch.float32 or bank.dtype != torch.float32:
        raise TypeError(f'{name} takes float32 audio and bank, got '
                        f'{audio.dtype} and {bank.dtype}')
    if bank.dim() != 2 or bank.shape[0] != rows or bank.shape[1] % 2:
        raise ValueError(f'bank must be ({rows}, 2 * bins), got '
                         f'{tuple(bank.shape)}')
    if audio.device != bank.device:
        raise ValueError(f'audio on {audio.device} but bank on {bank.device}')
    if not (audio.is_contiguous() and bank.is_contiguous()):
        raise ValueError(f'{name} takes contiguous audio and bank')
    if audio.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} runs on CUDA or CPU tensors, not '
                         f'{audio.device}')


def _launch(wrapper, function, exact, audio, bank, num_bins, hop_length,
            *args):
    """Allocate the (B, num_bins, T) output, launch ``function`` on it in
    the route of ``exact`` and count the launch on ``wrapper``."""

    batch, num_samples = audio.shape
    frames = 1 + num_samples // hop_length
    out = torch.empty((batch, num_bins, frames), dtype=torch.float32,
                      device=audio.device)
    if batch == 0:
        return out

    route = cqt_route(exact)
    lib = cuda_build.library('cqt_mag', _SIGNATURES)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, function)(audio.data_ptr(), bank.data_ptr(),
                                        out.data_ptr(), batch, num_samples,
                                        *args, ROUTES[route], stream)
    cuda_build.check(status, function)
    cuda_build.count(wrapper, 'launches', f'{route}_launches')

    return out


def cqt_mag(audio, bank, support, hop_length, exact=True):
    """CQT magnitudes of (B, N) float32 audio -> (B, n_bins, T) float32.

    ``bank`` is ``spectral.wavelet_bank(...)[0]``, (support, 2 * n_bins),
    as a float32 tensor on the audio's device. CUDA tensors go through
    kernel C on the route of ``exact`` (or raise); CPU tensors through
    :func:`cqt_mag_plain` with the same ``exact``. Any hop works.
    """

    _check_inputs(audio, bank, support, 'cqt_mag')

    if audio.device.type == 'cpu':
        return cqt_mag_plain(audio, bank, support, hop_length, exact)

    n_bins = bank.shape[1] // 2
    frames = 1 + audio.shape[1] // hop_length
    return _launch(cqt_mag, 'cqt_mag_f32', exact, audio, bank, n_bins,
                   hop_length, support, hop_length, frames, n_bins)


def cqt_mag_grouped(audio, bank_stack, supports, bins_per_group, hop_length,
                    exact=True):
    """CQT magnitudes over support-grouped banks -> (B, sum(bins), T).

    ``bank_stack`` is (sum(supports), 2 * gb): each group's wavelet bank
    (``spectral.wavelet_bank`` on its bins), column-padded to the widest
    group ``gb`` and row-concatenated in group order, as ``CQT`` builds it.
    ``bins_per_group`` gives each group's true bin count. CUDA tensors go
    through kernel D on the route of ``exact`` (or raise); CPU tensors
    through :func:`cqt_mag_grouped_plain` with the same ``exact``.
    """

    supports = tuple(int(s) for s in supports)
    bins_per_group = tuple(int(b) for b in bins_per_group)
    _check_inputs(audio, bank_stack, sum(supports), 'cqt_mag_grouped')
    gb = bank_stack.shape[1] // 2
    if (len(supports) != len(bins_per_group) or not supports or
            any(b < 1 or b > gb for b in bins_per_group) or
            any(s < 1 for s in supports)):
        raise ValueError(f'each of the groups needs a support and 1..{gb} '
                         f'bins, got supports {supports} and bins '
                         f'{bins_per_group}')

    if audio.device.type == 'cpu':
        return cqt_mag_grouped_plain(audio, bank_stack, supports,
                                     bins_per_group, hop_length, exact)
    if len(supports) > MAX_GROUPS:
        raise ValueError(f'kernel D takes at most {MAX_GROUPS} groups, got '
                         f'{len(supports)}')

    groups = len(supports)
    n_bins = sum(bins_per_group)
    frames = 1 + audio.shape[1] // hop_length
    return _launch(cqt_mag_grouped, 'cqt_mag_grouped_f32', exact, audio,
                   bank_stack, n_bins, hop_length, hop_length, frames, n_bins,
                   gb, groups, (ctypes.c_int * groups)(*supports),
                   (ctypes.c_int * groups)(*bins_per_group))


for _wrapper in (cqt_mag, cqt_mag_grouped):
    _wrapper.launches = 0
    for _route in ROUTES:
        setattr(_wrapper, f'{_route}_launches', 0)
