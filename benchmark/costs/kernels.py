"""The least work of the port's hand-written kernels, frozen.

Copies of ``ops/stft_kernel.py`` ``cost`` (kernel A, on its FFT route),
``ops/lstm_kernel.py`` ``scan_cost`` (B, and E with ``residuals``) and
``bptt_cost`` (F), and ``ops/cqt_kernel.py`` ``fft_flops_per_frame`` (C and
D), each ``(flops, bytes)``. The operations are the least the function
needs whatever implements it (a real FFT a frame for A, a multi-rate FFT
CQT for C and D, the recurrent product for B, E and F); the bytes are each
input read and each output written once. The feature stages add the
projection and the dB scaling around A, and the bank around C and D.
"""

import math

import numpy as np

F32 = 4


def stft_cost(batch, num_samples, n_fft, hop_length, n_bins):
    """Kernel A on its FFT route: a real FFT of each centred frame (2.5 n
    log2 n), the window, ``re^2 + im^2``; the audio read, the window and
    twiddle table read, the power written."""

    frames = 1 + num_samples // hop_length
    flops = batch * frames * (2.5 * n_fft * math.log2(n_fft) + n_fft +
                              3.0 * n_bins)
    num_bytes = F32 * (batch * num_samples + n_fft + 2 * twiddles(n_fft) +
                       batch * n_bins * frames)

    return float(flops), float(num_bytes)


def twiddles(n_fft):
    """The FFT route's twiddle count (``stft_kernel.fft_geometry``)."""

    m = n_fft // 2
    n_tw = m // 2 + 1
    width = m
    while width >= 4:
        n_tw += 3 * (width // 4)
        width //= 4
    n_tw += n_tw % 2

    return n_tw


def scan_cost(batch, frames, hidden, size, residuals=False):
    """One launch of kernel B (E with ``residuals``) at ``size`` bytes a
    value: the recurrent product, 2 H 4H operations a row and step; xw and
    W_h read and h written once, E's float32 gates and cell states
    written."""

    rows = batch * frames
    flops = 2.0 * rows * hidden * 4 * hidden
    num_bytes = size * (rows * 4 * hidden + hidden * 4 * hidden +
                        rows * hidden)
    if residuals:
        num_bytes += F32 * rows * 5 * hidden

    return flops, float(num_bytes)


def bptt_cost(batch, frames, hidden, size):
    """One launch of kernel F: the carry product, 2 4H H operations a row
    and step; the float32 gates and cell states read and da written, dout
    and W_h^T read at ``size`` bytes a value."""

    rows = batch * frames
    flops = 2.0 * rows * hidden * 4 * hidden
    num_bytes = (F32 * (rows * 4 * hidden + rows * hidden +
                        rows * 4 * hidden) +
                 size * (rows * hidden + 4 * hidden * hidden))

    return flops, float(num_bytes)


def cqt_flops_per_frame(lengths):
    """A frame of a multi-rate FFT CQT over wavelets of these lengths: bins
    an octave apart share a decimation, each decimation one real FFT of its
    longest decimated wavelet (2.5 n log2 n, n a power of two), plus one
    complex multiply-add a bin."""

    lengths = np.asarray(lengths, dtype=np.float64)
    lengths = lengths[lengths > 0]
    flops = 8.0 * len(lengths)
    if not len(lengths):
        return flops
    octave = np.floor(np.log2(lengths / lengths.min()))
    for o in np.unique(octave):
        n = 2 ** int(np.ceil(np.log2(lengths[octave == o].max() / 2 ** o)))
        flops += 2.5 * n * np.log2(n)

    return float(flops)


def mel_stage_cost(batch, num_samples, n_fft, hop_length, n_mels):
    """Audio to [0, 1] mel features: kernel A's operations, the mel
    projection's, and the dB scaling's few a value; the audio, window and
    mel bank read and the features written once (the power spectrum is an
    intermediate a fused stage never writes)."""

    n_bins = n_fft // 2 + 1
    frames = 1 + num_samples // hop_length
    flops, _ = stft_cost(batch, num_samples, n_fft, hop_length, n_bins)
    flops += batch * frames * n_mels * (2.0 * n_bins + 4.0)
    num_bytes = F32 * (batch * num_samples + n_fft + n_mels * n_bins +
                       batch * n_mels * frames)

    return flops, float(num_bytes)


def cqt_stage_cost(batch, num_samples, hop_length, lengths):
    """Audio to [0, 1] CQT features: a multi-rate FFT CQT a frame and the
    dB scaling; the audio and the wavelets (cos and sin) read and the
    features written once."""

    frames = 1 + num_samples // hop_length
    n_bins = len(lengths)
    flops = batch * frames * (cqt_flops_per_frame(lengths) + 4.0 * n_bins)
    num_bytes = F32 * (batch * num_samples + 2 * int(np.sum(lengths)) +
                       batch * n_bins * frames)

    return float(flops), float(num_bytes)


def least_seconds(flops, num_bytes, peak_flops, peak_bytes):
    """The least time for the work: operations over the peak rate or bytes
    over the bandwidth, whichever is longer."""

    return max(flops / peak_flops, num_bytes / peak_bytes)
