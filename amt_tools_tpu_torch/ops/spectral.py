"""Spectral primitives on tensors, and the filterbank builders (host numpy).

The numpy builders (``hann_window``, ``dft_bank``, ``hz_to_mel``,
``mel_to_hz``, ``mel_filterbank``, ``cqt_frequencies``, ``wavelet_lengths``,
``wavelet_bank``) are copies of ``amt_tools_tpu/ops/spectral.py`` and agree
with it bit for bit. The tensor functions (``frame_signal``, ``stft_mag``,
``power_to_db``, ``amplitude_to_db``) are PyTorch counterparts of its jnp
functions, with the same frame algebra: T = 1 + N // hop with centre
padding of half the frame length. Its ``cqt_mag`` is
``cqt_kernel.cqt_mag_plain`` here.
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    'hann_window',
    'frame_signal',
    'stft_mag',
    'dft_bank',
    'power_to_db',
    'amplitude_to_db',
    'hz_to_mel', 'mel_to_hz',
    'mel_filterbank',
    'cqt_frequencies',
    'wavelet_lengths',
    'wavelet_bank',
]


##################################################
# WINDOWS / FRAMING                              #
##################################################


def hann_window(win_length, periodic=True):
    """Hann window (periodic by default, matching FFT analysis convention)."""

    n = win_length + 1 if periodic else win_length
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / max(1, n - 1))

    return window[:win_length].astype(np.float32)


def num_frames(num_samples, frame_length, hop_length, center=True):
    """Frame count of (..., N) audio: 1 + N // hop centred, else full frames."""

    if center:
        return 1 + num_samples // hop_length

    return max(0, 1 + (num_samples - frame_length) // hop_length)


def frame_signal(audio, frame_length, hop_length, center=True):
    """Split (..., N) audio into a (..., T, frame_length) strided view.

    With ``center`` the signal is zero-padded by ``frame_length // 2`` on the
    left and enough on the right that the last frame lies in bounds.
    """

    num_samples = audio.shape[-1]
    frames = num_frames(num_samples, frame_length, hop_length, center)

    if frames == 0:
        return audio.new_zeros(audio.shape[:-1] + (0, frame_length))

    if center:
        pad = frame_length // 2
        last_index = (frames - 1) * hop_length + frame_length
        rpad = max(pad, last_index - (num_samples + pad))
        audio = F.pad(audio, (pad, rpad))

    return audio.unfold(-1, frame_length, hop_length)[..., :frames, :]


##################################################
# STFT                                           #
##################################################


def stft_mag(audio, n_fft, hop_length, win_length=None, center=True, window=None):
    """Magnitude spectrogram of (..., N) audio -> (..., n_fft//2+1, T)."""

    if win_length is None:
        win_length = n_fft
    if window is None:
        window = hann_window(win_length)
    window = torch.as_tensor(window, device=audio.device)

    # Center-pad the window to n_fft (librosa convention)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))

    frames = frame_signal(audio, n_fft, hop_length, center=center)
    spectrum = torch.fft.rfft(frames * window, n=n_fft, dim=-1)

    # (..., T, F) -> (..., F, T)
    return spectrum.abs().transpose(-1, -2)


def dft_bank(n_fft, win_length=None, window=None, dtype=np.float32):
    """Windowed real-DFT matmul kernel: (n_fft, 2 * (n_fft//2 + 1)).

    Columns are ``[cos | -sin]`` halves so that framed audio
    ``(T, n_fft) @ kernel`` yields the real and imaginary rfft responses.
    Built in float64 on the host and cast once. ``win_length < n_fft``
    center-pads the window (librosa convention).
    """

    if win_length is None:
        win_length = n_fft
    if window is None:
        window = hann_window(win_length)

    window = np.asarray(window, dtype=np.float64)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))

    bins = np.arange(n_fft // 2 + 1)
    angles = 2 * np.pi * np.outer(np.arange(n_fft), bins) / n_fft

    kernel = np.concatenate([np.cos(angles) * window[:, None],
                             -np.sin(angles) * window[:, None]], axis=1)

    return kernel.astype(dtype)


##################################################
# DECIBEL SCALING                                #
##################################################


def power_to_db(S, amin=1e-10, top_db=80.0, sample_ndim=None):
    """Power -> dB relative to the maximum entry (librosa ``ref=np.max``).

    ``sample_ndim`` gives the number of TRAILING axes that form one track's
    features (2 for an (F, T) spectrogram); leading axes are independent
    clips, each referenced to its own maximum, so one loud clip cannot move
    its batchmates' features. ``None`` reduces over every axis.
    """

    if sample_ndim is None:
        sample_ndim = S.dim()
    dims = tuple(range(S.dim() - min(sample_ndim, S.dim()), S.dim()))

    ref_value = torch.clamp_min(torch.amax(S, dim=dims, keepdim=True), amin)

    log_spec = 10.0 * torch.log10(torch.clamp_min(S, amin))
    log_spec = log_spec - 10.0 * torch.log10(ref_value)

    if top_db is not None:
        floor = torch.amax(log_spec, dim=dims, keepdim=True) - top_db
        log_spec = torch.maximum(log_spec, floor)

    return log_spec


def amplitude_to_db(S, amin=1e-5, top_db=80.0, sample_ndim=None):
    """Amplitude -> dB relative to the maximum entry (librosa ``ref=np.max``)."""

    return power_to_db(torch.square(S), amin=amin ** 2, top_db=top_db,
                       sample_ndim=sample_ndim)


##################################################
# MEL FILTERBANK                                 #
##################################################


def hz_to_mel(frequencies, htk=False):
    """Hz -> mel (Slaney by default, HTK optional)."""

    frequencies = np.asarray(frequencies, dtype=np.float64)

    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)

    # Slaney formula: linear below 1 kHz, logarithmic above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp

    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0

    log_region = frequencies >= min_log_hz
    mels = np.where(log_region,
                    min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
                    mels)

    return mels


def mel_to_hz(mels, htk=False):
    """Mel -> Hz (inverse of :func:`hz_to_mel`)."""

    mels = np.asarray(mels, dtype=np.float64)

    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)

    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels

    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0

    log_region = mels >= min_log_mel
    freqs = np.where(log_region,
                     min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                     freqs)

    return freqs


def mel_filterbank(sample_rate, n_fft, n_mels=128, fmin=0.0, fmax=None, htk=False, norm='slaney'):
    """Triangular mel filterbank (n_mels, n_fft//2+1), Slaney-normalized."""

    if fmax is None:
        fmax = sample_rate / 2.0

    fft_freqs = np.linspace(0, sample_rate / 2.0, n_fft // 2 + 1)

    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))

    if norm == 'slaney':
        # Constant-energy normalization per filter
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]

    return weights.astype(np.float32)


##################################################
# CQT / VQT WAVELET BANK                         #
##################################################


def cqt_frequencies(n_bins, fmin, bins_per_octave=12):
    """Center frequencies of geometrically-spaced CQT bins."""

    return fmin * (2.0 ** (np.arange(n_bins) / bins_per_octave))


def wavelet_lengths(freqs, sample_rate, alpha, gamma=0.0):
    """Filter length (samples) per center frequency: ``Q * sr / (f + gamma/alpha)``."""

    freqs = np.asarray(freqs, dtype=np.float64)
    Q = 1.0 / alpha

    return Q * sample_rate / (freqs + gamma / alpha)


def wavelet_bank(freqs, sample_rate, alpha, gamma=0.0, dtype=np.float32):
    """L1-normalized complex wavelet bank as a real matmul kernel.

    Each filter is a Hann-windowed complex exponential of frequency-dependent
    length, centered in a common support of ``max_length`` samples, rounded
    up to a multiple of 2048 (the JAX package's support tile; the frame
    algebra does not depend on it). Returns ``(kernel, max_length)`` where
    ``kernel`` is ``(max_length, 2 * n_bins)`` with ``[cos | -sin]`` halves,
    so that framed audio ``(T, max_length) @ kernel`` gives the real and
    imaginary responses and ``|CQT| = sqrt(re^2 + im^2)``.
    """

    freqs = np.asarray(freqs, dtype=np.float64)
    lengths = wavelet_lengths(freqs, sample_rate, alpha, gamma)

    max_length = int(-(-int(np.ceil(np.max(lengths))) // 2048) * 2048)

    n_bins = len(freqs)
    kernel = np.zeros((max_length, 2 * n_bins), dtype=np.float64)

    t = np.arange(max_length)
    for k in range(n_bins):
        ilen = int(np.floor(lengths[k]))
        if ilen % 2 == 0:
            ilen += 1  # odd length centers cleanly
        start = (max_length - ilen) // 2
        # Symmetric Hann window over the filter's support
        window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(ilen) / (ilen - 1))
        window /= np.sum(window)  # L1 normalization
        phase = 2 * np.pi * freqs[k] * (t[start: start + ilen] - max_length // 2) / sample_rate
        kernel[start: start + ilen, k] = window * np.cos(phase)
        kernel[start: start + ilen, n_bins + k] = -window * np.sin(phase)

    return kernel.astype(dtype), max_length
