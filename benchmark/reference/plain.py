"""Building blocks of the plain references: products, the LSTM, features,
dropout and the note decode.

Every product goes through :func:`product_operands`, which rounds both
operands to the reference's ``precision``: ``'float32'`` leaves them (the
caller runs under :func:`exact_float32`, TF32 off), ``'tf32'`` rounds each
to TF32's 10-bit mantissa as the tensor cores do, ``'bf16'`` to bfloat16 and
``'fp8'`` to float8 e4m3 with one scale a tensor (its largest magnitude at
448), all accumulating in float32. The lower precisions are the controls.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ('float32', 'tf32', 'bf16', 'fp8')

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products in full precision: TF32 off for cuBLAS and cuDNN
    inside the block; the flags are restored on exit."""

    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def round_to(x, precision):
    """``x`` (float32) rounded to ``precision`` and held in float32; its
    gradient passes the rounding unchanged."""

    if precision == 'float32':
        return x
    if x.requires_grad:
        return x + (round_to(x.detach(), precision) - x).detach()
    if precision == 'tf32':
        # Round to nearest even at the 13 mantissa bits TF32 drops
        bits = x.contiguous().view(torch.int32)
        bits = bits + 0x0FFF + torch.bitwise_and(bits >> 13, 1)
        return torch.bitwise_and(bits, -0x2000).view(torch.float32)
    if precision == 'bf16':
        return x.to(torch.bfloat16).float()
    if precision == 'fp8':
        scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f'unknown precision {precision!r}; one of {PRECISIONS}')


def product_operands(precision, *operands):
    return tuple(round_to(x, precision) for x in operands)


def conv2d(x, weight, bias, padding, precision):
    """A 3x3 (or any) convolution, NCHW, float32 accumulation."""

    x, weight = product_operands(precision, x, weight)

    return F.conv2d(x, weight, bias, padding=padding)


def linear(x, weight, bias, precision):
    x, weight = product_operands(precision, x, weight)

    return F.linear(x, weight, bias)


def lstm(xw, w_h, reverse, precision):
    """The LSTM recurrence over (B, T, 4H) input projections with the (H,
    4H) recurrent kernel, gates in the order i, f, g, o, from a zero
    carry -> (B, T, H), step by step."""

    batch, frames, four_h = xw.shape
    w = round_to(w_h, precision)
    h = xw.new_zeros(batch, four_h // 4)
    c = xw.new_zeros(batch, four_h // 4)
    out = [None] * frames
    for t in (range(frames - 1, -1, -1) if reverse else range(frames)):
        gates = xw[:, t] + round_to(h, precision) @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h

    return torch.stack(out, dim=1)


def bilstm(x, params, prefix, precision):
    """[forward | backward] LSTM over (B, T, E) with the projections and
    kernels under ``prefix`` (``input_proj_fwd``, ``recurrent_kernel_fwd``
    and their ``_bwd`` twins)."""

    outs = []
    for side, reverse in (('fwd', False), ('bwd', True)):
        xw = linear(x, params[f'{prefix}.input_proj_{side}.weight'],
                    params[f'{prefix}.input_proj_{side}.bias'], precision)
        outs.append(lstm(xw, params[f'{prefix}.recurrent_kernel_{side}'],
                         reverse, precision))

    return torch.cat(outs, dim=-1)


def dropout(x, rate, generator):
    """Dropout as the recipes train it: keep a value where a uniform draw
    from ``generator`` (on x's device, one draw a value) is below ``1 -
    rate``, scaled by ``1 / (1 - rate)``."""

    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob

    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def batch_norm_train(x, weight, bias, eps=1e-5):
    """Train-mode batch norm over channel dim 1: the batch's mean and the
    variance E[x^2] - E[x]^2 (at least 0) over every other axis."""

    axes = (0,) + tuple(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(axes)
    var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)

    return ((x - mean.view(shape)) * (torch.rsqrt(var + eps) * weight).view(
        shape) + bias.view(shape))


def batch_norm_eval(x, weight, bias, mean, var, eps=1e-5):
    shape = (1, -1) + (1,) * (x.dim() - 2)

    return ((x - mean.view(shape)) * (torch.rsqrt(var + eps) * weight).view(
        shape) + bias.view(shape))


##################################################
# FEATURES                                       #
##################################################


def midi_to_hz(midi):
    return 440.0 * 2.0 ** ((np.asarray(midi, dtype=np.float64) - 69.0) / 12.0)


def hann_window(length):
    """The periodic Hann window."""

    n = np.arange(length)

    return 0.5 - 0.5 * np.cos(2 * np.pi * n / length)


def frames_of(audio, frame_length, hop_length):
    """(B, N) audio -> (B, 1 + N // hop, frame_length) frames, centred:
    zero padding of half a frame on the left and what the last frame needs
    on the right."""

    num_frames = 1 + audio.shape[-1] // hop_length
    left = frame_length // 2
    right = max(0, (num_frames - 1) * hop_length + frame_length - left -
                audio.shape[-1])
    padded = F.pad(audio, (left, right))

    return padded.unfold(-1, frame_length, hop_length)[:, :num_frames]


def _hz_to_mel(freqs, htk):
    freqs = np.asarray(freqs, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freqs / 700.0)
    linear_part = freqs / (200.0 / 3)
    log_part = 15.0 + np.log(np.maximum(freqs, 1000.0) / 1000.0) / (
        np.log(6.4) / 27.0)

    return np.where(freqs >= 1000.0, log_part, linear_part)


def _mel_to_hz(mels, htk):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)

    return np.where(mels >= 15.0,
                    1000.0 * np.exp(np.log(6.4) / 27.0 * (mels - 15.0)),
                    mels * (200.0 / 3))


def mel_filterbank(sample_rate, n_fft, n_mels, htk):
    """Triangular mel filters on the rfft bins, each normalized to
    constant energy (Slaney's ``2 / bandwidth``), (n_mels, n_fft/2+1)."""

    bins = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0, htk),
                                   _hz_to_mel(sample_rate / 2.0, htk),
                                   n_mels + 2), htk)
    lower, centre, upper = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rising = (bins[None] - lower) / (centre - lower)
    falling = (upper - bins[None]) / (upper - centre)
    filters = np.maximum(0.0, np.minimum(rising, falling))

    return filters * (2.0 / (upper - lower))


def to_unit_db(power, amin):
    """Power (B, F, T) -> dB against each clip's largest value, floored 80
    dB under it, mapped from [-80, 0] onto [0, 1]; (B, 1, F, T)."""

    ref = torch.clamp_min(power.amax(dim=(-2, -1), keepdim=True), amin)
    db = 10.0 * torch.log10(torch.clamp_min(power, amin)) - 10.0 * torch.log10(
        ref)
    db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - 80.0)

    return torch.clamp(db / 80.0 + 1.0, 0.0, 1.0).unsqueeze(1)


def mel_features(audio, config, precision='float32'):
    """(B, N) float32 audio -> (B, 1, n_mels, T) [0, 1] mel features: the
    power of the rfft of each Hann-windowed centred frame, the mel
    projection, dB per clip."""

    n_fft = config['n_fft']
    window = torch.as_tensor(hann_window(n_fft), dtype=torch.float32,
                             device=audio.device)
    bank = torch.as_tensor(mel_filterbank(config['sample_rate'], n_fft,
                                          config['n_mels'], config['htk']),
                           dtype=torch.float32, device=audio.device)
    frames = frames_of(audio, n_fft, config['hop_length'])
    spectrum = torch.fft.rfft(round_to(frames * window, precision), dim=-1)
    power = (spectrum.real ** 2 + spectrum.imag ** 2).transpose(-1, -2)
    bank, power = product_operands(precision, bank, power)

    return to_unit_db(torch.matmul(bank, power), amin=1e-10)


def wavelet_bank(config):
    """The CQT's wavelets: for each bin a Hann-windowed complex exponential
    of length Q sr / f (odd, L1-normalized), centred in a common support
    that is a multiple of 2048 samples. Returns the (support, 2 bins)
    [cos | -sin] bank and the wavelets' lengths."""

    sample_rate = config['sample_rate']
    n_bins = config['n_bins']
    freqs = midi_to_hz(config['fmin_midi']) * 2.0 ** (
        np.arange(n_bins) / config['bins_per_octave'])
    if freqs.max() > sample_rate / 2:
        raise ValueError('the highest CQT bin lies above the Nyquist rate')
    alpha = 2.0 ** (1.0 / config['bins_per_octave']) - 1
    lengths = sample_rate / (alpha * freqs)
    support = int(-(-int(np.ceil(lengths.max())) // 2048) * 2048)

    bank = np.zeros((support, 2 * n_bins))
    taps = []
    for k in range(n_bins):
        length = int(np.floor(lengths[k]))
        length += 1 - length % 2
        start = (support - length) // 2
        window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(length) /
                                    (length - 1))
        window /= window.sum()
        phase = (2 * np.pi * freqs[k] *
                 (np.arange(start, start + length) - support // 2) /
                 sample_rate)
        bank[start:start + length, k] = window * np.cos(phase)
        bank[start:start + length, n_bins + k] = -window * np.sin(phase)
        taps.append(length)

    return bank, np.asarray(taps)


def cqt_features(audio, config, precision='float32', chunk=256):
    """(B, N) float32 audio -> (B, 1, n_bins, T) [0, 1] CQT features: the
    magnitude of each centred frame against the wavelet bank, 256 frames at
    a time, dB per clip (of the magnitude)."""

    bank, _ = wavelet_bank(config)
    bank = torch.as_tensor(bank, dtype=torch.float32, device=audio.device)
    n_bins = config['n_bins']
    frames = frames_of(audio, bank.shape[0], config['hop_length'])
    parts = []
    for start in range(0, frames.shape[1], chunk):
        block, weights = product_operands(
            precision, frames[:, start:start + chunk].contiguous(), bank)
        resp = torch.matmul(block, weights)
        re, im = resp[..., :n_bins], resp[..., n_bins:]
        parts.append(re * re + im * im)
    power = torch.cat(parts, dim=1).transpose(-1, -2)

    return to_unit_db(power, amin=1e-10)


##################################################
# DECODE                                         #
##################################################


def rising(x):
    """Rising edges along the last axis of a boolean map; an active first
    frame counts as one."""

    previous = np.concatenate([np.zeros_like(x[..., :1]), x[..., :-1]], -1)

    return x & ~previous


def notes_from_maps(active, onsets=None):
    """Notes of (R, T) boolean activity maps -> (n, 3) int64 rows of (row,
    onset frame, end frame), end exclusive, sorted.

    A note starts at each rising edge of the onset map (of the activity
    itself without one) and lasts while its row is active (or has an
    onset), up to the next onset of the row."""

    if onsets is None:
        onsets = rising(active)
    starts = rising(onsets)
    alive = onsets | active
    num_frames = active.shape[-1]
    frame = np.arange(num_frames)

    stop = np.where(~alive | starts, frame, num_frames)
    # The first stop at or after each frame, then strictly after it
    after = np.minimum.accumulate(stop[..., ::-1], axis=-1)[..., ::-1]
    after = np.concatenate([after[..., 1:],
                            np.full(after.shape[:-1] + (1,), num_frames)],
                           axis=-1)

    rows, onset_frames = np.nonzero(starts)
    notes = np.stack([rows, onset_frames, after[rows, onset_frames]], axis=-1)

    return sort_notes(notes.astype(np.int64))


def sort_notes(notes):
    """(n, 3) note rows sorted by onset, then row, then end."""

    notes = np.asarray(notes, dtype=np.int64).reshape(-1, 3)
    order = np.lexsort((notes[:, 2], notes[:, 0], notes[:, 1]))

    return notes[order]


def served_notes(pitches, intervals, frame_seconds):
    """A served clip's (pitches, intervals) -> (n, 3) (pitch, onset
    frame, end frame) rows, sorted, on a frame grid of ``frame_seconds``."""

    intervals = np.asarray(intervals, dtype=np.float64).reshape(-1, 2)
    frames = np.rint(intervals / frame_seconds).astype(np.int64)
    notes = np.concatenate([np.asarray(pitches, dtype=np.int64).reshape(-1, 1),
                            frames], axis=-1)

    return sort_notes(notes)


def note_mismatches(got, want):
    """How many notes one sorted (n, 3) list has that the other lacks,
    counted both ways."""

    got = {tuple(row) for row in np.asarray(got).tolist()}
    want = {tuple(row) for row in np.asarray(want).tolist()}

    return len(got ^ want)
