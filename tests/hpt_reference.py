"""Plain float32 reference of the note model of High-resolution Piano
Transcription (Kong et al., IEEE/ACM TASLP 29, 2021, arXiv:2010.01815): the
published ``Regress_onset_offset_frame_velocity_CRNN`` of
``bytedance/piano_transcription`` (``pytorch/models.py``) in eval mode, its
features, and its ``RegressionPostProcessor`` (``pytorch/utilities.py``) as a
plain loop.

Plain PyTorch and NumPy, with no batching of recurrences or stacks and no
kernel of the port; every product runs in float32 with TF32 off (the caller
holds :func:`exact_float32`). Parameters are named as the published state
dict (the norms without ``num_batches_tracked``), so the tests hand the
same tensors to the port and to this file.

Departures from the published code:
- the STFT and mel bank are computed here (the published model calls
  torchlibrosa and librosa): periodic Hann window, centred frames with
  reflect padding, |X|^2, Slaney mel filters normalized to constant energy
  (librosa's defaults), ``10 log10(max(1e-10, x))``;
- a peak of a regressed curve rises and falls strictly over its two
  neighbours on each side (the published check lets equal neighbours pass);
- the thresholds are compared in float32 (the published comparison of a
  float32 value with a Python float depends on NumPy's version);
- the notes come out as rows ``(pitch, onset frame, onset shift, end frame,
  offset shift, velocity)`` rather than times, so that the frames and the
  shifts can be compared apart.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
HEADS = ('frame', 'reg_onset', 'reg_offset', 'velocity')


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN inside the block."""

    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


# Features


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mels = f / (200.0 / 3)
    log = f >= 1000.0
    return np.where(log, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) /
                    (np.log(6.4) / 27.0), mels)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 *
                                               (m - 15.0)), m * (200.0 / 3))


def mel_bank(sample_rate, n_fft, n_mels, fmin, fmax):
    """librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax): (n_mels, n_fft/2
    + 1) float32, Slaney scale and normalization."""

    bins = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    bank = np.zeros((n_mels, len(bins)))
    for m in range(n_mels):
        lower, centre, upper = edges[m], edges[m + 1], edges[m + 2]
        for k, f in enumerate(bins):
            rise = (f - lower) / (centre - lower)
            fall = (upper - f) / (upper - centre)
            bank[m, k] = max(0.0, min(rise, fall)) * 2.0 / (upper - lower)

    return bank.astype(np.float32)


def features(audio, config):
    """(B, N) float32 audio -> (B, 1, n_mels, T) absolute-dB log-mel."""

    n_fft, hop = config['n_fft'], config['hop_length']
    n = np.arange(n_fft)
    window = torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft),
                             dtype=torch.float32, device=audio.device)
    padded = F.pad(audio[:, None], (n_fft // 2, n_fft // 2),
                   mode='reflect')[:, 0]
    frames = padded.unfold(-1, n_fft, hop)
    spectrum = torch.fft.rfft(frames * window, dim=-1)
    power = spectrum.real ** 2 + spectrum.imag ** 2          # (B, T, bins)
    bank = torch.as_tensor(mel_bank(config['sample_rate'], n_fft,
                                    config['n_mels'], config['fmin'],
                                    config['fmax']), device=audio.device)
    mel = torch.matmul(power, bank.t())                      # (B, T, mels)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))

    return db.transpose(1, 2)[:, None]


# Forward


def _norm(x, params, name, dim=1):
    shape = [1] * x.dim()
    shape[dim] = -1

    def v(key):
        return params[f'{name}.{key}'].view(shape)

    return (x - v('running_mean')) / torch.sqrt(v('running_var') + EPS) * (
        v('weight')) + v('bias')


def _gru_direction(x, params, name, reverse):
    """One direction of a GRU layer over (B, T, E), step by step."""

    w_ih, w_hh = params[f'weight_ih_{name}'], params[f'weight_hh_{name}']
    b_ih, b_hh = params[f'bias_ih_{name}'], params[f'bias_hh_{name}']
    batch, frames, _ = x.shape
    hidden = w_hh.shape[1]
    h = x.new_zeros(batch, hidden)
    out = [None] * frames
    for t in (range(frames - 1, -1, -1) if reverse else range(frames)):
        gi = x[:, t] @ w_ih.t() + b_ih
        gh = h @ w_hh.t() + b_hh
        r = torch.sigmoid(gi[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(gi[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
        n = torch.tanh(gi[:, 2 * hidden:] + r * gh[:, 2 * hidden:])
        h = (1 - z) * n + z * h
        out[t] = h

    return torch.stack(out, dim=1)


def bigru(x, params, prefix, layers):
    """``nn.GRU(bidirectional=True, batch_first=True)`` over (B, T, E)."""

    for layer in range(layers):
        sub = {k[len(prefix) + 1:]: v for k, v in params.items()
               if k.startswith(prefix + '.')}
        x = torch.cat([_gru_direction(x, sub, f'l{layer}', False),
                       _gru_direction(x, sub, f'l{layer}_reverse', True)],
                      dim=-1)

    return x


def _acoustic(x, params, name):
    """(B, 1, T, F) -> (B, T, keys) logits of one stack."""

    for block in range(1, 5):
        prefix = f'{name}.conv_block{block}'
        for conv in (1, 2):
            x = F.conv2d(x, params[f'{prefix}.conv{conv}.weight'], padding=1)
            x = torch.relu(_norm(x, params, f'{prefix}.bn{conv}'))
        x = F.avg_pool2d(x, (1, 2))
    x = x.transpose(1, 2).flatten(2)                          # (B, T, C*F)
    x = x @ params[f'{name}.fc5.weight'].t()
    x = torch.relu(_norm(x, params, f'{name}.bn5', dim=-1))
    x = bigru(x, params, f'{name}.gru', 2)

    return x @ params[f'{name}.fc.weight'].t() + params[f'{name}.fc.bias']


def forward(params, feats):
    """(B, 1, F, T) features -> the four final heads' logits (B, T, keys)."""

    x = _norm(feats[:, 0], params, 'bn0')                     # over F
    x = x.transpose(1, 2)[:, None]                            # (B, 1, T, F)
    frame = _acoustic(x, params, 'frame_model')
    onset = _acoustic(x, params, 'reg_onset_model')
    offset = _acoustic(x, params, 'reg_offset_model')
    velocity = _acoustic(x, params, 'velocity_model')

    onset_p = torch.sigmoid(onset)
    x = torch.cat([onset_p, onset_p ** 0.5 * torch.sigmoid(velocity)], dim=2)
    onset = (bigru(x, params, 'reg_onset_gru', 1) @
             params['reg_onset_fc.weight'].t() + params['reg_onset_fc.bias'])

    x = torch.cat([torch.sigmoid(frame), torch.sigmoid(onset),
                   torch.sigmoid(offset)], dim=2)
    frame = (bigru(x, params, 'frame_gru', 1) @
             params['frame_fc.weight'].t() + params['frame_fc.bias'])

    return {'frame': frame, 'reg_onset': onset, 'reg_offset': offset,
            'velocity': velocity}


# Decode


def binarized(reg, threshold, neighbour=2):
    """(T, K) float32 regressed curves -> (binary, shift) maps of their
    peaks; the threshold is compared in float32."""

    threshold = np.float32(threshold)
    frames, keys = reg.shape
    binary = np.zeros_like(reg)
    shift = np.zeros_like(reg)
    for k in range(keys):
        x = reg[:, k]
        for n in range(neighbour, frames - neighbour):
            if x[n] > threshold and _monotonic(x, n, neighbour):
                binary[n, k] = 1
                if x[n - 1] > x[n + 1]:
                    shift[n, k] = (x[n + 1] - x[n - 1]) / (x[n] - x[n + 1]) / 2
                else:
                    shift[n, k] = (x[n + 1] - x[n - 1]) / (x[n] - x[n - 1]) / 2

    return binary, shift


def _monotonic(x, n, neighbour):
    for i in range(neighbour):
        if not x[n - i] > x[n - i - 1] or not x[n + i] > x[n + i + 1]:
            return False

    return True


def notes_of_key(frame, onset, onset_shift, offset, offset_shift, velocity,
                 frame_threshold, max_frames=600):
    """The published ``note_detection_with_onset_offset_regress``: a list
    of [onset frame, end frame, onset shift, offset shift, velocity]."""

    frame_threshold = np.float32(frame_threshold)
    tuples = []
    bgn = frame_disappear = offset_occur = None
    for i in range(onset.shape[0]):
        if onset[i] == 1:
            if bgn:
                fin = max(i - 1, 0)
                tuples.append([bgn, fin, onset_shift[bgn], 0, velocity[bgn]])
                frame_disappear, offset_occur = None, None
            bgn = i
        if bgn and i > bgn:
            if frame[i] <= frame_threshold and not frame_disappear:
                frame_disappear = i
            if offset[i] == 1 and not offset_occur:
                offset_occur = i
            if frame_disappear:
                if (offset_occur and offset_occur - bgn >
                        frame_disappear - offset_occur):
                    fin = offset_occur
                else:
                    fin = frame_disappear
                tuples.append([bgn, fin, onset_shift[bgn], offset_shift[fin],
                               velocity[bgn]])
                bgn, frame_disappear, offset_occur = None, None, None
            if bgn and (i - bgn >= max_frames or i == onset.shape[0] - 1):
                fin = i
                tuples.append([bgn, fin, onset_shift[bgn], offset_shift[fin],
                               velocity[bgn]])
                bgn, frame_disappear, offset_occur = None, None, None

    return tuples


def decode(curves, config, velocity_scale=128):
    """One clip's (T, keys) float32 sigmoid curves {frame, reg_onset,
    reg_offset, velocity} (numpy) -> sorted rows (pitch, onset frame, onset
    shift, end frame, offset shift, velocity)."""

    onsets, onset_shifts = binarized(curves['reg_onset'],
                                     config['onset_threshold'])
    offsets, offset_shifts = binarized(curves['reg_offset'],
                                       config['offset_threshold'])
    rows = []
    for k in range(curves['frame'].shape[1]):
        for bgn, fin, on_shift, off_shift, vel in notes_of_key(
                curves['frame'][:, k], onsets[:, k], onset_shifts[:, k],
                offsets[:, k], offset_shifts[:, k], curves['velocity'][:, k],
                config['frame_threshold']):
            rows.append((k + config['lowest_key'], bgn, float(on_shift), fin,
                         float(off_shift), int(vel * velocity_scale)))

    return sorted(rows)
