"""Plain reference of the note model of High-resolution Piano Transcription
(Kong et al., IEEE/ACM TASLP 29, 2021, arXiv:2010.01815) at the widths of
``configs/hpt.json``: the published ``Regress_onset_offset_frame_velocity_
CRNN`` of ``bytedance/piano_transcription`` (``pytorch/models.py``) in eval
mode, its features, and its ``RegressionPostProcessor``
(``pytorch/utilities.py``) as a plain loop.

Log-mel features (reflect-padded centred frames, Hann, |X|^2, 229 Slaney
mels from 30 Hz to 8 kHz, absolute dB); ``bn0`` over the mel bins; four
acoustic stacks (frame, regressed onset, regressed offset, velocity) of
four ConvBlocks (two bias-free 3x3 convs with norm and ReLU, a (1, 2)
average pool) of 48, 64, 96 and 128 channels, the channel-major flatten,
``fc5`` (no bias), its norm and ReLU, a 2-layer BiGRU of 256 units a
direction and a Linear to 88 keys; the onset conditioned on velocity and
the frame on the onset and offset, each through a BiGRU and a Linear.
Every GRU is a loop over its steps, one direction at a time.

Departures from the published code, each kept by the port too:
- the STFT and the mel bank are built here (the published model calls
  torchlibrosa and librosa), with librosa's defaults;
- a peak of a regressed curve rises and falls strictly over its two
  neighbours on each side (the published check lets equal neighbours
  pass), and every threshold is compared in float32;
- the norms keep no ``num_batches_tracked``;
- the notes come out as (pitch, onset frame, end frame, velocity) rows, the
  frames the times are measured from.

Parameters are named and laid out as the port's ``state_dict`` (which are
the published names), because the same tensors are handed to both. Each
product takes a ``precision`` (``plain.py``), so that the same code in the
precision below the configuration's is the control the check must fail.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import plain

HEADS = ('frame', 'reg_onset', 'reg_offset', 'velocity')
EPS = 1e-5
# Clips a pass of the conv stacks, to bound their float32 activations
CONV_CLIPS = 8


def _stacks(config):
    return [f'{head}_model' for head in HEADS]


def parameters(config):
    """(name, shape, init) of every parameter and norm statistic."""

    keys, mels = config['num_keys'], config['n_mels']
    hidden = config['gru_units']
    widths = config['conv_channels']
    bound = hidden ** -0.5

    def norm(name, channels):
        return [(f'{name}.weight', (channels,), ('normal', 1.0, 0.1)),
                (f'{name}.bias', (channels,), ('normal', 0.0, 0.1)),
                (f'{name}.running_mean', (channels,), ('normal', 0.0, 0.1)),
                (f'{name}.running_var', (channels,), ('uniform', 0.5, 1.5))]

    def dense(name, shape, bias=True):
        spec = [(f'{name}.weight', shape, ('normal', 0.0, shape[1] ** -0.5))]
        if bias:
            spec += [(f'{name}.bias', shape[:1], ('normal', 0.0, 0.05))]
        return spec

    def bigru(name, dim_in, layers):
        spec = []
        for layer in range(layers):
            width = dim_in if layer == 0 else 2 * hidden
            for suffix in ('', '_reverse'):
                for kind, shape in (('weight_ih', (3 * hidden, width)),
                                    ('weight_hh', (3 * hidden, hidden)),
                                    ('bias_ih', (3 * hidden,)),
                                    ('bias_hh', (3 * hidden,))):
                    spec.append((f'{name}.{kind}_l{layer}{suffix}', shape,
                                 ('uniform', -bound, bound)))
        return spec

    spec = norm('bn0', mels)
    freqs = mels // 2 ** len(widths)
    for stack in _stacks(config):
        channels = 1
        for block, width in enumerate(widths, 1):
            prefix = f'{stack}.conv_block{block}'
            spec += [(f'{prefix}.conv1.weight', (width, channels, 3, 3),
                      ('normal', 0.0, (9 * channels) ** -0.5)),
                     (f'{prefix}.conv2.weight', (width, width, 3, 3),
                      ('normal', 0.0, (9 * width) ** -0.5))]
            spec += norm(f'{prefix}.bn1', width) + norm(f'{prefix}.bn2', width)
            channels = width
        spec += dense(f'{stack}.fc5', (config['fc5_dim'], channels * freqs),
                      bias=False)
        spec += norm(f'{stack}.bn5', config['fc5_dim'])
        spec += bigru(f'{stack}.gru', config['fc5_dim'], config['gru_layers'])
        spec += dense(f'{stack}.fc', (keys, 2 * hidden))
    spec += bigru('reg_onset_gru', 2 * keys, 1)
    spec += dense('reg_onset_fc', (keys, 2 * hidden))
    spec += bigru('frame_gru', 3 * keys, 1)
    spec += dense('frame_fc', (keys, 2 * hidden))

    return spec


##################################################
# FEATURES                                       #
##################################################


def mel_bank(config):
    """librosa's ``filters.mel`` (Slaney scale and normalization) between
    ``fmin`` and ``fmax``: (n_mels, n_fft/2 + 1) float32."""

    bins = np.linspace(0.0, config['sample_rate'] / 2.0,
                       config['n_fft'] // 2 + 1)
    edges = plain._mel_to_hz(np.linspace(
        plain._hz_to_mel(config['fmin'], False),
        plain._hz_to_mel(config['fmax'], False), config['n_mels'] + 2),
        False)
    lower, centre, upper = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rising = (bins[None] - lower) / (centre - lower)
    falling = (upper - bins[None]) / (upper - centre)
    filters = np.maximum(0.0, np.minimum(rising, falling))

    return (filters * (2.0 / (upper - lower))).astype(np.float32)


def features(audio, config, precision='float32'):
    """(B, N) float32 audio -> (B, 1, n_mels, T) log-mel in absolute dB,
    ``10 log10(max(1e-10, mel))``."""

    n_fft, hop = config['n_fft'], config['hop_length']
    window = torch.as_tensor(plain.hann_window(n_fft), dtype=torch.float32,
                             device=audio.device)
    padded = F.pad(audio[:, None], (n_fft // 2, n_fft // 2),
                   mode='reflect')[:, 0]
    frames = padded.unfold(-1, n_fft, hop)
    spectrum = torch.fft.rfft(plain.round_to(frames * window, precision),
                              dim=-1)
    power = (spectrum.real ** 2 + spectrum.imag ** 2).transpose(-1, -2)
    bank = torch.as_tensor(mel_bank(config), device=audio.device)
    bank, power = plain.product_operands(precision, bank, power)
    mel = torch.matmul(bank, power)

    return (10.0 * torch.log10(torch.clamp_min(mel, 1e-10)))[:, None]


##################################################
# FORWARD                                        #
##################################################


def _norm(x, params, name, dim=1, calibrating=False):
    """Eval BatchNorm over ``dim``; ``calibrating`` first sets its running
    statistics to x's mean and variance (at least 1e-3) over the other
    axes."""

    shape = [1] * x.dim()
    shape[dim] = -1
    if calibrating:
        axes = tuple(d for d in range(x.dim()) if d != dim % x.dim())
        params[f'{name}.running_mean'].copy_(x.mean(dim=axes))
        params[f'{name}.running_var'].copy_(
            x.var(dim=axes, unbiased=False).clamp_min(1e-3))

    def value(key):
        return params[f'{name}.{key}'].view(shape)

    return ((x - value('running_mean')) *
            torch.rsqrt(value('running_var') + EPS) * value('weight') +
            value('bias'))


def _gru(x, params, prefix, tag, reverse, precision):
    """One direction (``tag``: ``l0``, ``l0_reverse``, ...) of the GRU
    layer under ``prefix`` over (B, T, E), step by step, from a zero state:
    torch.nn.GRU's step."""

    def value(kind):
        return params[f'{prefix}.{kind}_{tag}']

    w_hh = plain.round_to(value('weight_hh'), precision)
    b_hh = value('bias_hh')
    gi = plain.linear(x, value('weight_ih'), value('bias_ih'), precision)
    batch, frames, _ = x.shape
    hidden = w_hh.shape[1]
    h = x.new_zeros(batch, hidden)
    out = [None] * frames
    for t in (range(frames - 1, -1, -1) if reverse else range(frames)):
        gh = torch.addmm(b_hh, plain.round_to(h, precision), w_hh.t())
        r = torch.sigmoid(gi[:, t, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(gi[:, t, hidden:2 * hidden] +
                          gh[:, hidden:2 * hidden])
        n = torch.tanh(gi[:, t, 2 * hidden:] + r * gh[:, 2 * hidden:])
        h = (1 - z) * n + z * h
        out[t] = h

    return torch.stack(out, dim=1)


def bigru(x, params, prefix, layers, precision):
    """torch.nn.GRU(bidirectional=True, batch_first=True) over (B, T, E)."""

    for layer in range(layers):
        x = torch.cat([_gru(x, params, prefix, f'l{layer}', False, precision),
                       _gru(x, params, prefix, f'l{layer}_reverse', True,
                            precision)], dim=-1)

    return x


def _embed(x, params, stack, precision, calibrating=False):
    """(b, 1, T, F) -> (b, T, fc5_dim): one stack's conv blocks, flatten,
    fc5, its norm and ReLU."""

    block = 1
    while f'{stack}.conv_block{block}.conv1.weight' in params:
        prefix = f'{stack}.conv_block{block}'
        for conv in (1, 2):
            x = plain.conv2d(x, params[f'{prefix}.conv{conv}.weight'], None, 1,
                             precision)
            x = torch.relu(_norm(x, params, f'{prefix}.bn{conv}',
                                 calibrating=calibrating))
        x = F.avg_pool2d(x, (1, 2))
        block += 1
    # (b, C, T, F) -> (b, T, C * F), channel-major as the published flatten
    x = x.transpose(1, 2).flatten(2)
    x = plain.linear(x, params[f'{stack}.fc5.weight'], None, precision)

    return torch.relu(_norm(x, params, f'{stack}.bn5', dim=-1,
                            calibrating=calibrating))


def _stack(x, params, stack, config, precision, calibrating=False):
    """(B, 1, T, F) -> (B, T, keys) logits of one acoustic stack."""

    if calibrating and x.shape[0] > CONV_CLIPS:
        raise ValueError(f'calibrate on {CONV_CLIPS} clips or fewer')
    emb = torch.cat([_embed(part, params, stack, precision, calibrating)
                     for part in x.split(CONV_CLIPS)])
    hidden = bigru(emb, params, f'{stack}.gru', config['gru_layers'],
                   precision)

    return plain.linear(hidden, params[f'{stack}.fc.weight'],
                        params[f'{stack}.fc.bias'], precision)


def forward(params, feats, config, precision='float32', calibrating=False):
    """(B, 1, F, T) features -> logits {frame, reg_onset, reg_offset,
    velocity}, each (B, T, keys): the published outputs before their
    sigmoids. ``calibrating`` sets every norm's running statistics to
    those of its input on the way (:func:`calibrate`)."""

    x = _norm(feats[:, 0], params, 'bn0', calibrating=calibrating)
    x = x.transpose(1, 2)[:, None]
    frame, onset, offset, velocity = (
        _stack(x, params, stack, config, precision, calibrating)
        for stack in _stacks(config))

    def head(name, x, dim_in_gru):
        return plain.linear(bigru(x, params, dim_in_gru, 1, precision),
                            params[f'{name}.weight'], params[f'{name}.bias'],
                            precision)

    onset_p = torch.sigmoid(onset)
    onset = head('reg_onset_fc', torch.cat(
        [onset_p, onset_p ** 0.5 * torch.sigmoid(velocity)], dim=-1),
        'reg_onset_gru')
    frame = head('frame_fc', torch.cat(
        [torch.sigmoid(frame), torch.sigmoid(onset), torch.sigmoid(offset)],
        dim=-1), 'frame_gru')

    return {'frame': frame, 'reg_onset': onset, 'reg_offset': offset,
            'velocity': velocity}


##################################################
# CALIBRATION                                    #
##################################################


def _logit(p):
    return float(np.log(p / (1.0 - p)))


def peaks(x, threshold=None, neighbour=2):
    """Strict peaks of (..., T, K) curves over ``neighbour`` frames a side
    (above ``threshold``, if given): a bool map."""

    frames = x.shape[-2]
    found = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if frames < 2 * neighbour + 1:
        return found

    def at(offset):
        return x[..., neighbour + offset:frames - neighbour + offset, :]

    inner = torch.ones_like(at(0), dtype=torch.bool)
    if threshold is not None:
        inner &= at(0) > threshold
    for i in range(neighbour):
        inner &= (at(-i - 1) < at(-i)) & (at(i + 1) < at(i))
    found[..., neighbour:frames - neighbour, :] = inner

    return found


def _peak_shift(logits, rate, threshold):
    """The shift to take off a head's bias so that ``rate`` of the cells
    are peaks above ``threshold`` after the sigmoid: the peaks do not move
    with the bias, so it is the logit quantile of the peaks that keeps that
    many, less the threshold's logit."""

    values = logits[peaks(logits)]
    if not len(values):
        return 0.0
    keep = rate * logits.numel()

    return (float(torch.quantile(values, max(0.0, 1.0 - keep / len(values))))
            - _logit(threshold))


def calibrate(params, audio, config):
    """Set what random weights cannot give, on a probe of the served audio,
    in float32: every norm's running statistics to the mean and variance of
    its input on the probe, as a trained model's track its training data
    (so each layer's activations keep their scale); the final onset head
    and the offset head scaled so that their logits spread (standard
    deviation) ``calibration.logit_spread``, as a trained model's sharp
    curves do (random heads give curves too flat for a peak to survive
    bf16 rounding), and their biases set so that ``onset_peaks`` and
    ``offset_peaks`` of the cells decode as peaks (about the traffic's
    notes a second); then the final frame head's bias so that
    ``calibration.frame_active`` of the cells lie above the frame
    threshold. Mutates ``params``."""

    rates = config['calibration']
    with torch.no_grad(), plain.exact_float32():
        feats = features(audio, config)
        logits = forward(params, feats, config, calibrating=True)
        for key, head in (('reg_onset', 'reg_onset_fc'),
                          ('reg_offset', 'reg_offset_model.fc')):
            gain = rates['logit_spread'] / float(logits[key].std())
            params[f'{head}.weight'] *= gain
            params[f'{head}.bias'] *= gain
            logits[key] = logits[key] * gain
        params['reg_onset_fc.bias'] -= _peak_shift(
            logits['reg_onset'], rates['onset_peaks'],
            config['onset_threshold'])
        params['reg_offset_model.fc.bias'] -= _peak_shift(
            logits['reg_offset'], rates['offset_peaks'],
            config['offset_threshold'])

        frame = forward(params, feats, config)['frame']
        params['frame_fc.bias'] -= (
            float(torch.quantile(frame.flatten(), 1.0 - rates['frame_active']))
            - _logit(config['frame_threshold']))


##################################################
# DECODE                                         #
##################################################


def _binarized(x, threshold, neighbour=2):
    """One key's (T,) float32 curve -> its peaks' (binary, shift), by the
    published loop (strict, thresholds in float32)."""

    threshold = np.float32(threshold)
    binary = np.zeros_like(x)
    shift = np.zeros_like(x)
    for n in range(neighbour, len(x) - neighbour):
        if not x[n] > threshold:
            continue
        if all(x[n - i] > x[n - i - 1] and x[n + i] > x[n + i + 1]
               for i in range(neighbour)):
            binary[n] = 1
            low = x[n + 1] if x[n - 1] > x[n + 1] else x[n - 1]
            shift[n] = (x[n + 1] - x[n - 1]) / (x[n] - low) / 2

    return binary, shift


def _notes_of_key(frame, onset, onset_shift, offset, offset_shift, velocity,
                  config):
    """The published ``note_detection_with_onset_offset_regress``:
    [onset frame, end frame, onset shift, offset shift, velocity] a note."""

    threshold = np.float32(config['frame_threshold'])
    notes = []
    bgn = frame_disappear = offset_occur = None
    for i in range(len(onset)):
        if onset[i] == 1:
            if bgn is not None:
                fin = max(i - 1, 0)
                notes.append([bgn, fin, onset_shift[bgn], 0, velocity[bgn]])
                frame_disappear, offset_occur = None, None
            bgn = i
        if bgn is not None and i > bgn:
            if frame[i] <= threshold and frame_disappear is None:
                frame_disappear = i
            if offset[i] == 1 and offset_occur is None:
                offset_occur = i
            if frame_disappear is not None:
                if (offset_occur is not None and offset_occur - bgn >
                        frame_disappear - offset_occur):
                    fin = offset_occur
                else:
                    fin = frame_disappear
                notes.append([bgn, fin, onset_shift[bgn], offset_shift[fin],
                              velocity[bgn]])
                bgn, frame_disappear, offset_occur = None, None, None
            if bgn is not None and (i - bgn >= config['max_note_frames'] or
                                    i == len(onset) - 1):
                notes.append([bgn, i, onset_shift[bgn], offset_shift[i],
                              velocity[bgn]])
                bgn, frame_disappear, offset_occur = None, None, None

    return notes


def decode(logits, config):
    """The notes that a clip's served (T, keys) logits hold: the sigmoid of
    each head as the served dtype computes it (``torch.sigmoid`` on the
    logits' device), widened to float32, then the published decode, a loop
    a key -> sorted (n, 4) rows (pitch, onset frame, end frame,
    velocity)."""

    curves = {key: torch.sigmoid(logits[key]).float().cpu().numpy()
              for key in HEADS}
    rows = []
    for k in range(curves['frame'].shape[1]):
        onsets, onset_shifts = _binarized(
            np.ascontiguousarray(curves['reg_onset'][:, k]),
            config['onset_threshold'])
        offsets, offset_shifts = _binarized(
            np.ascontiguousarray(curves['reg_offset'][:, k]),
            config['offset_threshold'])
        for bgn, fin, _, _, velocity in _notes_of_key(
                curves['frame'][:, k], onsets, onset_shifts, offsets,
                offset_shifts, curves['velocity'][:, k], config):
            rows.append((k + config['lowest_key'], bgn, fin,
                         int(velocity * np.float32(config['velocity_scale']))))

    return _sorted(rows)


def _sorted(rows):
    rows = np.asarray(rows, dtype=np.int64).reshape(-1, 4)

    return rows[np.lexsort((rows[:, 3], rows[:, 2], rows[:, 0], rows[:, 1]))]


def served(result, config):
    """A served clip's (pitches, intervals, velocities) -> (n, 4) rows as
    :func:`decode` gives them: the frames are the nearest to each time over
    the hop (a shift moves a time by less than half a frame). A result
    without velocities reads -1 for each."""

    pitches, intervals = result[0], result[1]
    count = len(np.asarray(pitches).reshape(-1))
    velocities = result[2] if len(result) > 2 else np.full(count, -1)
    frames = np.rint(np.asarray(intervals, dtype=np.float64).reshape(-1, 2) /
                     (config['hop_length'] / config['sample_rate']))
    rows = np.concatenate([np.asarray(pitches).reshape(-1, 1), frames,
                           np.asarray(velocities).reshape(-1, 1)], axis=-1)

    return _sorted(rows)


def logits_of(raw):
    """The port's raw output dict -> the four final heads' logits, which
    the check compares and the notes are decoded from."""

    return {key: raw[key] for key in HEADS}
