"""Plain reference of hFT-Transformer (Toyama, Akama, Ikemiya, Takida,
Liao and Mitsufuji, ISMIR 2023, arXiv:2307.04305) at the widths of
``configs/hft.json``: the published ``Model_SPEC2MIDI`` of ``sony/
hFT-Transformer`` (``model/model_spec.py``) in eval mode, its features,
its segmented inference (``model/amt.py`` ``transcript``), and the
regression decode the port serves it with (``reference/hpt.py``'s loop,
velocities the argmax class).

Log-mel features (zero-padded centred frames, Hann, |X|^2, 256 HTK-scale
mels with Slaney's area norm from 0 Hz to 8 kHz, ``log(mel + 1e-8)``);
each clip padded with ``log(1e-8)``: ``n_margin`` frames before it, to
whole segments of ``n_frame`` frames and ``n_margin`` frames after. Per
segment: each frame's context of ``2 n_margin + 1`` frames, a (1, 5) conv
to 4 channels, each bin's 244 channel-major values embedded to
``hid_dim``, times ``sqrt(hid_dim)``, plus a learned embedding of the bins;
3 post-LN encoder layers over the bins; 88 learned pitch queries through
a decoder layer of cross-attention alone and 2 of self- and
cross-attention; the queries of a segment's frames, times ``sqrt(hid_dim)``
plus a learned embedding of the frames, through 3 encoder layers over the
frames of each pitch; heads B (onset, offset, mpe, 128 velocity classes).
The segments run in blocks of :data:`BLOCK`, every segment of a block at
once, so that the float32 scores fit on the card.

Departures from the published code, each kept by the port too:
- the STFT and the mel bank are built here (the published features call
  torchaudio's ``MelSpectrogram``), with its defaults;
- no dropout; heads A and the decoder's attention weights are not
  computed;
- the notes: the published ``mpe2note`` is not reproduced; the served
  curves are decoded by the High-resolution model's regression decode
  (strict peaks, offsets and frame drops as ``reference/hpt.py``) at the
  thresholds of the configuration, velocities the argmax class.

Parameters are named and laid out as the port's ``state_dict`` (the
published names), because the same tensors are handed to both. Each
product takes a ``precision`` (``plain.py``), so that the same code in the
precision below the configuration's is the control the check must fail.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import plain
from .hpt import _binarized, _logit, _notes_of_key, _peak_shift, _sorted
from .hpt import served  # noqa: F401  (the served notes read as the hpt's)

HEADS = ('frame', 'reg_onset', 'reg_offset', 'velocity')
# The published head of each key
HEAD_NAMES = {'frame': 'mpe', 'reg_onset': 'onset', 'reg_offset': 'offset',
              'velocity': 'velocity'}
# Segments a pass of the model
BLOCK = 16


def parameters(config):
    """(name, shape, init) of every parameter: torch's default ranges for
    the conv and Linear layers (uniform over 1 / sqrt(fan-in)), unit
    normal embeddings, LayerNorms near 1 and 0."""

    hid, pf = config['hid_dim'], config['pf_dim']
    channels, kernel = config['cnn_channel'], config['cnn_kernel']
    cnn_dim = channels * (2 * config['n_margin'] + 2 - kernel)

    def dense(name, out_features, in_features):
        bound = in_features ** -0.5
        return [(f'{name}.weight', (out_features, in_features),
                 ('uniform', -bound, bound)),
                (f'{name}.bias', (out_features,), ('uniform', -bound, bound))]

    def attention(name):
        return sum((dense(f'{name}.fc_{p}', hid, hid) for p in 'qkvo'), [])

    def layer(name, attentions):
        spec = [(f'{name}.layer_norm.weight', (hid,), ('normal', 1.0, 0.1)),
                (f'{name}.layer_norm.bias', (hid,), ('normal', 0.0, 0.1))]
        for sub in attentions:
            spec += attention(f'{name}.{sub}')
        return spec + (dense(f'{name}.positionwise_feedforward.fc_1', pf, hid) +
                       dense(f'{name}.positionwise_feedforward.fc_2', hid, pf))

    enc, dec = 'encoder_spec2midi', 'decoder_spec2midi'
    bound = kernel ** -0.5
    spec = [(f'{enc}.conv.weight', (channels, 1, 1, kernel),
             ('uniform', -bound, bound)),
            (f'{enc}.conv.bias', (channels,), ('uniform', -bound, bound))]
    spec += dense(f'{enc}.tok_embedding_freq', hid, cnn_dim)
    spec += [(f'{enc}.pos_embedding_freq.weight', (config['n_bin'], hid),
              ('normal', 0.0, 1.0))]
    for n in range(config['n_layers']):
        spec += layer(f'{enc}.layers_freq.{n}', ['self_attention'])
    spec += [(f'{dec}.pos_embedding_freq.weight', (config['num_keys'], hid),
              ('normal', 0.0, 1.0))]
    spec += layer(f'{dec}.layer_zero_freq', ['encoder_attention'])
    for n in range(config['n_layers'] - 1):
        spec += layer(f'{dec}.layers_freq.{n}',
                      ['self_attention', 'encoder_attention'])
    for suffix in ('freq', 'time'):
        for head in ('onset', 'offset', 'mpe'):
            spec += dense(f'{dec}.fc_{head}_{suffix}', 1, hid)
        spec += dense(f'{dec}.fc_velocity_{suffix}', config['n_velocity'],
                      hid)
    spec += [(f'{dec}.pos_embedding_time.weight', (config['n_frame'], hid),
              ('normal', 0.0, 1.0))]
    for n in range(config['n_layers']):
        spec += layer(f'{dec}.layers_time.{n}', ['self_attention'])

    return spec


##################################################
# FEATURES                                       #
##################################################


def mel_bank(config):
    """torchaudio's ``melscale_fbanks(mel_scale='htk', norm='slaney')``
    between ``fmin`` and ``fmax``: (n_bin, n_fft/2 + 1) float32."""

    bins = np.linspace(0.0, config['sample_rate'] / 2.0,
                       config['n_fft'] // 2 + 1)
    edges = plain._mel_to_hz(np.linspace(
        plain._hz_to_mel(config['fmin'], True),
        plain._hz_to_mel(config['fmax'], True), config['n_bin'] + 2), True)
    lower, centre, upper = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rising = (bins[None] - lower) / (centre - lower)
    falling = (upper - bins[None]) / (upper - centre)
    filters = np.maximum(0.0, np.minimum(rising, falling))

    return (filters * (2.0 / (upper - lower))).astype(np.float32)


def features(audio, config, precision='float32'):
    """(B, N) float32 audio -> (B, 1, n_bin, T) ``log(mel + log_offset)``."""

    n_fft = config['n_fft']
    window = torch.as_tensor(plain.hann_window(n_fft), dtype=torch.float32,
                             device=audio.device)
    frames = plain.frames_of(audio, n_fft, config['hop_length'])
    spectrum = torch.fft.rfft(plain.round_to(frames * window, precision),
                              dim=-1)
    power = (spectrum.real ** 2 + spectrum.imag ** 2).transpose(-1, -2)
    bank = torch.as_tensor(mel_bank(config), device=audio.device)
    bank, power = plain.product_operands(precision, bank, power)
    mel = torch.matmul(bank, power)

    return torch.log(mel + config['log_offset'])[:, None]


##################################################
# FORWARD                                        #
##################################################


def _linear(x, params, name, precision):
    return plain.linear(x, params[f'{name}.weight'], params[f'{name}.bias'],
                        precision)


def _attention(params, name, query, key, config, precision):
    """The published ``MultiHeadAttentionLayer``: (N, L, E) over (N, S,
    E)."""

    batch, hid = key.shape[0], config['hid_dim']
    n_heads = config['n_heads']
    head_dim = hid // n_heads

    def heads(x):
        return x.reshape(batch, -1, n_heads, head_dim).permute(0, 2, 1, 3)

    q = heads(_linear(query, params, f'{name}.fc_q', precision))
    k = heads(_linear(key, params, f'{name}.fc_k', precision))
    v = heads(_linear(key, params, f'{name}.fc_v', precision))
    q, k = plain.product_operands(precision, q, k)
    energy = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim)
    weights, v = plain.product_operands(precision,
                                        torch.softmax(energy, dim=-1), v)
    x = torch.matmul(weights, v).permute(0, 2, 1, 3).reshape(batch, -1, hid)

    return _linear(x, params, f'{name}.fc_o', precision)


def _sublayers(params, name, x, enc, config, precision, attentions):
    """One post-LN layer: each attention of ``attentions`` (``self`` or
    ``encoder``) and the feed-forward, each added and normalized."""

    def norm(x):
        return F.layer_norm(x, x.shape[-1:],
                            params[f'{name}.layer_norm.weight'],
                            params[f'{name}.layer_norm.bias'], 1e-5)

    for kind in attentions:
        key = x if kind == 'self' else enc
        x = norm(x + _attention(params, f'{name}.{kind}_attention', x, key,
                                config, precision))
    hidden = torch.relu(_linear(x, params,
                                f'{name}.positionwise_feedforward.fc_1',
                                precision))

    return norm(x + _linear(hidden, params,
                            f'{name}.positionwise_feedforward.fc_2',
                            precision))


def segment_forward(params, spec, config, precision='float32'):
    """The published ``Model_SPEC2MIDI`` on (S, n_bin, 2 n_margin +
    n_frame) segments -> heads B, {key: (S, n_frame, keys[, classes])}."""

    n_frame, n_bin, hid = config['n_frame'], config['n_bin'], config['hid_dim']
    keys, layers = config['num_keys'], config['n_layers']
    n_proc = 2 * config['n_margin'] + 1
    batch = spec.shape[0]
    enc_name, dec_name = 'encoder_spec2midi', 'decoder_spec2midi'

    # The front end: each frame's context, the conv, the bins' embedding
    x = spec.unfold(2, n_proc, 1).permute(0, 2, 1, 3)
    x = x.reshape(batch * n_frame, 1, n_bin, n_proc)
    x = plain.conv2d(x, params[f'{enc_name}.conv.weight'],
                     params[f'{enc_name}.conv.bias'], 0, precision)
    x = x.permute(0, 2, 1, 3).reshape(batch * n_frame, n_bin, -1)
    x = _linear(x, params, f'{enc_name}.tok_embedding_freq', precision)
    x = x * math.sqrt(hid) + params[f'{enc_name}.pos_embedding_freq.weight']
    for n in range(layers):
        x = _sublayers(params, f'{enc_name}.layers_freq.{n}', x, None, config,
                       precision, ['self'])
    enc = x

    # The frequency decoder: 88 learned queries a frame
    x = params[f'{dec_name}.pos_embedding_freq.weight'][None].expand(
        batch * n_frame, -1, -1)
    x = _sublayers(params, f'{dec_name}.layer_zero_freq', x, enc, config,
                   precision, ['encoder'])
    for n in range(layers - 1):
        x = _sublayers(params, f'{dec_name}.layers_freq.{n}', x, enc, config,
                       precision, ['self', 'encoder'])
    del enc

    # The time encoder: each pitch over the segment's frames
    x = x.reshape(batch, n_frame, keys, hid).transpose(1, 2).reshape(
        batch * keys, n_frame, hid)
    x = x * math.sqrt(hid) + params[f'{dec_name}.pos_embedding_time.weight']
    for n in range(layers):
        x = _sublayers(params, f'{dec_name}.layers_time.{n}', x, None, config,
                       precision, ['self'])

    out = {}
    for key, head in HEAD_NAMES.items():
        y = _linear(x, params, f'{dec_name}.fc_{head}_time', precision)
        y = y.reshape(batch, keys, n_frame, -1).transpose(1, 2)
        out[key] = y if key == 'velocity' else y[..., 0]

    return out


def forward(params, feats, config, precision='float32', block=BLOCK):
    """(B, 1, n_bin, T) features -> heads B's logits {frame, reg_onset,
    reg_offset: (B, T, keys); velocity: (B, T, keys, classes)}: each clip
    padded and cut into segments as the published inference does, the
    segments of all clips in blocks of ``block``, their outputs stitched
    back to the clip's frames."""

    n_margin, n_frame = config['n_margin'], config['n_frame']
    clips, _, _, frames = feats.shape
    segments = -(-frames // n_frame)
    padded = F.pad(feats[:, 0], (n_margin, segments * n_frame - frames +
                                 n_margin), value=config['pad_value'])
    spec = torch.stack([padded[..., s * n_frame:s * n_frame + 2 * n_margin +
                               n_frame] for s in range(segments)], dim=1)
    spec = spec.flatten(0, 1)
    parts = [segment_forward(params, spec[start:start + block], config,
                             precision)
             for start in range(0, spec.shape[0], block)]

    return {key: torch.cat([p[key] for p in parts]).reshape(
        (clips, segments * n_frame) + parts[0][key].shape[2:])[:, :frames]
        for key in HEADS}


##################################################
# CALIBRATION                                    #
##################################################


def calibrate(params, audio, config):
    """Set what random weights cannot give, on a probe of the served audio,
    in float32: the onset and offset heads of output B scaled so that their
    logits spread (standard deviation) ``calibration.logit_spread``, as a
    trained model's sharp curves do (random heads give curves too flat for
    a peak to survive bf16 rounding), and their biases set so that
    ``onset_peaks`` and ``offset_peaks`` of the cells decode as peaks
    (about the traffic's notes a second); then the frame (mpe) head's bias
    so that ``calibration.frame_active`` of the cells lie above the frame
    threshold. Mutates ``params``."""

    rates = config['calibration']
    dec = 'decoder_spec2midi'
    with torch.no_grad(), plain.exact_float32():
        feats = features(audio, config)
        logits = forward(params, feats, config)
        for key, rate, threshold in (
                ('reg_onset', rates['onset_peaks'], config['onset_threshold']),
                ('reg_offset', rates['offset_peaks'],
                 config['offset_threshold'])):
            head = f'{dec}.fc_{HEAD_NAMES[key]}_time'
            gain = rates['logit_spread'] / float(logits[key].std())
            params[f'{head}.weight'] *= gain
            params[f'{head}.bias'] *= gain
            params[f'{head}.bias'] -= _peak_shift(logits[key] * gain, rate,
                                                  threshold)
        frame = logits['frame']
        params[f'{dec}.fc_mpe_time.bias'] -= (
            float(torch.quantile(frame.flatten(), 1.0 - rates['frame_active']))
            - _logit(config['frame_threshold']))


##################################################
# DECODE                                         #
##################################################


def decode(logits, config):
    """The notes that a clip's served logits hold: the sigmoid of the
    frame, onset and offset heads and the argmax of the velocity classes,
    each as the served dtype computes it on the logits' device, then the
    regression decode's loop a key -> sorted (n, 4) rows (pitch, onset
    frame, end frame, velocity class)."""

    curves = {key: torch.sigmoid(logits[key]).float().cpu().numpy()
              for key in ('frame', 'reg_onset', 'reg_offset')}
    classes = logits['velocity'].argmax(-1).cpu().numpy()
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
                offset_shifts, classes[:, k], config):
            rows.append((k + config['lowest_key'], bgn, fin, int(velocity)))

    return _sorted(rows)


def logits_of(raw):
    """The port's raw output dict -> heads B's logits, which the check
    compares and the notes are decoded from."""

    return {key: raw[key] for key in HEADS}
