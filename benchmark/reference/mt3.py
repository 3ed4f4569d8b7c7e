"""Plain reference of MT3's sequence-to-sequence piano transcriber
(Hawthorne, Simon, Swavely, Manilow and Engel, ISMIR 2021,
arXiv:2107.09142; ``magenta/mt3`` ``network.py``, ``spectrograms.py``,
``vocabularies.py``, ``event_codec.py``, ``run_length_encoding.py`` and
``note_sequences.py``) at the widths of ``configs/mt3.json``.

Features: each clip cut into segments of ``input_length`` frames of the hop
(the last zero-padded), each segment framed from its first sample and
zero-padded at its end (``tf.signal.stft(..., pad_end=True)``), a periodic
Hann window, |rfft|, TensorFlow's ``linear_to_mel_weight_matrix``
(triangles linear in HTK mels from ``fmin`` to ``fmax``, no area norm, the
DC bin zeroed), ``log(max(mel, log_floor))``.

Network (T5.1.1 small, t5x): RMS(x) = x rsqrt(mean(x^2) + 1e-6) g, no mean
and no bias; P the fixed sinusoidal table (sines of the first half of the
features, cosines of the second). Encoder: x = W_in mel + P, then per layer
h = x + Attn(RMS(x)), x = h + wo(gelu(wi_0 RMS(h)) * wi_1 RMS(h)), then
``encoder_norm``. Decoder, teacher forced over the served tokens: y =
E[previous token, PAD first] + P, then per layer causal self-attention,
cross-attention to the encoder output and the gated MLP, each pre-normed
and added; ``decoder_norm``, ``logits_dense``. Attention is softmax(q k^T)
v over 6 heads of 64 with no 1 / sqrt(64) (T5 folds it into the query's
initial weights); GELU is the tanh form. The whole forward runs without a
cache, in blocks of :data:`BLOCK` rows, so that the float32 scores fit.

Decode: each segment's tokens to notes by a plain loop over the tokens
(the rules of ``tools/event_codec.py`` in the port, written here again).

Parameters are named and laid out as the port's ``state_dict`` (t5x's
module names, PyTorch's ``weight`` leaves), because the same tensors are
handed to both. Each product takes a ``precision`` (``plain.py``), so that
the same code in the precision below the configuration's is the control
the check must fail.
"""

import collections

import numpy as np
import torch
import torch.nn.functional as F

from . import plain

PAD, EOS = 0, 1
NUM_SPECIAL = 3
# The codec's event ids: shifts 0-1000, pitches, velocities, then the tie,
# programs and drums
PITCH, VELOCITY, NUM_EVENTS = 1001, 1129, 1514
STEPS_PER_SECOND = 100
DEFAULT_VELOCITY = 100
MIN_NOTE_DURATION = 0.01
# Rows a pass of the teacher-forced forward
BLOCK = 8


def parameters(config):
    """(name, shape, init) of every parameter, in the port's order: t5x's
    initializer scales as normal draws (a kernel over sqrt(1 / fan-in),
    the query's also over sqrt(head_dim), the token embedding unit
    normal), RMS scales near 1."""

    emb, mlp = config['emb_dim'], config['mlp_dim']
    inner = config['num_heads'] * config['head_dim']

    def dense(name, out_features, in_features, scale=1.0):
        return [(f'{name}.weight', (out_features, in_features),
                 ('normal', 0.0, scale * in_features ** -0.5))]

    def norm(name):
        return [(f'{name}.weight', (emb,), ('normal', 1.0, 0.1))]

    def attention(name):
        return (dense(f'{name}.query', inner, emb,
                      config['head_dim'] ** -0.5) +
                dense(f'{name}.key', inner, emb) +
                dense(f'{name}.value', inner, emb) +
                dense(f'{name}.out', emb, inner))

    def gated(name):
        return (dense(f'{name}.wi_0', mlp, emb) + dense(f'{name}.wi_1', mlp, emb)
                + dense(f'{name}.wo', emb, mlp))

    spec = dense('encoder.continuous_inputs_projection', emb,
                 config['n_mels'])
    for i in range(config['num_encoder_layers']):
        name = f'encoder.layers_{i}'
        spec += (norm(f'{name}.pre_attention_layer_norm') +
                 attention(f'{name}.attention') +
                 norm(f'{name}.pre_mlp_layer_norm') + gated(f'{name}.mlp'))
    spec += norm('encoder.encoder_norm')
    spec += [('decoder.token_embedder.weight', (config['vocab_size'], emb),
              ('normal', 0.0, 1.0))]
    for i in range(config['num_decoder_layers']):
        name = f'decoder.layers_{i}'
        spec += (norm(f'{name}.pre_self_attention_layer_norm') +
                 attention(f'{name}.self_attention') +
                 norm(f'{name}.pre_cross_attention_layer_norm') +
                 attention(f'{name}.encoder_decoder_attention') +
                 norm(f'{name}.pre_mlp_layer_norm') + gated(f'{name}.mlp'))
    spec += norm('decoder.decoder_norm')
    spec += dense('decoder.logits_dense', config['vocab_size'], emb)

    return spec


##################################################
# FEATURES                                       #
##################################################


def mel_bank(config):
    """TensorFlow's ``linear_to_mel_weight_matrix``: (n_mels, n_fft/2 + 1)
    float32."""

    def mel(freqs):
        return 1127.0 * np.log(1.0 + np.asarray(freqs, np.float64) / 700.0)

    freqs = np.linspace(0.0, config['sample_rate'] / 2.0,
                        config['n_fft'] // 2 + 1)
    edges = np.linspace(mel(config['fmin']), mel(config['fmax']),
                        config['n_mels'] + 2)
    spectrogram_mels = mel(freqs)[:, None]
    lower = (spectrogram_mels - edges[:-2]) / (edges[1:-1] - edges[:-2])
    upper = (edges[2:] - spectrogram_mels) / (edges[2:] - edges[1:-1])
    bank = np.maximum(0.0, np.minimum(lower, upper))
    bank[0] = 0.0

    return bank.T.astype(np.float32)


def segment_samples(config):
    return config['input_length'] * config['hop_length']


def segments_of(audio, config):
    """(B, N) clips -> (B S, segment) segments, the last zero-padded."""

    size = segment_samples(config)
    count = max(1, -(-audio.shape[-1] // size))

    return F.pad(audio, (0, count * size - audio.shape[-1])).reshape(-1, size)


def features(audio, config, precision='float32'):
    """(B, N) float32 clips -> (B S, 1, n_mels, input_length) log-mel
    segments, clip by clip."""

    n_fft, hop = config['n_fft'], config['hop_length']
    audio = segments_of(audio, config)
    frames = -(-audio.shape[-1] // hop)
    audio = F.pad(audio, (0, (frames - 1) * hop + n_fft - audio.shape[-1]))
    window = torch.as_tensor(plain.hann_window(n_fft), dtype=torch.float32,
                             device=audio.device)
    spectrum = torch.fft.rfft(plain.round_to(
        audio.unfold(-1, n_fft, hop) * window, precision), dim=-1)
    magnitude = torch.sqrt(spectrum.real ** 2 +
                           spectrum.imag ** 2).transpose(-1, -2)
    bank = torch.as_tensor(mel_bank(config), device=audio.device)
    bank, magnitude = plain.product_operands(precision, bank, magnitude)
    mel = torch.matmul(bank, magnitude)

    return torch.log(torch.clamp_min(mel, config['log_floor']))[:, None]


##################################################
# FORWARD                                        #
##################################################


def sinusoidal(length, width):
    """t5x's ``FixedEmbed`` table, (length, width) float32."""

    half = width // 2
    position = np.arange(length)[:, None]
    scale = np.exp(np.arange(half) * (-np.log(1.0e4) / (half - 1)))
    table = np.zeros((length, width), dtype=np.float32)
    table[:, :half] = np.sin(position * scale)
    table[:, half:2 * half] = np.cos(position * scale)

    return torch.from_numpy(table)


def _dense(x, params, name, precision):
    return plain.linear(x, params[f'{name}.weight'], None, precision)


def _rms(x, params, name):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * \
        params[f'{name}.weight']


def _attention(params, name, x, kv, config, precision, causal=False):
    batch, heads = x.shape[0], config['num_heads']

    def split(y):
        return y.reshape(batch, -1, heads, config['head_dim']).transpose(1, 2)

    q = split(_dense(x, params, f'{name}.query', precision))
    k = split(_dense(kv, params, f'{name}.key', precision))
    v = split(_dense(kv, params, f'{name}.value', precision))
    q, k = plain.product_operands(precision, q, k)
    scores = torch.matmul(q, k.transpose(-1, -2))
    if causal:
        scores = scores.masked_fill(torch.ones(
            scores.shape[-2:], dtype=torch.bool,
            device=scores.device).triu(1), float('-inf'))
    weights, v = plain.product_operands(precision,
                                        torch.softmax(scores, dim=-1), v)
    y = torch.matmul(weights, v).transpose(1, 2).reshape(batch, x.shape[1], -1)

    return _dense(y, params, f'{name}.out', precision)


def _mlp(params, name, x, precision):
    gate = F.gelu(_dense(x, params, f'{name}.wi_0', precision),
                  approximate='tanh')

    return _dense(gate * _dense(x, params, f'{name}.wi_1', precision), params,
                  f'{name}.wo', precision)


def encode(params, feats, config, precision='float32'):
    """(N, 1, n_mels, T) features -> the (N, T, E) encoder output."""

    x = _dense(feats[:, 0].transpose(1, 2), params,
               'encoder.continuous_inputs_projection', precision)
    x = x + sinusoidal(x.shape[1], x.shape[2]).to(x.device)
    for i in range(config['num_encoder_layers']):
        name = f'encoder.layers_{i}'
        h = _rms(x, params, f'{name}.pre_attention_layer_norm')
        x = x + _attention(params, f'{name}.attention', h, h, config,
                           precision)
        x = x + _mlp(params, f'{name}.mlp',
                     _rms(x, params, f'{name}.pre_mlp_layer_norm'), precision)

    return _rms(x, params, 'encoder.encoder_norm')


def decode_logits(params, encoded, tokens, config, precision='float32'):
    """Teacher forced: (N, L) tokens -> (N, L, vocab) float32 logits of each
    token given the tokens before it (the inputs shifted right behind
    PAD)."""

    inputs = F.pad(tokens[:, :-1], (1, 0), value=PAD)
    y = params['decoder.token_embedder.weight'][inputs]
    y = y + sinusoidal(y.shape[1], y.shape[2]).to(y.device)
    for i in range(config['num_decoder_layers']):
        name = f'decoder.layers_{i}'
        h = _rms(y, params, f'{name}.pre_self_attention_layer_norm')
        y = y + _attention(params, f'{name}.self_attention', h, h, config,
                           precision, causal=True)
        h = _rms(y, params, f'{name}.pre_cross_attention_layer_norm')
        y = y + _attention(params, f'{name}.encoder_decoder_attention', h,
                           encoded, config, precision)
        y = y + _mlp(params, f'{name}.mlp',
                     _rms(y, params, f'{name}.pre_mlp_layer_norm'), precision)

    return _dense(_rms(y, params, 'decoder.decoder_norm'), params,
                  'decoder.logits_dense', precision)


def forward(params, feats, tokens, config, precision='float32', block=BLOCK):
    """(N, 1, n_mels, T) segments and their (N, L) served tokens -> (N, L,
    vocab) teacher-forced logits, ``block`` rows a pass."""

    return torch.cat([
        decode_logits(params, encode(params, feats[start:start + block],
                                     config, precision),
                      tokens[start:start + block], config, precision)
        for start in range(0, feats.shape[0], block)])


##################################################
# CALIBRATION                                    #
##################################################


def calibrate(params, audio, config):
    """Make EOS never the largest logit: its row of ``logits_dense`` set
    to 0, so its logit is 0, which the largest of the other 1,535 never
    falls to. Every row then decodes to the cap. ``audio`` is not read.
    Mutates ``params``."""

    params['decoder.logits_dense.weight'][EOS] = 0.0


##################################################
# DECODE                                         #
##################################################


def decode_segment(tokens, start, seconds):
    """One segment's tokens -> ([(pitch, onset, offset, velocity)], invalid
    count), token by token."""

    tokens = [int(t) for t in tokens]
    if EOS in tokens:
        tokens = tokens[:tokens.index(EOS)]
    notes, invalid = [], 0
    steps, now, latest = 0, start, start
    velocity, active = DEFAULT_VELOCITY, {}

    def close(pitch, end):
        onset, level = active.pop(pitch)
        notes.append((pitch, onset, max(end, onset + MIN_NOTE_DURATION),
                      level))

    for index, token in enumerate(tokens):
        event = token - NUM_SPECIAL
        if not 0 <= event < NUM_EVENTS:
            invalid += 1
        elif event < PITCH:
            steps += event
            now = start + steps / STEPS_PER_SECOND
            if now > start + seconds:
                invalid += len(tokens) - index
                break
        else:
            steps = 0
            if now < latest:
                invalid += 1
                continue
            latest = now
            if event < VELOCITY:
                pitch = event - PITCH
                if pitch in active:
                    close(pitch, now)
                elif velocity == 0:
                    invalid += 1
                if velocity:
                    active[pitch] = (now, velocity)
            elif event < VELOCITY + 128:
                velocity = event - VELOCITY
            else:
                invalid += 1
    for pitch in list(active):
        close(pitch, start + seconds)

    return notes, invalid


def decode(tokens, config):
    """A clip's (S, L) served tokens -> sorted (n, 4) rows (pitch, onset
    ms, offset ms, velocity): each segment decoded from its start."""

    seconds = segment_samples(config) / config['sample_rate']
    rows = []
    for s, segment in enumerate(np.asarray(tokens)):
        rows += decode_segment(segment, s * seconds, seconds)[0]

    return _rows([r[0] for r in rows], [r[1:3] for r in rows],
                 [r[3] for r in rows])


def _rows(pitches, intervals, velocities):
    ms = np.rint(np.asarray(intervals, dtype=np.float64).reshape(-1, 2) *
                 1000.0)
    rows = np.concatenate([np.asarray(pitches).reshape(-1, 1), ms,
                           np.asarray(velocities).reshape(-1, 1)], axis=-1)

    return rows[np.lexsort(rows.T[::-1])].astype(np.int64)


def served(result, config):
    """A served clip's (pitches, intervals, velocities) -> (n, 4) rows as
    :func:`decode` gives them; a result without velocities reads -1 for
    each."""

    pitches, intervals = result[0], result[1]
    velocities = (result[2] if len(result) > 2 else
                  np.full(len(np.asarray(pitches).reshape(-1)), -1))

    return _rows(pitches, intervals, velocities)


def note_mismatches(got, want):
    """Notes one list holds that the other lacks, counted both ways, each
    note as often as it appears."""

    got = collections.Counter(map(tuple, np.asarray(got).tolist()))
    want = collections.Counter(map(tuple, np.asarray(want).tolist()))

    return sum(((got - want) + (want - got)).values())
