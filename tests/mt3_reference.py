"""Plain float32 reference of MT3's sequence-to-sequence piano transcriber
(Hawthorne et al., ISMIR 2021, arXiv:2107.09142; ``magenta/mt3``
``network.py``, ``spectrograms.py``, ``run_length_encoding.py`` and
``note_sequences.py``): its features, the teacher-forced T5 forward with
no cache, and the decode of a segment's tokens, token by token.

Plain PyTorch and NumPy with no kernel of the port; every product runs in
float32 with TF32 off (:func:`exact_float32`). Parameters are named as the
port's state dict, so the tests hand the same tensors to both.

- Features: segments of ``input_length`` hops, each framed from its first
  sample and zero-padded at its end, periodic Hann, |rfft|, TensorFlow's
  ``linear_to_mel_weight_matrix`` (HTK mels, triangles in mels, no area
  norm, DC zeroed), ``log(max(mel, log_floor))``.
- Network: RMS(x) = x / sqrt(mean(x^2) + 1e-6) * g; encoder x = W_in mel +
  P, per layer x += Attn(RMS(x)), x += wo(gelu(wi_0 RMS(x)) * wi_1
  RMS(x)), ``encoder_norm``; decoder y = E[previous token, PAD first] + P,
  per layer causal self-attention, cross-attention, MLP, each pre-normed
  and added, ``decoder_norm``, ``logits_dense``. Attention is softmax(q
  k^T) v with no scale; GELU the tanh form; P t5x's sinusoidal table.
- Decode (the rules of ``tools/event_codec.py``): the row ends at EOS;
  runs of shifts set the clock from the segment's start; a shift past the
  segment's end drops the rest; an event before the latest is invalid;
  velocity 0 closes a pitch, another velocity opens one; a note open at the
  end closes at the segment's end; notes last at least 10 ms.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

PAD, EOS = 0, 1
PITCH, VELOCITY, TIE, NUM_EVENTS = 1001, 1129, 1257, 1514


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


def mel_bank(sample_rate, n_fft, n_mels, fmin, fmax):
    """(n_mels, n_fft/2 + 1) float32, filter by filter, bin by bin."""

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    edges = np.linspace(mel(fmin), mel(fmax), n_mels + 2)
    bins = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    bank = np.zeros((n_mels, len(bins)))
    for m in range(n_mels):
        for k in range(1, len(bins)):
            x = mel(bins[k])
            rise = (x - edges[m]) / (edges[m + 1] - edges[m])
            fall = (edges[m + 2] - x) / (edges[m + 2] - edges[m + 1])
            bank[m, k] = max(0.0, min(rise, fall))

    return bank.astype(np.float32)


def features(audio, config):
    """(B, N) float32 audio -> (B S, 1, n_mels, input_length)."""

    n_fft, hop = config['n_fft'], config['hop_length']
    size = config['input_length'] * hop
    count = max(1, -(-audio.shape[-1] // size))
    segments = F.pad(audio, (0, count * size - audio.shape[-1])).reshape(
        -1, size)
    frames = segments.shape[-1] // hop
    padded = F.pad(segments, (0, (frames - 1) * hop + n_fft - size))
    n = np.arange(n_fft)
    window = torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft),
                             dtype=torch.float32, device=audio.device)
    spectrum = torch.fft.rfft(padded.unfold(-1, n_fft, hop) * window, dim=-1)
    magnitude = spectrum.abs()                                # (R, T, bins)
    bank = torch.as_tensor(mel_bank(config['sample_rate'], n_fft,
                                    config['n_mels'], config['fmin'],
                                    config['fmax']), device=audio.device)
    mel = torch.matmul(magnitude, bank.t())                   # (R, T, mels)

    return torch.log(torch.clamp_min(mel, config['log_floor'])).transpose(
        1, 2)[:, None]


# The network


def _positions(length, width):
    half = width // 2
    scale = np.exp(-np.log(1e4) * np.arange(half) / (half - 1))
    angle = np.arange(length)[:, None] * scale
    return torch.from_numpy(np.concatenate(
        [np.sin(angle), np.cos(angle)], axis=1).astype(np.float32))


def _rms(x, weight):
    return x / torch.sqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) * weight


def _attention(params, name, x, kv, heads, causal):
    batch = x.shape[0]

    def split(y):
        return y.view(batch, y.shape[1], heads, -1).permute(0, 2, 1, 3)

    q = split(x @ params[f'{name}.query.weight'].t())
    k = split(kv @ params[f'{name}.key.weight'].t())
    v = split(kv @ params[f'{name}.value.weight'].t())
    scores = q @ k.transpose(-1, -2)
    if causal:
        length = scores.shape[-1]
        future = torch.arange(length)[None] > torch.arange(length)[:, None]
        scores = scores.masked_fill(future.to(scores.device), float('-inf'))
    y = (torch.softmax(scores, -1) @ v).permute(0, 2, 1, 3).reshape(
        batch, x.shape[1], -1)

    return y @ params[f'{name}.out.weight'].t()


def _mlp(params, name, x):
    gate = F.gelu(x @ params[f'{name}.wi_0.weight'].t(), approximate='tanh')
    return (gate * (x @ params[f'{name}.wi_1.weight'].t())) @ \
        params[f'{name}.wo.weight'].t()


def encode(params, feats, config):
    """(N, 1, n_mels, T) -> (N, T, E) encoder output."""

    x = feats[:, 0].transpose(1, 2) @ \
        params['encoder.continuous_inputs_projection.weight'].t()
    x = x + _positions(x.shape[1], x.shape[2]).to(x.device)
    for i in range(config['num_encoder_layers']):
        p = f'encoder.layers_{i}'
        h = _rms(x, params[f'{p}.pre_attention_layer_norm.weight'])
        x = x + _attention(params, f'{p}.attention', h, h,
                           config['num_heads'], False)
        x = x + _mlp(params, f'{p}.mlp',
                     _rms(x, params[f'{p}.pre_mlp_layer_norm.weight']))

    return _rms(x, params['encoder.encoder_norm.weight'])


def logits(params, encoded, tokens, config):
    """Teacher forced over (N, L) tokens -> (N, L, vocab) logits."""

    inputs = torch.cat([torch.full_like(tokens[:, :1], PAD), tokens[:, :-1]],
                       dim=1)
    y = params['decoder.token_embedder.weight'][inputs]
    y = y + _positions(y.shape[1], y.shape[2]).to(y.device)
    for i in range(config['num_decoder_layers']):
        p = f'decoder.layers_{i}'
        h = _rms(y, params[f'{p}.pre_self_attention_layer_norm.weight'])
        y = y + _attention(params, f'{p}.self_attention', h, h,
                           config['num_heads'], True)
        h = _rms(y, params[f'{p}.pre_cross_attention_layer_norm.weight'])
        y = y + _attention(params, f'{p}.encoder_decoder_attention', h,
                           encoded, config['num_heads'], False)
        y = y + _mlp(params, f'{p}.mlp',
                     _rms(y, params[f'{p}.pre_mlp_layer_norm.weight']))

    return _rms(y, params['decoder.decoder_norm.weight']) @ \
        params['decoder.logits_dense.weight'].t()


# The decode


def decode_segment(tokens, start, seconds):
    """A segment's tokens -> ([(pitch, onset, offset, velocity)], invalid
    count)."""

    notes, invalid = [], 0
    steps, now, latest, velocity, active = 0, start, start, 100, {}
    tokens = [int(t) for t in tokens]
    if EOS in tokens:
        tokens = tokens[:tokens.index(EOS)]
    for i, token in enumerate(tokens):
        event = token - 3
        if event < 0 or event >= NUM_EVENTS:
            invalid += 1
            continue
        if event < PITCH:
            steps += event
            now = start + steps / 100
            if now > start + seconds:
                invalid += len(tokens) - i
                break
            continue
        steps = 0
        if now < latest:
            invalid += 1
            continue
        latest = now
        if PITCH <= event < VELOCITY:
            pitch = event - PITCH
            if pitch in active:
                onset, level = active.pop(pitch)
                notes.append((pitch, onset, max(now, onset + 0.01), level))
            elif velocity == 0:
                invalid += 1
            if velocity > 0:
                active[pitch] = (now, velocity)
        elif VELOCITY <= event < TIE:
            velocity = event - VELOCITY
        else:
            invalid += 1
    for pitch, (onset, level) in active.items():
        notes.append((pitch, onset, max(start + seconds, onset + 0.01), level))

    return notes, invalid
