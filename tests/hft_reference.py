"""Plain float32 reference of hFT-Transformer (Toyama et al., ISMIR 2023,
arXiv:2307.04305): the published ``Model_SPEC2MIDI`` of ``sony/
hFT-Transformer`` (``model/model_spec.py``) in eval mode, its features,
and its segmented inference (``model/amt.py`` ``transcript``), one clip and
one segment at a time.

Plain PyTorch and NumPy with no kernel of the port; every product runs in
float32 with TF32 off (the caller holds ``hpt_reference.exact_float32``).
Parameters are named as the published state dict, so the tests hand the
same tensors to the port and to this file.

Departures from the published code:
- the STFT and mel bank are computed here (the published features call
  torchaudio's ``MelSpectrogram``): periodic Hann window, centred frames
  with zero padding, |X|^2, HTK-scale mel filters with Slaney's area
  normalization, ``log(mel + 1e-8)``;
- no dropout, and the decoder's cross-attention weights are not returned.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


# Features


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_bank(sample_rate, n_fft, n_mels, fmin, fmax):
    """torchaudio's ``melscale_fbanks(mel_scale='htk', norm='slaney')``:
    (n_mels, n_fft/2 + 1) float32."""

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
    """(B, N) float32 audio -> (B, 1, n_bin, T) ``log(mel + 1e-8)``."""

    n_fft, hop = config['n_fft'], config['hop_length']
    n = np.arange(n_fft)
    window = torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft),
                             dtype=torch.float32, device=audio.device)
    padded = F.pad(audio, (n_fft // 2, n_fft // 2))
    frames = padded.unfold(-1, n_fft, hop)
    spectrum = torch.fft.rfft(frames * window, dim=-1)
    power = spectrum.real ** 2 + spectrum.imag ** 2          # (B, T, bins)
    bank = torch.as_tensor(mel_bank(config['sample_rate'], n_fft,
                                    config['n_bin'], config['fmin'],
                                    config['fmax']), device=audio.device)
    mel = torch.matmul(power, bank.t())                      # (B, T, mels)

    return torch.log(mel + config['log_offset']).transpose(1, 2)[:, None]


# The model


def _linear(x, params, name):
    return x @ params[f'{name}.weight'].t() + params[f'{name}.bias']


def _attention(params, name, query, key, value, n_heads):
    """The published ``MultiHeadAttentionLayer``."""

    batch, hid = query.shape[0], query.shape[-1]
    head_dim = hid // n_heads

    def heads(x):
        return x.view(batch, -1, n_heads, head_dim).permute(0, 2, 1, 3)

    q = heads(_linear(query, params, f'{name}.fc_q'))
    k = heads(_linear(key, params, f'{name}.fc_k'))
    v = heads(_linear(value, params, f'{name}.fc_v'))
    energy = torch.matmul(q, k.permute(0, 1, 3, 2)) / math.sqrt(head_dim)
    x = torch.matmul(torch.softmax(energy, dim=-1), v)
    x = x.permute(0, 2, 1, 3).contiguous().view(batch, -1, hid)

    return _linear(x, params, f'{name}.fc_o')


def _feedforward(params, name, x):
    return _linear(torch.relu(_linear(x, params, f'{name}.fc_1')), params,
                   f'{name}.fc_2')


def _norm(params, name, x):
    return F.layer_norm(x, x.shape[-1:], params[f'{name}.layer_norm.weight'],
                        params[f'{name}.layer_norm.bias'], 1e-5)


def _encoder_layer(params, name, src, n_heads):
    src = _norm(params, name, src + _attention(
        params, f'{name}.self_attention', src, src, src, n_heads))

    return _norm(params, name, src + _feedforward(
        params, f'{name}.positionwise_feedforward', src))


def _decoder_layer(params, name, enc, trg, n_heads, zero):
    if not zero:
        trg = _norm(params, name, trg + _attention(
            params, f'{name}.self_attention', trg, trg, trg, n_heads))
    trg = _norm(params, name, trg + _attention(
        params, f'{name}.encoder_attention', trg, enc, enc, n_heads))

    return _norm(params, name, trg + _feedforward(
        params, f'{name}.positionwise_feedforward', trg))


def _heads(params, x, suffix, shape):
    out = {}
    for key, head in (('reg_onset', 'onset'), ('reg_offset', 'offset'),
                      ('frame', 'mpe')):
        out[key] = _linear(x, params,
                           f'decoder_spec2midi.fc_{head}_{suffix}').reshape(
                               shape)
    out['velocity'] = _linear(
        x, params, f'decoder_spec2midi.fc_velocity_{suffix}').reshape(
            shape + (-1,))

    return out


def segment_forward(params, spec, config):
    """The published ``Model_SPEC2MIDI.forward`` on (S, n_bin, n_margin +
    n_frame + n_margin) segments -> (heads A, heads B), each {key: (S,
    n_frame, n_note[, n_velocity]) logits}."""

    n_margin, n_frame = config['n_margin'], config['n_frame']
    n_bin, hid = config['n_bin'], config['hid_dim']
    n_heads, n_note = config['n_heads'], config['n_note']
    n_proc = 2 * n_margin + 1
    batch = spec.shape[0]

    # Encoder_SPEC2MIDI
    x = spec.unfold(2, n_proc, 1).permute(0, 2, 1, 3).contiguous()
    x = x.reshape(batch * n_frame, n_bin, n_proc).unsqueeze(1)
    x = F.conv2d(x, params['encoder_spec2midi.conv.weight'],
                 params['encoder_spec2midi.conv.bias'])
    x = x.permute(0, 2, 1, 3).contiguous().reshape(batch * n_frame, n_bin,
                                                   -1)
    x = _linear(x, params, 'encoder_spec2midi.tok_embedding_freq')
    x = x * math.sqrt(hid) + params['encoder_spec2midi.pos_embedding_freq.'
                                    'weight'][None]
    for layer in range(config['n_layers']):
        x = _encoder_layer(params, f'encoder_spec2midi.layers_freq.{layer}',
                           x, n_heads)
    enc = x

    # Decoder_SPEC2MIDI: the frequency decoder
    trg = params['decoder_spec2midi.pos_embedding_freq.weight'][None].repeat(
        batch * n_frame, 1, 1)
    trg = _decoder_layer(params, 'decoder_spec2midi.layer_zero_freq', enc,
                         trg, n_heads, zero=True)
    for layer in range(config['n_layers'] - 1):
        trg = _decoder_layer(params, f'decoder_spec2midi.layers_freq.{layer}',
                             enc, trg, n_heads, zero=False)
    heads_a = _heads(params, trg, 'freq', (batch, n_frame, n_note))

    # The time encoder
    x = trg.reshape(batch, n_frame, n_note, hid).permute(0, 2, 1, 3)
    x = x.contiguous().reshape(batch * n_note, n_frame, hid)
    x = x * math.sqrt(hid) + params['decoder_spec2midi.pos_embedding_time.'
                                    'weight'][None]
    for layer in range(config['n_layers']):
        x = _encoder_layer(params, f'decoder_spec2midi.layers_time.{layer}',
                           x, n_heads)
    heads_b = _heads(params, x, 'time', (batch, n_note, n_frame))
    heads_b = {key: value.transpose(1, 2) for key, value in heads_b.items()}

    return heads_a, heads_b


def forward(params, feats, config):
    """(B, 1, n_bin, T) features -> (heads A, heads B), {key: (B, T,
    n_note[, n_velocity]) logits}: the published ``transcript``, one clip
    and one segment at a time. Each clip is padded with ``pad_value``:
    ``n_margin`` frames before it, to whole segments and ``n_margin``
    frames after; each segment's outputs fill its frames."""

    n_margin, n_frame = config['n_margin'], config['n_frame']
    outputs = ([], [])
    for clip in feats[:, 0]:
        frames = clip.shape[1]
        tail = -(-frames // n_frame) * n_frame - frames
        padded = torch.cat([
            clip.new_full((clip.shape[0], n_margin), config['pad_value']),
            clip, clip.new_full((clip.shape[0], tail + n_margin),
                                config['pad_value'])], dim=1)
        parts = ([], [])
        for start in range(0, frames, n_frame):
            spec = padded[:, start:start + 2 * n_margin + n_frame][None]
            for part, heads in zip(parts, segment_forward(params, spec,
                                                          config)):
                part.append(heads)
        for output, part in zip(outputs, parts):
            output.append({key: torch.cat([p[key][0] for p in part])[:frames]
                           for key in part[0]})

    return tuple({key: torch.stack([clip[key] for clip in output])
                  for key in output[0]} for output in outputs)
