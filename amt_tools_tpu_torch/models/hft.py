"""hFT-Transformer (Toyama, Akama, Ikemiya, Takida, Liao and Mitsufuji,
Automatic Piano Transcription with Hierarchical Frequency-Time
Transformer, ISMIR 2023, arXiv:2307.04305): the published
``Model_SPEC2MIDI`` of ``sony/hFT-Transformer`` (``model/model_spec.py``)
in eval mode, and its segmented inference (``model/amt.py``).

The JAX package has no counterpart. Submodule and parameter names are the
published ones (``encoder_spec2midi.conv``, ``encoder_spec2midi.
layers_freq.0.self_attention.fc_q``, ``decoder_spec2midi.layer_zero_freq.
encoder_attention.fc_k``, ``decoder_spec2midi.layers_time.2.
positionwise_feedforward.fc_2``, ``decoder_spec2midi.fc_velocity_time``,
...), so a state dict under those names loads with ``strict=True``. The
layers are ``ops.attention``'s.

- Front end (``encoder_spec2midi``): each output frame's context of
  ``n_margin`` frames a side, (N, 1, n_bin, 2 n_margin + 1); ``conv``, a
  (1, ``cnn_kernel``) convolution to ``cnn_channel`` channels; each bin's
  channel-major values (4 x 61 = 244) through ``tok_embedding_freq`` to
  ``hid_dim``, times ``sqrt(hid_dim)``, plus ``pos_embedding_freq`` over
  the bins.
- Frequency encoder: ``n_layers`` :class:`ops.attention.EncoderLayer` over
  the bins of each frame.
- Frequency decoder (``decoder_spec2midi``): the ``n_note`` learned queries
  ``pos_embedding_freq`` a frame; ``layer_zero_freq`` (cross-attention to
  the encoded bins, no self-attention) and ``n_layers - 1``
  ``layers_freq``; heads A ``fc_onset_freq``, ``fc_offset_freq``,
  ``fc_mpe_freq`` and ``fc_velocity_freq`` (``n_velocity`` classes).
- Time encoder: the queries' outputs of a segment's frames, (N / n_frame *
  n_note, n_frame, hid_dim), times ``sqrt(hid_dim)``, plus
  ``pos_embedding_time``, through ``n_layers`` ``layers_time`` over the
  frames of each pitch; heads B ``fc_onset_time``, ``fc_offset_time``,
  ``fc_mpe_time`` and ``fc_velocity_time``.

:meth:`HFTransformer.forward` takes whole clips, (B, 1, n_bin, T) log-mel
features (``MelSpec`` with ``log_offset``), and segments them as the
published inference does (:func:`pad_segments`): ``n_margin`` frames of
``pad_value`` (``log(1e-8)``, the log of silence) before the clip, the
clip padded with it to whole segments of ``n_frame`` frames and
``n_margin`` frames after. Every segment of the batch runs at once; the
outputs are stitched back to the clip's frames and the padding dropped.
It returns heads B's logits under the keys ``serving.RegressionPipeline``
decodes: ``frame`` (the published mpe), ``reg_onset``, ``reg_offset``,
(B, T, n_note) each, the published outputs before their sigmoids, and
``velocity``, (B, T, n_note, n_velocity) class logits; with
``freq_heads=True`` also heads A's, under the same keys with ``_freq``
appended. The published decoder also returns its last cross-attention
weights; the port does not.

Computation runs in ``dtype`` (e.g. bf16) with float32 parameters and
float32 LayerNorm statistics. The front end runs inside the span
``amt.acoustic``; each of the three stacks (the frequency encoder, the
frequency decoder, the time encoder) inside an ``amt.transformer``. A
forward makes 11 attention calls (``ops.attention.attention``'s counters):
3 ``frequency_self``, 3 ``cross``, 2 ``pitch_self`` and 3 ``time_self``
at the published depth. The published dropout is not applied.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import profiling, tools
from ..ops.attention import DecoderLayer, DecoderLayerZero, EncoderLayer
from ..ops.layers import linear, torch_default_
from .common import TranscriptionModel

__all__ = ['HFTransformer', 'pad_segments']

# The published pad: the log of the feature offset, log(0 + 1e-8)
PAD_VALUE = math.log(1e-8)


def pad_segments(feats, n_frame, n_margin, pad_value):
    """(B, F, T) -> ((B, F, n_margin + S n_frame + n_margin) padded with
    ``pad_value``, S): the clip cut into S = ceil(T / n_frame) whole
    segments with their margins, as the published inference pads it.
    Counts the segments and the frames of padding added to whole segments
    (``pad_segments.segments``, ``pad_segments.padded_frames``)."""

    batch, _, frames = feats.shape
    segments = max(1, -(-frames // n_frame))
    tail = segments * n_frame - frames
    padded = F.pad(feats, (n_margin, tail + n_margin), value=pad_value)
    pad_segments.segments += batch * segments
    pad_segments.padded_frames += batch * tail

    return padded, segments


pad_segments.segments = 0
pad_segments.padded_frames = 0


def _embedding(num, dim, generator):
    table = nn.Embedding(num, dim)
    with torch.no_grad():
        table.weight.normal_(generator=generator)

    return table


def _dense(in_features, out_features, generator):
    return torch_default_(nn.Linear(in_features, out_features), in_features,
                          generator)


def _fused_heads(module, suffix, dtype, x):
    """The onset, offset, mpe and velocity heads ``fc_<head>_<suffix>`` of
    ``module`` as one product over x: (..., 3 + n_velocity)."""

    layers = [getattr(module, f'fc_{head}_{suffix}')
              for head in ('onset', 'offset', 'mpe', 'velocity')]
    weight = torch.cat([layer.weight for layer in layers]).to(dtype)
    bias = torch.cat([layer.bias for layer in layers]).to(dtype)

    return F.linear(x.to(dtype), weight, bias)


def _split_heads(out, suffix=''):
    """(..., T, K, 3 + C) fused head outputs -> the keys' logits."""

    onset, offset, mpe = out[..., 0], out[..., 1], out[..., 2]

    return {f'reg_onset{suffix}': onset, f'reg_offset{suffix}': offset,
            f'frame{suffix}': mpe, f'velocity{suffix}': out[..., 3:]}


class Encoder(nn.Module):
    """The published ``Encoder_SPEC2MIDI``: (B, n_bin, 2 n_margin + M)
    features -> the (B M, n_bin, hid_dim) encoded bins of the M frames
    between the margins."""

    def __init__(self, n_margin, n_bin, cnn_channel, cnn_kernel, hid_dim,
                 n_layers, n_heads, pf_dim, generator):
        super().__init__()
        self.n_proc = 2 * n_margin + 1
        self.hid_dim = hid_dim
        self.conv = torch_default_(nn.Conv2d(1, cnn_channel, (1, cnn_kernel)),
                                   cnn_kernel, generator)
        self.cnn_dim = cnn_channel * (self.n_proc - (cnn_kernel - 1))
        self.tok_embedding_freq = _dense(self.cnn_dim, hid_dim, generator)
        self.pos_embedding_freq = _embedding(n_bin, hid_dim, generator)
        self.layers_freq = nn.ModuleList(
            EncoderLayer(hid_dim, n_heads, pf_dim, 'frequency_self',
                         generator) for _ in range(n_layers))

    def embed(self, spec, dtype):
        """The front end: (B, n_bin, 2 n_margin + M) -> (B M, n_bin,
        hid_dim)."""

        bins = spec.shape[1]
        # Each output frame's context: (B, M, n_bin, n_proc)
        windows = spec.to(dtype).unfold(-1, self.n_proc, 1).transpose(1, 2)
        windows = windows.reshape(-1, 1, bins, self.n_proc)
        conv = F.conv2d(windows, self.conv.weight.to(dtype),
                        self.conv.bias.to(dtype))
        del windows
        # (N, C, n_bin, W) -> (N, n_bin, C W), channel-major a bin
        conv = conv.transpose(1, 2).reshape(-1, bins, self.cnn_dim)
        emb = linear(conv, self.tok_embedding_freq, dtype)
        del conv

        return emb.mul_(self.hid_dim ** 0.5).add_(
            self.pos_embedding_freq.weight.to(dtype))

    def forward(self, spec, dtype):
        with profiling.span('amt.acoustic'):
            x = self.embed(spec, dtype)
        with profiling.span('amt.transformer'):
            for layer in self.layers_freq:
                x = layer(x, dtype)

        return x


class Decoder(nn.Module):
    """The published ``Decoder_SPEC2MIDI``: the frequency decoder with heads
    A, then the time encoder with heads B."""

    def __init__(self, n_frame, n_note, n_velocity, hid_dim, n_layers,
                 n_heads, pf_dim, generator):
        super().__init__()
        self.n_frame = n_frame
        self.n_note = n_note
        self.hid_dim = hid_dim
        self.pos_embedding_freq = _embedding(n_note, hid_dim, generator)
        self.layer_zero_freq = DecoderLayerZero(hid_dim, n_heads, pf_dim,
                                                generator)
        self.layers_freq = nn.ModuleList(
            DecoderLayer(hid_dim, n_heads, pf_dim, generator)
            for _ in range(n_layers - 1))
        for suffix in ('freq', 'time'):
            for head in ('onset', 'offset', 'mpe'):
                setattr(self, f'fc_{head}_{suffix}',
                        _dense(hid_dim, 1, generator))
            setattr(self, f'fc_velocity_{suffix}',
                    _dense(hid_dim, n_velocity, generator))
        self.pos_embedding_time = _embedding(n_frame, hid_dim, generator)
        self.layers_time = nn.ModuleList(
            EncoderLayer(hid_dim, n_heads, pf_dim, 'time_self', generator)
            for _ in range(n_layers))

    def frequency(self, enc, dtype):
        """(N, n_bin, hid_dim) encoded bins -> (N, n_note, hid_dim): the
        queries after the frequency decoder."""

        with profiling.span('amt.transformer'):
            x = self.layer_zero_freq(enc, self.pos_embedding_freq.weight,
                                     dtype)
            for layer in self.layers_freq:
                x = layer(enc, x, dtype)

        return x

    def time(self, midi, dtype):
        """(S n_frame, n_note, hid_dim) -> (S, n_note, n_frame, hid_dim):
        each segment's pitches over its frames, after the time encoder."""

        segments = midi.shape[0] // self.n_frame
        x = midi.view(segments, self.n_frame, self.n_note,
                      self.hid_dim).transpose(1, 2).reshape(
                          -1, self.n_frame, self.hid_dim)
        with profiling.span('amt.transformer'):
            x = x * self.hid_dim ** 0.5 + self.pos_embedding_time.weight.to(
                dtype)
            for layer in self.layers_time:
                x = layer(x, dtype)

        return x.view(segments, self.n_note, self.n_frame, self.hid_dim)


class HFTransformer(TranscriptionModel):
    """hFT-Transformer (the published ``Model_SPEC2MIDI`` with its
    ``encoder_spec2midi`` and ``decoder_spec2midi``): (B, 1, n_bin, T)
    log-mel features -> heads B's logits (the module docstring).

    The defaults are the published widths. ``profile`` is the piano
    (``tools.PianoProfile``, 88 keys, ``n_note``). ``generator`` draws the
    initial values (a fresh generator seeded 0 when omitted)."""

    def __init__(self, n_bin=256, profile=None, n_margin=32, n_frame=128,
                 cnn_channel=4, cnn_kernel=5, hid_dim=256, n_layers=3,
                 n_heads=4, pf_dim=512, n_velocity=128, pad_value=PAD_VALUE,
                 dtype=None, generator=None):
        profile = tools.PianoProfile() if profile is None else profile
        super().__init__(n_bin, profile, dtype=dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n_margin = n_margin
        self.n_frame = n_frame
        self.pad_value = pad_value

        self.encoder_spec2midi = Encoder(n_margin, n_bin, cnn_channel,
                                         cnn_kernel, hid_dim, n_layers,
                                         n_heads, pf_dim, generator)
        self.decoder_spec2midi = Decoder(n_frame, profile.get_range_len(),
                                         n_velocity, hid_dim, n_layers,
                                         n_heads, pf_dim, generator)

    def forward(self, feats, freq_heads=False):
        dtype = self.dtype or feats.dtype
        batch, _, _, frames = feats.shape
        padded, segments = pad_segments(feats[:, 0], self.n_frame,
                                        self.n_margin, self.pad_value)
        decoder = self.decoder_spec2midi

        enc = self.encoder_spec2midi(padded, dtype)
        del padded
        midi = decoder.frequency(enc, dtype)
        del enc
        output = {}
        if freq_heads:
            heads = _fused_heads(decoder, 'freq', dtype, midi).view(
                batch, segments * self.n_frame, decoder.n_note, -1)
            output.update(_split_heads(heads[:, :frames], '_freq'))

        # (B S, K, n_frame, 3 + C) -> (B, K, S n_frame, 3 + C) -> (B, T, K, .)
        heads = _fused_heads(decoder, 'time', dtype, decoder.time(midi, dtype))
        heads = heads.view(batch, segments, decoder.n_note, self.n_frame,
                           -1).transpose(1, 2).reshape(
                               batch, decoder.n_note, segments * self.n_frame,
                               -1)
        output.update(_split_heads(heads[:, :, :frames].transpose(1, 2)))

        return output

    def post_proc(self, batch):
        """Heads B as (B, keys, T) maps: the sigmoids of ``frame``,
        ``reg_onset`` and ``reg_offset``, the velocity class of
        ``velocity``."""

        output = batch[tools.KEY_OUTPUT]
        maps = {key: torch.sigmoid(output[key]).transpose(-1, -2)
                for key in ('frame', 'reg_onset', 'reg_offset')}
        maps['velocity'] = output['velocity'].argmax(-1).transpose(-1, -2)
        batch[tools.KEY_OUTPUT] = maps

        return maps
