"""The sequence-to-sequence piano transcriber of MT3 (Hawthorne, Simon,
Swavely, Manilow and Engel, Sequence-to-Sequence Piano Transcription with
Transformers, ISMIR 2021, arXiv:2107.09142; ``magenta/mt3``
``network.py``, ``gin/model.gin`` and ``gin/ismir2021.gin``): a T5.1.1
"small" encoder-decoder from log-mel segments to event tokens, decoded
greedily through a cache.

The JAX package has no counterpart. Module and parameter names are t5x's
(``encoder.continuous_inputs_projection``, ``encoder.layers_3.attention.
query``, ``encoder.layers_0.mlp.wi_1``, ``encoder.encoder_norm``,
``decoder.token_embedder``, ``decoder.layers_7.pre_cross_attention_layer_
norm``, ``decoder.layers_2.encoder_decoder_attention.value``,
``decoder.decoder_norm``, ``decoder.logits_dense``, ...) with PyTorch's
leaf names and layouts (``weight``, (out, in)); the layers are
``ops.attention``'s T5 layers.

- Encoder: a segment's (frames, mels) features through the bias-free
  ``continuous_inputs_projection`` plus the fixed sinusoidal position
  embedding (t5x's ``FixedEmbed``), ``num_encoder_layers``
  :class:`ops.attention.T5EncoderLayer`, then ``encoder_norm``.
- Decoder: ``token_embedder`` of the previous token (PAD at the first
  position) plus the position embedding, ``num_decoder_layers``
  :class:`ops.attention.T5DecoderLayer`, ``decoder_norm``, then
  ``logits_dense`` in float32.

:meth:`Seq2SeqTranscriber.forward` is the serving call: :meth:`encode`,
then :meth:`generate`, returning the tokens. :meth:`generate` decodes
greedily, every row at once: each step runs one token a row through the
decoder layers against a preallocated cache of their keys and values and
the keys and values of the encoder output (projected once, in
:meth:`encode`), takes the argmax of the float32 logits (the lowest id
among equal largest logits), and writes PAD for a row that has emitted
EOS. It stops when every row has emitted EOS, or at ``max_len`` tokens.
The stop test never waits for the step it tests: each step copies its
"all ended" flag to pinned host memory, and the loop reads the flag
written :data:`STOP_LAG` (32) steps earlier, waiting only until the device
has reached that step, so that the host stays that many steps ahead, and
as many steps run after the last row ended (each emitting PAD
everywhere).

On the card a step's decoder layers, about 115 launches, cost the host
more than a step of 960 rows costs the card, so each position's layers
are captured once as a CUDA graph and replayed (:class:`_Steps`, with its
cache and the buffer of the encoder output's keys and values, which
:meth:`Seq2SeqTranscriber.forward` projects into directly). The capture is
kept for later decodes of the same segment length, dtype and weights: a
decode of fewer rows replays it with the rows beyond its own as padding
(ended from the first step, their outputs dropped), and only a decode of
more rows captures anew. The logits, argmax and stop test run eagerly
after each replay, so that hooks on ``logits_dense`` see every step, and
the attention counters count each replay's calls.
:meth:`score` is the teacher-forced forward over given tokens, with no
cache, for tests and for autograd.

Computation runs in ``dtype`` (e.g. bf16) with float32 parameters, float32
RMS statistics and float32 logits. The encoder runs inside the span
``amt.transformer``; the cross-attention's key and value projections and
the decode loop inside ``amt.generate``. Inside the loop each
:data:`STOP_LAG` steps open a ``generate.steps`` range: no metric reads
it, but it keeps each node of a trace's tree to a few hundred children (a
step launches about 150 kernels, a batch 1,024 steps), where the
benchmark's attribution of device gaps scans a node's children for each
gap. A forward makes
``num_encoder_layers`` ``encoder_self`` attention calls, and
``num_decoder_layers`` ``decoder_self`` and ``decoder_cross`` calls a step
(``ops.attention.attention``'s counters). Dropout is not applied.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import profiling, tools
from ..ops import cuda_build
from ..ops.attention import (KINDS as ATTENTION_KINDS, RMSNorm,
                             T5DecoderLayer, T5EncoderLayer, attention)
from ..ops.layers import linear
from ..tools import event_codec
from .common import TranscriptionModel

__all__ = ['Seq2SeqTranscriber', 'sinusoidal', 'STOP_LAG']

# Steps the stop test reads behind the step it launches: on the card the
# host keeps this many steps queued (about 190 ms at MT3's cell), so that
# its decode of the previous batch's tokens runs while the card works
STOP_LAG = 32

def sinusoidal(length, features, min_scale=1.0, max_scale=10000.0):
    """t5x's ``FixedEmbed`` table, (length, features) float32: sines of the
    first half of the features, cosines of the second, at timescales from
    ``min_scale`` to ``max_scale``."""

    half = features // 2
    position = np.arange(length)[:, None]
    scale = min_scale * np.exp(np.arange(half) *
                               (-np.log(max_scale / min_scale) / (half - 1)))
    table = np.zeros((length, features), dtype=np.float32)
    table[:, :half] = np.sin(position * scale)
    table[:, half:2 * half] = np.cos(position * scale)

    return torch.from_numpy(table)


def _layers(module, count, make):
    """``layers_0`` to ``layers_{count - 1}`` on ``module``, t5x's names."""

    for i in range(count):
        setattr(module, f'layers_{i}', make())

    return [getattr(module, f'layers_{i}') for i in range(count)]


class Encoder(nn.Module):
    """MT3's encoder: (N, T, n_mels) features -> the (N, T, E) encoded
    frames."""

    def __init__(self, n_mels, emb_dim, num_heads, head_dim, mlp_dim,
                 num_layers, generator):
        super().__init__()
        self.continuous_inputs_projection = nn.Linear(n_mels, emb_dim,
                                                      bias=False)
        with torch.no_grad():
            self.continuous_inputs_projection.weight.normal_(
                0.0, n_mels ** -0.5, generator=generator)
        self.layers = _layers(self, num_layers, lambda: T5EncoderLayer(
            emb_dim, num_heads, head_dim, mlp_dim, generator))
        self.encoder_norm = RMSNorm(emb_dim)

    def forward(self, inputs, positions, dtype):
        x = linear(inputs, self.continuous_inputs_projection, dtype)
        x = (x.float() + positions[:x.shape[1]]).to(dtype)
        for layer in self.layers:
            x = layer(x, dtype)

        return self.encoder_norm(x)


class Decoder(nn.Module):
    """MT3's decoder: tokens -> float32 logits over ``vocab_size`` ids."""

    def __init__(self, vocab_size, emb_dim, num_heads, head_dim, mlp_dim,
                 num_layers, generator):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.token_embedder = nn.Embedding(vocab_size, emb_dim)
        with torch.no_grad():
            self.token_embedder.weight.normal_(generator=generator)
        self.layers = _layers(self, num_layers, lambda: T5DecoderLayer(
            emb_dim, num_heads, head_dim, mlp_dim, generator))
        self.decoder_norm = RMSNorm(emb_dim)
        self.logits_dense = nn.Linear(emb_dim, vocab_size, bias=False)
        with torch.no_grad():
            self.logits_dense.weight.normal_(0.0, emb_dim ** -0.5,
                                             generator=generator)

    def embed(self, tokens, positions, dtype):
        """The token embedding plus the position embedding, summed in
        float32 (t5x's promotion), in ``dtype``."""

        return (F.embedding(tokens, self.token_embedder.weight) +
                positions).to(dtype)

    def logits(self, y):
        return self.logits_dense(self.decoder_norm(y).float())

    def forward(self, tokens, encoded, positions, dtype):
        """Teacher forced: (N, L) tokens -> (N, L, vocab) logits of each
        next token, the inputs shifted right behind PAD."""

        inputs = F.pad(tokens[:, :-1], (1, 0), value=event_codec.PAD)
        y = self.embed(inputs, positions[:tokens.shape[1]], dtype)
        for layer in self.layers:
            y = layer(y, encoded, dtype)

        return self.logits(y)

    def cross(self, encoded, out=None):
        """The cross-attentions' keys and values of the (N, S, E) encoder
        output, one product for every layer: (N, S, 2 layers H D), written
        into ``out`` when given."""

        weight = torch.cat([layer.cross_weight() for layer in self.layers])

        return torch.matmul(encoded, weight.to(encoded.dtype).t(), out=out)

    def split(self, kv):
        """:meth:`cross`'s output -> a (k, v) pair of (N, H, S, D) views a
        layer."""

        kv = kv.view(*kv.shape[:2], 2 * len(self.layers), self.num_heads,
                     self.head_dim).permute(2, 0, 3, 1, 4)

        return list(zip(kv[0::2], kv[1::2]))

    def steps(self, rows, frames, dtype, device, positions, max_len):
        """The :class:`_Steps` of a decode of ``rows`` rows over ``frames``
        encoded frames: the kept one if it was made for this length, dtype,
        device and weights and holds at least ``rows`` rows (the rest
        padding), else a new one, captured on the card, which replaces
        it."""

        key = _Steps.key(self, frames, dtype, device, positions, max_len)
        steps = getattr(self, '_kept', None)
        if steps is None or steps.id != key or steps.rows < rows:
            # The old cache and graphs go before the new ones are made
            self._kept = steps = None
            steps = _Steps(self, rows, frames, dtype, device, positions,
                           max_len, key)
            if device.type == 'cuda':
                steps.capture()
            self._kept = steps

        return steps

    def generate(self, kv, positions, max_len):
        """Greedy decoding (the module docstring) over :meth:`cross`'s
        output -> (N, steps) int64 tokens, steps at most ``max_len``; the
        stop test reads :data:`STOP_LAG` steps behind."""

        with torch.no_grad():
            return self._generate(kv, positions, max_len)

    def _generate(self, kv, positions, max_len):
        rows, device = kv.shape[0], kv.device
        steps = self.steps(rows, kv.shape[1], kv.dtype, device, positions,
                           max_len)
        if kv.data_ptr() != steps.kv.data_ptr():
            steps.kv[:rows].copy_(kv)
        steps.token.fill_(event_codec.PAD)
        tokens = torch.empty((steps.rows, max_len), dtype=torch.long,
                             device=device)
        # The padding rows have ended before the first step
        ended = torch.arange(steps.rows, device=device) >= rows
        on_card = device.type == 'cuda'
        lag = STOP_LAG
        flags = torch.zeros(max_len, dtype=torch.bool, pin_memory=on_card)
        events = ([torch.cuda.Event() for _ in range(lag + 1)] if on_card
                  else None)

        chunk = max(lag, 1)
        for first in range(0, max_len, chunk):
            with profiling.span('generate.steps'):
                for t in range(first, min(first + chunk, max_len)):
                    steps.run(t)
                    # The lowest id among equal largest logits (argmax's
                    # rule)
                    token = self.logits_dense(steps.y).argmax(
                        -1).masked_fill_(ended, event_codec.PAD)
                    ended |= token == event_codec.EOS
                    tokens[:, t] = token
                    steps.token.copy_(token)
                    flags[t].copy_(ended.all(), non_blocking=True)
                    if on_card:
                        events[t % (lag + 1)].record()
                        if t >= lag:
                            events[(t - lag) % (lag + 1)].synchronize()
                    if t >= lag and flags[t - lag]:
                        return tokens[:rows, :t + 1]

        return tokens[:rows]


class _Steps:
    """The decoder layers' side of every step of one decode shape: the
    previous tokens in ``token``, the layers' output in ``y``, the
    self-attention cache, the encoder output's keys and values (``kv``,
    (rows, frames, 2 layers H D), written by each decode) and the weights
    as :meth:`T5DecoderLayer.prepare` casts them, all held at fixed
    addresses for ``rows`` rows. On the card :meth:`capture` records each
    position's step, from the embedding to ``y``, as a CUDA graph, and
    :meth:`run` replays it: one launch in place of about 115, whose host
    work would bound the loop (the module docstring). The logits, the
    argmax and the stop test stay eager, so that hooks on ``logits_dense``
    see every step."""

    def __init__(self, decoder, rows, frames, dtype, device, positions,
                 max_len, key):
        self.id = key
        self.rows = rows
        self.decoder = decoder
        self.positions = positions
        self.dtype = dtype
        layers = decoder.layers
        heads, head_dim = decoder.num_heads, decoder.head_dim
        # Plain tensors, which a later decode may update outside inference
        # mode. The inputs are zeroed for the capture's eager step: an id
        # outside the vocabulary there fails the embedding's gather on the
        # card, and that failure leaves the process's CUDA context unusable
        with torch.inference_mode(False):
            self.kv = torch.zeros((rows, frames,
                                   2 * len(layers) * heads * head_dim),
                                  dtype=dtype, device=device)
            self.cross = decoder.split(self.kv)
            self.weights = [layer.prepare(dtype) for layer in layers]
            self.cache = torch.empty((len(layers), 2, rows, heads, max_len,
                                      head_dim), dtype=dtype, device=device)
            self.token = torch.zeros(rows, dtype=torch.long, device=device)
            self.y = torch.empty((rows, positions.shape[1]),
                                 dtype=torch.float32, device=device)
        self.graphs = None

    @staticmethod
    def key(decoder, frames, dtype, device, positions, max_len):
        """What a capture depends on beside its rows: the encoded frames,
        the cap, dtype and device, and every parameter's storage and
        version (an in-place change of a weight bumps its version)."""

        return (frames, dtype, torch.device(device), max_len,
                positions.data_ptr(),
                tuple((p.data_ptr(), p._version)
                      for p in decoder.parameters()))

    def layers(self, t):
        """``token`` -> ``y``: the embedding, the layers at position ``t``
        and the final norm, in float32 for ``logits_dense``."""

        decoder = self.decoder
        y = decoder.embed(self.token, self.positions[t], self.dtype)
        for layer, *state in zip(decoder.layers, self.cache, self.cross,
                                 self.weights):
            y = layer.step(y, t, *state)
        self.y.copy_(decoder.decoder_norm(y))

    def capture(self):
        """One graph a position, all in one memory pool (the steps run one
        after another), after one eager step on the capture's stream that
        sets up cuBLAS's and cuDNN's state. The attention counters count
        replays, not the capture."""

        counted = {kind: getattr(attention, kind)
                   for kind in ATTENTION_KINDS + ('plain',)}
        side = torch.cuda.Stream(self.y.device)
        side.wait_stream(torch.cuda.current_stream(self.y.device))
        graphs, pool = [], None
        with torch.cuda.stream(side):
            self.layers(0)
            for t in range(self.cache.shape[4]):
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool)
                try:
                    self.layers(t)
                finally:
                    graph.capture_end()
                pool = graph.pool()
                graphs.append(graph)
        torch.cuda.current_stream(self.y.device).wait_stream(side)
        for kind, value in counted.items():
            setattr(attention, kind, value)
        self.graphs = graphs

    def run(self, t):
        """The layers of step ``t``: ``token`` -> ``y``."""

        if self.graphs is None:
            self.layers(t)
            return
        self.graphs[t].replay()
        for _ in self.decoder.layers:
            cuda_build.count(attention, 'decoder_self', 'decoder_cross')


class Seq2SeqTranscriber(TranscriptionModel):
    """MT3's piano transcriber (the module docstring): (N, 1, n_mels, T)
    log-mel segments -> generated token ids.

    The defaults are the published widths (T5.1.1 small, 1,536
    embeddings, 1,024 tokens a segment). ``profile`` is the piano
    (``tools.PianoProfile``). ``generator`` draws the initial values (a
    fresh generator seeded 0 when omitted): t5x's initializer scales, as
    normal draws."""

    def __init__(self, n_mels=512, emb_dim=512, num_heads=6, head_dim=64,
                 mlp_dim=1024, num_encoder_layers=8, num_decoder_layers=8,
                 vocab_size=1536, max_len=1024, max_positions=2048,
                 profile=None, dtype=None, generator=None):
        profile = tools.PianoProfile() if profile is None else profile
        super().__init__(n_mels, profile, dtype=dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.max_len = max_len
        self.encoder = Encoder(n_mels, emb_dim, num_heads, head_dim, mlp_dim,
                               num_encoder_layers, generator)
        self.decoder = Decoder(vocab_size, emb_dim, num_heads, head_dim,
                               mlp_dim, num_decoder_layers, generator)
        self.register_buffer('positions',
                             sinusoidal(max_positions, emb_dim),
                             persistent=False)

    def _dtype(self, feats):
        return self.dtype or feats.dtype

    def encode(self, feats, kv=None):
        """(N, 1, n_mels, T) features -> ((N, T, E) encoder output, the
        cross-attentions' keys and values of every decoder layer, (N, T, 2
        layers H D), written into ``kv`` when given)."""

        dtype = self._dtype(feats)
        with profiling.span('amt.transformer'):
            encoded = self.encoder(feats[:, 0].transpose(1, 2),
                                   self.positions, dtype)
        with profiling.span('amt.generate'):
            kv = self.decoder.cross(encoded, kv)

        return encoded, kv

    def generate(self, encoded, max_len=None):
        """:meth:`encode`'s output -> (N, steps) int64 tokens, greedy
        through the cache, at most ``max_len`` (default: the model's)."""

        with profiling.span('amt.generate'):
            return self.decoder.generate(encoded[1], self.positions,
                                         max_len or self.max_len)

    def forward(self, feats, max_len=None):
        """:meth:`encode`, the keys and values projected straight into the
        decode's buffer, then :meth:`generate`."""

        max_len = max_len or self.max_len
        with torch.no_grad():
            steps = self.decoder.steps(feats.shape[0], feats.shape[-1],
                                       self._dtype(feats), feats.device,
                                       self.positions, max_len)
            encoded = self.encode(feats, steps.kv[:feats.shape[0]])

            return self.generate(encoded, max_len)

    def score(self, feats, tokens):
        """Teacher forced, without a cache: (N, 1, n_mels, T) features and
        (N, L) tokens -> (N, L, vocab) float32 logits of each token given
        those before it."""

        dtype = self._dtype(feats)
        encoded = self.encoder(feats[:, 0].transpose(1, 2), self.positions,
                               dtype)

        return self.decoder(tokens, encoded, self.positions, dtype)

    def post_proc(self, batch):
        """The generated tokens stay as they are: the serving pipeline
        decodes them to notes on the host."""

        return batch[tools.KEY_OUTPUT]
