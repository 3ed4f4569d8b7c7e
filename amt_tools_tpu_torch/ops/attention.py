"""Multi-head attention, the post-LN transformer layers of hFT-Transformer
(Toyama et al., ISMIR 2023, arXiv:2307.04305; ``sony/hFT-Transformer``
``model/model_spec.py``) and the pre-norm T5 layers of MT3's piano
transcriber (Hawthorne et al., ISMIR 2021, arXiv:2107.09142; ``magenta/
mt3`` ``network.py`` on t5x's ``layers.py``).

The JAX package has no counterpart. Module and parameter names are the
published ones: :class:`MultiHeadAttention` holds ``fc_q``, ``fc_k``,
``fc_v`` and ``fc_o`` (each with a bias) and scales the scores by
``1 / sqrt(head_dim)``; :class:`FeedForward` holds ``fc_1`` and ``fc_2``
with a ReLU between them; each layer holds one ``layer_norm``, which every
sublayer's residual sum passes through (post-LN):

- :class:`EncoderLayer`: ``self_attention``, then
  ``positionwise_feedforward``;
- :class:`DecoderLayerZero` (the published ``DecoderLayer_Zero``):
  ``encoder_attention`` from the queries to the encoded keys, then the
  feed-forward; no self-attention;
- :class:`DecoderLayer`: ``self_attention`` over the queries,
  ``encoder_attention``, the feed-forward.

Every layer computes in ``dtype`` (default: its input's) with float32
parameters. A sublayer's residual sum and its LayerNorm are one call of
``ops.add_layer_norm``: on CUDA, where autograd does not record, the
hand-written kernel that adds and normalizes in one pass over the rows
(counted in ``add_layer_norm.fused``); on the CPU, and wherever autograd
records, the eager add and ``F.layer_norm`` (counted in
``add_layer_norm.plain``). Both keep the statistics in float32 whatever the
input's dtype. The published dropout is not applied: the port serves these
layers (and autograd runs through them) without it.

The T5 layers (t5x's names): :class:`RMSNorm` (T5's ``LayerNorm``: no
mean, no bias, a ``weight`` scale, float32 statistics), :class:`T5Attention`
(bias-free ``query``, ``key``, ``value`` over ``num_heads`` heads of
``head_dim`` and ``out``; no score scale, which T5 folds into the query's
initializer), :class:`GatedMLP` (``wo(gelu(wi_0 x) * wi_1 x)``, GELU's
tanh form), :class:`T5EncoderLayer` (``pre_attention_layer_norm``,
``attention``, ``pre_mlp_layer_norm``, ``mlp``, each sublayer added to its
input) and :class:`T5DecoderLayer` (``pre_self_attention_layer_norm``,
causal ``self_attention``, ``pre_cross_attention_layer_norm``,
``encoder_decoder_attention``, ``pre_mlp_layer_norm``, ``mlp``). A decoder
layer runs a whole sequence (:meth:`T5DecoderLayer.forward`, teacher
forced) or one token against a cache of the keys and values before it
(:meth:`T5DecoderLayer.step`, on weights cast once by
:meth:`T5DecoderLayer.prepare`).

The score-and-value product is :func:`attention`. On CUDA, where autograd
does not record, it is ``F.scaled_dot_product_attention`` restricted to
the flash, cuDNN and memory-efficient backends (``sdpa_kernel``): a shape
none of them takes raises rather than falling to the math backend, which
would write every score to memory. A decoder's self-attention over a
growing cache leaves cuDNN out: its kernel plans a graph for each key
length. On the CPU, and wherever autograd records, it is the plain
product: ``softmax(q k^T / sqrt(d)) v`` (or at the call's ``scale``) with
the softmax in float32. Keys and values may be views, such as a cache's
first positions. Each call counts under its kind (the attention's
``kind``): ``attention.frequency_self``, ``attention.cross``,
``attention.pitch_self`` and ``attention.time_self`` (hFT-Transformer),
``attention.encoder_self``, ``attention.decoder_self`` and
``attention.decoder_cross`` (T5); a call on the plain path also counts in
``attention.plain``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import cuda_build
from .add_layer_norm import add_layer_norm, add_layer_norm_plain
from .layers import _compute_dtype, linear, records, torch_default_

__all__ = ['attention', 'MultiHeadAttention', 'FeedForward', 'EncoderLayer',
           'DecoderLayerZero', 'DecoderLayer', 'RMSNorm', 'T5Attention',
           'GatedMLP', 'T5EncoderLayer', 'T5DecoderLayer', 'KINDS']

# The kinds of attention hFT-Transformer and T5 run, each a counter of
# attention
KINDS = ('frequency_self', 'cross', 'pitch_self', 'time_self',
         'encoder_self', 'decoder_self', 'decoder_cross')

# Kinds whose keys grow a position a call: no cuDNN (a plan a key length)
_GROWING = ('decoder_self',)

# Sequences a fused launch: the flash and memory-efficient kernels put the
# batch on a grid dimension that holds at most 65,535 blocks
MAX_SEQUENCES = 65535


def _fused(q, k, v, options, cudnn=True):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                SDPBackend.EFFICIENT_ATTENTION]
    if not cudnn:
        backends.remove(SDPBackend.CUDNN_ATTENTION)
    with sdpa_kernel(backends):
        return F.scaled_dot_product_attention(q, k, v, **options)


def _plain(q, k, v, scale=None, is_causal=False):
    scores = torch.matmul(q, k.transpose(-1, -2))
    scores = (scores / q.shape[-1] ** 0.5 if scale is None else
              scores * scale).float()
    if is_causal:
        scores = scores.masked_fill(torch.ones(
            scores.shape[-2:], dtype=torch.bool,
            device=scores.device).triu(1), float('-inf'))

    return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)


def attention(q, k, v, kind, scale=None, causal=False):
    """(N, H, L, D) queries over (N, H, S, D) keys and values -> (N, H, L,
    D): ``softmax(scale q k^T) v`` a sequence and head, ``scale`` 1 /
    sqrt(D) unless given (T5's is 1); with ``causal`` query i sees keys 0
    to i alone (``is_causal``'s alignment). The module docstring gives the
    routes: fused on CUDA, plain on the CPU and under autograd. ``kind``
    is one of :data:`KINDS`, the counter the call adds to."""

    if kind not in KINDS:
        raise ValueError(f'kind must be one of {KINDS}, got {kind!r}')
    options = {}
    if scale is not None:
        options['scale'] = scale
    if causal:
        options['is_causal'] = True
    if not q.is_cuda or records(q, k, v):
        cuda_build.count(attention, kind, 'plain')
        return _plain(q, k, v, **options)

    cuda_build.count(attention, kind)
    cudnn = kind not in _GROWING
    if q.stride(0) == 0:
        q = q.contiguous()
    if q.shape[0] <= MAX_SEQUENCES:
        return _fused(q, k, v, options, cudnn)

    return torch.cat([_fused(*(x[start:start + MAX_SEQUENCES]
                               for x in (q, k, v)), options, cudnn)
                      for start in range(0, q.shape[0], MAX_SEQUENCES)])


for _counter in KINDS + ('plain',):
    setattr(attention, _counter, 0)


def _dense(in_features, out_features, generator):
    return torch_default_(nn.Linear(in_features, out_features), in_features,
                          generator)


class MultiHeadAttention(nn.Module):
    """The published ``MultiHeadAttentionLayer``: (N, L, E) queries over
    (N, S, E) keys and values -> (N, L, E). A (L, E) query is shared by
    every sequence of the keys (its projection is computed once).
    ``kind`` names the counter of :func:`attention` the layer adds to."""

    def __init__(self, hid_dim, n_heads, kind, generator):
        super().__init__()
        if hid_dim % n_heads:
            raise ValueError(f'hid_dim {hid_dim} does not divide into '
                             f'{n_heads} heads')
        self.n_heads = n_heads
        self.kind = kind
        self.fc_q = _dense(hid_dim, hid_dim, generator)
        self.fc_k = _dense(hid_dim, hid_dim, generator)
        self.fc_v = _dense(hid_dim, hid_dim, generator)
        self.fc_o = _dense(hid_dim, hid_dim, generator)

    def _heads(self, x):
        """(N, L, E) -> the (N, H, L, E / H) view."""

        return x.unflatten(-1, (self.n_heads, -1)).transpose(1, 2)

    def forward(self, query, key, dtype=None):
        """``key`` gives the keys and the values (every caller's are one
        tensor); the self-attentions pass ``query`` as ``key``."""

        dtype = _compute_dtype(query, dtype)
        q = linear(query, self.fc_q, dtype)
        q = self._heads(q[None] if q.dim() == 2 else q)
        k = self._heads(linear(key, self.fc_k, dtype))
        v = self._heads(linear(key, self.fc_v, dtype))
        x = attention(q.expand(k.shape[0], -1, -1, -1), k, v, self.kind)
        # Drop the projections before the output's is made
        del q, k, v

        return linear(x.transpose(1, 2).flatten(2), self.fc_o, dtype)


class FeedForward(nn.Module):
    """The published ``PositionwiseFeedforwardLayer``: ``fc_2(relu(fc_1
    x))``."""

    def __init__(self, hid_dim, pf_dim, generator):
        super().__init__()
        self.fc_1 = _dense(hid_dim, pf_dim, generator)
        self.fc_2 = _dense(pf_dim, hid_dim, generator)

    def forward(self, x, dtype=None):
        return linear(torch.relu_(linear(x, self.fc_1, dtype)), self.fc_2,
                      dtype)


class _PostLN(nn.Module):
    """A layer's one ``layer_norm`` over each sublayer's residual sum."""

    def __init__(self, hid_dim):
        super().__init__()
        self.layer_norm = nn.LayerNorm(hid_dim)

    def _norm(self, y, residual, dtype):
        """``layer_norm(residual + y)`` in ``dtype``, ``y`` the sublayer's
        output: the kernel on CUDA where autograd does not record, the eager
        ops elsewhere (the module docstring)."""

        norm = self.layer_norm
        args = (y, residual, norm.weight.to(dtype), norm.bias.to(dtype),
                norm.eps)
        if y.is_cuda and not records(*args[:4]):
            return add_layer_norm(*args)
        cuda_build.count(add_layer_norm, 'plain')

        return add_layer_norm_plain(*args)


class EncoderLayer(_PostLN):
    """Self-attention (of ``kind``) and the feed-forward, each added to its
    input and normalized: (N, L, E) -> (N, L, E)."""

    def __init__(self, hid_dim, n_heads, pf_dim, kind, generator):
        super().__init__(hid_dim)
        self.self_attention = MultiHeadAttention(hid_dim, n_heads, kind,
                                                 generator)
        self.positionwise_feedforward = FeedForward(hid_dim, pf_dim,
                                                    generator)

    def forward(self, src, dtype=None):
        dtype = _compute_dtype(src, dtype)
        src = self._norm(self.self_attention(src, src, dtype), src, dtype)

        return self._norm(self.positionwise_feedforward(src, dtype), src,
                          dtype)


class DecoderLayerZero(_PostLN):
    """The first decoder layer: cross-attention from the (Q, E) queries,
    shared by every sequence, or the (N, Q, E) ones to the (N, S, E)
    encoded keys, then the feed-forward -> (N, Q, E)."""

    def __init__(self, hid_dim, n_heads, pf_dim, generator):
        super().__init__(hid_dim)
        self.encoder_attention = MultiHeadAttention(hid_dim, n_heads, 'cross',
                                                    generator)
        self.positionwise_feedforward = FeedForward(hid_dim, pf_dim,
                                                    generator)

    def forward(self, enc_src, trg, dtype=None):
        dtype = _compute_dtype(enc_src, dtype)
        trg = self._norm(self.encoder_attention(trg, enc_src, dtype),
                         trg.to(dtype), dtype)

        return self._norm(self.positionwise_feedforward(trg, dtype), trg,
                          dtype)


class DecoderLayer(_PostLN):
    """Self-attention over the (N, Q, E) queries, cross-attention to the
    (N, S, E) encoded keys, the feed-forward -> (N, Q, E)."""

    def __init__(self, hid_dim, n_heads, pf_dim, generator):
        super().__init__(hid_dim)
        self.self_attention = MultiHeadAttention(hid_dim, n_heads,
                                                 'pitch_self', generator)
        self.encoder_attention = MultiHeadAttention(hid_dim, n_heads, 'cross',
                                                    generator)
        self.positionwise_feedforward = FeedForward(hid_dim, pf_dim,
                                                    generator)

    def forward(self, enc_src, trg, dtype=None):
        dtype = _compute_dtype(trg, dtype)
        trg = self._norm(self.self_attention(trg, trg, dtype), trg, dtype)
        trg = self._norm(self.encoder_attention(trg, enc_src, dtype), trg,
                         dtype)

        return self._norm(self.positionwise_feedforward(trg, dtype), trg,
                          dtype)


def _bias_free(in_features, out_features, std, generator):
    """A bias-free ``nn.Linear`` with weights normal(0, ``std``)."""

    layer = nn.Linear(in_features, out_features, bias=False)
    with torch.no_grad():
        layer.weight.normal_(0.0, std, generator=generator)

    return layer


class RMSNorm(nn.Module):
    """T5's ``LayerNorm`` (t5x ``layers.LayerNorm``): ``x rsqrt(mean(x^2) +
    eps) weight``, the statistics in float32 whatever x's dtype, the
    output in x's dtype."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.rms_norm(x, x.shape[-1:], self.weight.to(x.dtype), self.eps)


class T5Attention(nn.Module):
    """t5x's ``MultiHeadDotProductAttention``: bias-free ``query``, ``key``
    and ``value`` (E -> ``num_heads`` x ``head_dim``) and ``out``, the
    scores unscaled (T5 divides the query's initial weights by sqrt(
    ``head_dim``)). ``kind`` names the counter of :func:`attention` the
    layer adds to. Initial weights normal over sqrt(1 / fan-in), the
    query's over sqrt(1 / (fan-in head_dim))."""

    def __init__(self, emb_dim, num_heads, head_dim, kind, generator):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.kind = kind
        self.query = _bias_free(emb_dim, inner, (emb_dim * head_dim) ** -0.5,
                                generator)
        self.key = _bias_free(emb_dim, inner, emb_dim ** -0.5, generator)
        self.value = _bias_free(emb_dim, inner, emb_dim ** -0.5, generator)
        self.out = _bias_free(inner, emb_dim, inner ** -0.5, generator)

    def heads(self, x):
        """(N, L, H D) -> the (N, H, L, D) view."""

        return x.unflatten(-1, (self.num_heads, -1)).transpose(1, 2)

    def forward(self, x, kv, dtype, causal=False):
        """(N, L, E) queries over the (N, S, E) keys and values ``kv``."""

        q, k, v = (self.heads(linear(y, layer, dtype)) for y, layer in (
            (x, self.query), (kv, self.key), (kv, self.value)))
        y = attention(q, k, v, self.kind, scale=1.0, causal=causal)

        return linear(y.transpose(1, 2).flatten(2), self.out, dtype)


class GatedMLP(nn.Module):
    """t5x's ``MlpBlock`` with the activations ``('gelu', 'linear')``:
    ``wo(gelu(wi_0 x) * wi_1 x)``, bias-free, GELU's tanh form (flax's
    ``nn.gelu``)."""

    def __init__(self, emb_dim, mlp_dim, generator):
        super().__init__()
        self.wi_0 = _bias_free(emb_dim, mlp_dim, emb_dim ** -0.5, generator)
        self.wi_1 = _bias_free(emb_dim, mlp_dim, emb_dim ** -0.5, generator)
        self.wo = _bias_free(mlp_dim, emb_dim, mlp_dim ** -0.5, generator)

    def forward(self, x, dtype):
        return linear(F.gelu(linear(x, self.wi_0, dtype), approximate='tanh') *
                      linear(x, self.wi_1, dtype), self.wo, dtype)


class T5EncoderLayer(nn.Module):
    """Pre-norm self-attention and gated MLP, each added to its input:
    (N, L, E) -> (N, L, E)."""

    def __init__(self, emb_dim, num_heads, head_dim, mlp_dim, generator):
        super().__init__()
        self.pre_attention_layer_norm = RMSNorm(emb_dim)
        self.attention = T5Attention(emb_dim, num_heads, head_dim,
                                     'encoder_self', generator)
        self.pre_mlp_layer_norm = RMSNorm(emb_dim)
        self.mlp = GatedMLP(emb_dim, mlp_dim, generator)

    def forward(self, x, dtype):
        h = self.pre_attention_layer_norm(x)
        x = x + self.attention(h, h, dtype)

        return x + self.mlp(self.pre_mlp_layer_norm(x), dtype)


class T5DecoderLayer(nn.Module):
    """Pre-norm causal self-attention, cross-attention to the encoder's
    output and gated MLP, each added to its input."""

    def __init__(self, emb_dim, num_heads, head_dim, mlp_dim, generator):
        super().__init__()
        self.pre_self_attention_layer_norm = RMSNorm(emb_dim)
        self.self_attention = T5Attention(emb_dim, num_heads, head_dim,
                                          'decoder_self', generator)
        self.pre_cross_attention_layer_norm = RMSNorm(emb_dim)
        self.encoder_decoder_attention = T5Attention(
            emb_dim, num_heads, head_dim, 'decoder_cross', generator)
        self.pre_mlp_layer_norm = RMSNorm(emb_dim)
        self.mlp = GatedMLP(emb_dim, mlp_dim, generator)

    def forward(self, y, encoded, dtype):
        """A whole (N, L, E) sequence, teacher forced, over the (N, S, E)
        encoder output."""

        h = self.pre_self_attention_layer_norm(y)
        y = y + self.self_attention(h, h, dtype, causal=True)
        y = y + self.encoder_decoder_attention(
            self.pre_cross_attention_layer_norm(y), encoded, dtype)

        return y + self.mlp(self.pre_mlp_layer_norm(y), dtype)

    def cross_weight(self):
        """The cross-attention's key and value weights, (2 H D, E): one
        product gives both from the encoder output."""

        attn = self.encoder_decoder_attention
        return torch.cat([attn.key.weight, attn.value.weight])

    def prepare(self, dtype):
        """The weights :meth:`step` takes, cast to ``dtype`` and transposed
        to (in, out) once: the self-attention's query, key and value as one
        (E, 3 H D) product, the MLP's two input projections as one (E, 2 F),
        the other projections alone, and the three norms' scales."""

        self_attn, cross = self.self_attention, self.encoder_decoder_attention
        mlp = self.mlp

        def cast(*layers):
            return torch.cat([layer.weight for layer in layers]).to(dtype).t()

        return {'qkv': cast(self_attn.query, self_attn.key, self_attn.value),
                'self_out': cast(self_attn.out),
                'cross_query': cast(cross.query),
                'cross_out': cast(cross.out),
                'wi': cast(mlp.wi_0, mlp.wi_1), 'wo': cast(mlp.wo),
                'norms': [norm.weight.to(dtype) for norm in (
                    self.pre_self_attention_layer_norm,
                    self.pre_cross_attention_layer_norm,
                    self.pre_mlp_layer_norm)]}

    def step(self, y, position, cache, cross, weights):
        """One token a row: y (N, E) at ``position``; ``cache`` (2, N, H,
        max_len, D) this layer's self-attention keys and values, whose
        ``position`` this step writes; ``cross`` the (N, H, S, D) keys and
        values of the encoder output; ``weights`` from :meth:`prepare`.
        The host's work a step bounds the decode where the device's is
        small, so the step calls torch's functions directly: no module
        calls, views by ``narrow`` and ``select``."""

        rows, heads = y.shape[0], self.self_attention.num_heads
        width, eps = y.shape[-1:], self.pre_self_attention_layer_norm.eps
        norms = weights['norms']

        qkv = torch.mm(torch.rms_norm(y, width, norms[0], eps),
                       weights['qkv']).view(rows, 3, heads, -1)
        cache.select(3, position).copy_(qkv.narrow(1, 1, 2).transpose(0, 1))
        k, v = cache.narrow(3, 0, position + 1)
        x = attention(qkv.select(1, 0).unsqueeze(2), k, v, 'decoder_self',
                      scale=1.0)
        y = torch.addmm(y, x.reshape(rows, -1), weights['self_out'])

        q = torch.mm(torch.rms_norm(y, width, norms[1], eps),
                     weights['cross_query'])
        x = attention(q.view(rows, heads, 1, -1), *cross, 'decoder_cross',
                      scale=1.0)
        y = torch.addmm(y, x.reshape(rows, -1), weights['cross_out'])

        gate, hidden = torch.mm(torch.rms_norm(y, width, norms[2], eps),
                                weights['wi']).chunk(2, dim=-1)

        return torch.addmm(y, F.gelu(gate, approximate='tanh') * hidden,
                           weights['wo'])
