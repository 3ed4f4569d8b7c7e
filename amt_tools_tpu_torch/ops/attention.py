"""Multi-head attention and the post-LN transformer layers of
hFT-Transformer (Toyama et al., ISMIR 2023, arXiv:2307.04305; ``sony/
hFT-Transformer`` ``model/model_spec.py``).

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

The score-and-value product is :func:`attention`. On CUDA, where autograd
does not record, it is ``F.scaled_dot_product_attention`` restricted to
the flash, cuDNN and memory-efficient backends (``sdpa_kernel``): a shape
none of them takes raises rather than falling to the math backend, which
would write every score to memory. On the CPU, and wherever autograd
records, it is the plain product: ``softmax(q k^T / sqrt(d)) v`` with the
softmax in float32. Each call counts under its kind (the attention's
``kind``): ``attention.frequency_self``, ``attention.cross``,
``attention.pitch_self`` and ``attention.time_self``; a call on the plain
path also counts in ``attention.plain``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import cuda_build
from .add_layer_norm import add_layer_norm, add_layer_norm_plain
from .layers import _compute_dtype, linear, records, torch_default_

__all__ = ['attention', 'MultiHeadAttention', 'FeedForward', 'EncoderLayer',
           'DecoderLayerZero', 'DecoderLayer', 'KINDS']

# The kinds of attention hFT-Transformer runs, each a counter of attention
KINDS = ('frequency_self', 'cross', 'pitch_self', 'time_self')

# Sequences a fused launch: the flash and memory-efficient kernels put the
# batch on a grid dimension that holds at most 65,535 blocks
MAX_SEQUENCES = 65535


def _fused(q, k, v):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                SDPBackend.EFFICIENT_ATTENTION]
    with sdpa_kernel(backends):
        return F.scaled_dot_product_attention(q, k, v)


def _plain(q, k, v):
    scores = torch.matmul(q, k.transpose(-1, -2)) / q.shape[-1] ** 0.5

    return torch.matmul(torch.softmax(scores.float(), dim=-1).to(v.dtype), v)


def attention(q, k, v, kind):
    """(N, H, L, D) queries over (N, H, S, D) keys and values -> (N, H, L,
    D): ``softmax(q k^T / sqrt(D)) v`` a sequence and head (the module
    docstring: the fused route on CUDA, the plain one on the CPU and under
    autograd). ``kind`` is one of :data:`KINDS`, the counter the call
    adds to."""

    if kind not in KINDS:
        raise ValueError(f'kind must be one of {KINDS}, got {kind!r}')
    if not q.is_cuda or records(q, k, v):
        cuda_build.count(attention, kind, 'plain')
        return _plain(q, k, v)

    cuda_build.count(attention, kind)
    if q.stride(0) == 0:
        q = q.contiguous()
    if q.shape[0] <= MAX_SEQUENCES:
        return _fused(q, k, v)

    return torch.cat([_fused(*(x[start:start + MAX_SEQUENCES]
                               for x in (q, k, v)))
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
