"""Onsets & Frames transcription models (V1/V2).

Counterparts of ``amt_tools_tpu/models/onsetsframes.py``: ``AcousticModel``
(``:47``), ``LanguageModel`` (``:170``), ``OnlineLanguageModel`` (``:213``),
``OnsetsFrames`` (``:565``), ``OnsetsFrames2`` (``:757``, with its velocity
head, ``estimate_velocity``) and ``OnsetsFramesOnline`` (``:922``), in eval
mode and in train mode (batch-statistics BatchNorm, dropout from an explicit
generator, detached heads, BCE and masked MSE losses in ``post_proc``,
``remat`` of the acoustic stacks). Submodule and parameter names
follow the Flax tree (``pitch_am.Conv_0``, ``onset_lm.FastBiLSTM_0``,
``adjoin_out.Dense_0``, ...), so ``weights.from_flax`` maps one onto the
other by name.

With ``quant_acoustic`` the acoustic stacks' ``Conv_1``, ``Conv_2`` and
``Dense_0`` are int8 layers (``ops.qconv``; ``Conv_0`` stays float, JAX
``:92-98``), and with ``quant_lm`` the language models' input projections
are; the names and the random initialization stay the float model's.

``lengths`` (B,) valid frame counts (bucketed evaluation, JAX ``:129-155``,
``:191-210``, ``:645-710``) zero the padded frames of the features and of
every conv block's output, so a conv at the valid/padded boundary sees
exactly the SAME padding of an unpadded run, and mask the language
models' recurrences.

The acoustic stacks index their tensors as (B, C, T, F); the JAX package
runs NHWC (B, T, F, C). Before the dense projection the port permutes back
to (B, T, F/4, C), so the flatten is feature-major (index f * C + c)
exactly as in the JAX package (``onsetsframes.py:157-158``). An eval
forward on CUDA that autograd does not record, with float convs, holds the
stack channels-last in memory (``ops.layers.stack_layout``), so cuDNN's
bf16 kernels need no NCHW<->NHWC conversions and that permute is a view;
every other forward keeps the layout its features arrive in.

The opt-in fused layouts (JAX ``:246-342``, ``:540-549``, ``:577-700``):
``fused_heads`` runs every acoustic head as one ``GroupedAcousticModel``
(``grouped_am``: conv1 dense to all heads' channels, convs 2-3 grouped by
head, per-channel BatchNorm, the per-head projections one batched
contraction), and ``fused_lms`` runs O&F2's independent language models
(onset, offset and, with ``estimate_velocity``, velocity) as one
``ops.lstm.GroupedBiLSTM`` (``group_lm``): one grouped launch of kernel B
in eval, E and F in training, where the per-head layout launches each
direction alone. Both are layout changes of the same math;
``fuse_acoustic_variables``, ``fuse_lm_variables`` and their inverses
convert a ``state_dict`` between the layouts (JAX ``:345-508``, which acts
on Flax variables: ``weights.from_flax`` of JAX's fused tree equals the
port's converter applied to ``from_flax`` of the per-head tree).
"""

import warnings

import torch
import torch.nn as nn

from .. import profiling, tools
from ..ops import decode
from ..ops.layers import (BatchNorm, checkpoint, conv3x3, conv_block,
                          dropout, head_linear, lecun_normal_, linear,
                          stack_layout)
from ..ops.lstm import FastBiLSTM, FastLSTM, GroupedBiLSTM, lengths_to_mask
from ..ops.qconv import Int8Conv, Int8Dense
from .common import LogisticBank, RegressionBank, TranscriptionModel

__all__ = ['AcousticModel', 'GroupedAcousticModel', 'LanguageModel',
           'OnlineLanguageModel', 'OnsetsFrames', 'OnsetsFrames2',
           'OnsetsFramesOnline', 'fuse_acoustic_variables',
           'unfuse_acoustic_variables', 'fuse_lm_variables',
           'unfuse_lm_variables']


class AcousticModel(nn.Module):
    """Kelz-style conv stack: (B, T, F, C) features -> (B, T, dim_out).

    Three 3x3 conv + BatchNorm + ReLU blocks, two 1x2 max-pools over
    frequency (F -> F/4), then a dense projection. Each block is
    ``ops.layers.conv_block``: in eval on CUDA, with autograd not recording,
    a float conv's bias, the BatchNorm, the ReLU and the pool run as one
    hand-written kernel (``ops.conv_epilogue``) after a bias-free conv, bit
    for bit the eager ops, which run everywhere else; such a forward runs
    the whole stack channels-last (``ops.layers.stack_layout``). In train
    mode with ``dropout`` on, dropouts of 0.25 follow blocks 2 and 3 and
    0.5 the dense, drawn from the forward's ``generator``. ``quant``
    (serving only: ``False``, ``True`` or ``'static'``) makes ``Conv_1``,
    ``Conv_2`` and ``Dense_0`` int8 layers; ``Conv_0`` stays float (JAX
    ``:92-98``).
    ``remat`` recomputes in the backward pass what a training forward would
    keep: ``True`` the whole stack (JAX ``nn.remat(AcousticModel)``,
    ``:517-537``), ``'blocks'`` each conv block (``block_remat``,
    ``:141-150``), through ``ops.layers.checkpoint``, which redraws the
    same dropout masks and updates the BatchNorm statistics once.
    """

    def __init__(self, dim_in, dim_out, in_channels=1, model_complexity=2,
                 dtype=None, generator=None, dropout=True, quant=False,
                 remat=False):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.remat = remat
        nf1 = 16 * model_complexity
        nf3 = 32 * model_complexity
        static = quant == 'static'

        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def conv(in_channels, out_channels):
            if quant:
                return Int8Conv(in_channels, out_channels, dtype=dtype,
                                static_scale=static, generator=generator)
            return conv3x3(in_channels, out_channels, generator)

        self.Conv_0 = conv3x3(in_channels, nf1, generator)
        self.BatchNorm_0 = BatchNorm(nf1)
        self.Conv_1 = conv(nf1, nf1)
        self.BatchNorm_1 = BatchNorm(nf1)
        self.Conv_2 = conv(nf1, nf3)
        self.BatchNorm_2 = BatchNorm(nf3)

        features = nf3 * (dim_in // 2 // 2)
        if quant:
            self.Dense_0 = Int8Dense(features, dim_out, dtype=dtype,
                                     static_scale=static, generator=generator)
        else:
            self.Dense_0 = nn.Linear(features, dim_out)
            lecun_normal_(self.Dense_0.weight, features, generator)
            nn.init.zeros_(self.Dense_0.bias)

    def _dropout(self, x, rate, generator):
        if self.training and self.dropout:
            return dropout(x, rate, generator)
        return x

    def _block(self, x, conv, norm, pool, generator):
        x = conv_block(x, conv, norm, pool, self.dtype)
        return self._dropout(x, 0.25, generator) if pool else x

    def _remat(self, mode):
        return (self.remat == mode and self.training and
                torch.is_grad_enabled())

    def forward(self, feats, generator=None, lengths=None):
        with profiling.span('amt.acoustic'):
            if self.remat is True and self._remat(True):
                return checkpoint(
                    lambda x: self._forward(x, generator, lengths), feats,
                    module=self, generator=generator)

            return self._forward(feats, generator, lengths)

    def _forward(self, feats, generator, lengths):
        blocks = ((self.Conv_0, self.BatchNorm_0, False),
                  (self.Conv_1, self.BatchNorm_1, True),
                  (self.Conv_2, self.BatchNorm_2, True))
        # (B, T, F, C) -> (B, C, T, F)
        x = stack_layout(feats.permute(0, 3, 1, 2), self, blocks, self.dtype)

        mask = None
        if lengths is not None:
            # Padded frames zeroed on the input and after every block
            mask = lengths_to_mask(torch.as_tensor(lengths, device=x.device),
                                   x.shape[2])[:, None, :, None].to(x.dtype)
            x = x * mask

        def block(x, conv, norm, pool):
            x = self._block(x, conv, norm, pool, generator)
            return x if mask is None else x * mask.to(x.dtype)

        for conv, norm, pool in blocks:
            if self._remat('blocks'):
                x = checkpoint(
                    lambda x, conv=conv, norm=norm, pool=pool: block(
                        x, conv, norm, pool), x, module=norm,
                    generator=generator)
            else:
                x = block(x, conv, norm, pool)

        # (B, C, T, F/4) -> (B, T, F/4, C) -> (B, T, F/4 * C), feature-major
        # (a view of a channels-last x)
        x = x.permute(0, 2, 3, 1)
        x = x.reshape(x.shape[:2] + (-1,))

        return self._dropout(linear(x, self.Dense_0, self.dtype), 0.5,
                             generator)


class GroupedAcousticModel(nn.Module):
    """Every acoustic head of an O&F model in one conv stack: (B, T, F, C)
    features -> (B, T, heads, dim_out), one embedding a head in the
    caller's head order (JAX ``:246-342``).

    The per-head :class:`AcousticModel` stacks all read the same input, so
    conv1 is one dense conv to ``heads * nf1`` channels; convs 2-3 are
    grouped by head (``nn.Conv2d(groups=heads)``, block-diagonal over
    channels, run by cuDNN as the per-head convs are: Flax computes them
    outside any Pallas kernel), BatchNorm is per channel, and the per-head
    projections ``head_kernels`` (heads, K, dim_out) and ``head_bias``
    (heads, dim_out) are one batched contraction. So the stack computes the
    per-head stacks side by side: a layout change, not an approximation.
    Channels are head-blocked (head h owns channels [h nf, (h + 1) nf)),
    and each head's flatten is frequency-major, channel-minor, as JAX's
    (``:313-319``) and the per-head stack's. Masks, dropout from the
    forward's ``generator``, the max-pools, the blocks
    (``ops.layers.conv_block``, with its eval epilogue kernel on CUDA) and
    their layout (``ops.layers.stack_layout``) are the per-head stack's;
    ``remat=True`` recomputes the whole stack in the backward pass
    (``ops.layers.checkpoint``); the per-block ``'blocks'`` has no fused
    counterpart (JAX ``_grouped_model_cls``)."""

    def __init__(self, dim_in, dim_out, heads=3, in_channels=1,
                 model_complexity=2, dtype=None, generator=None, dropout=True,
                 remat=False):
        super().__init__()
        if remat == 'blocks':
            raise ValueError("remat='blocks' is only supported with per-head "
                             "acoustic stacks (fused_heads=False)")
        self.heads = heads
        self.dtype = dtype
        self.dropout = dropout
        self.remat = remat
        self.nf3 = 32 * model_complexity
        nf1 = 16 * model_complexity

        if generator is None:
            generator = torch.Generator().manual_seed(0)

        self.Conv_0 = conv3x3(in_channels, heads * nf1, generator)
        self.BatchNorm_0 = BatchNorm(heads * nf1)
        self.Conv_1 = conv3x3(heads * nf1, heads * nf1, generator, heads)
        self.BatchNorm_1 = BatchNorm(heads * nf1)
        self.Conv_2 = conv3x3(heads * nf1, heads * self.nf3, generator, heads)
        self.BatchNorm_2 = BatchNorm(heads * self.nf3)

        features = self.nf3 * (dim_in // 2 // 2)
        self.head_kernels = nn.Parameter(torch.empty(heads, features,
                                                     dim_out))
        lecun_normal_(self.head_kernels, features, generator)
        self.head_bias = nn.Parameter(torch.zeros(heads, dim_out))

    def _dropout(self, x, rate, generator):
        if self.training and self.dropout:
            return dropout(x, rate, generator)
        return x

    def forward(self, feats, generator=None, lengths=None):
        with profiling.span('amt.acoustic'):
            if (self.remat is True and self.training and
                    torch.is_grad_enabled()):
                return checkpoint(
                    lambda x: self._forward(x, generator, lengths), feats,
                    module=self, generator=generator)

            return self._forward(feats, generator, lengths)

    def _forward(self, feats, generator, lengths):
        blocks = ((self.Conv_0, self.BatchNorm_0, False),
                  (self.Conv_1, self.BatchNorm_1, True),
                  (self.Conv_2, self.BatchNorm_2, True))
        # (B, T, F, C) -> (B, C, T, F)
        x = stack_layout(feats.permute(0, 3, 1, 2), self, blocks, self.dtype)

        mask = None
        if lengths is not None:
            mask = lengths_to_mask(torch.as_tensor(lengths, device=x.device),
                                   x.shape[2])[:, None, :, None].to(x.dtype)
            x = x * mask

        for conv, norm, pool in blocks:
            x = conv_block(x, conv, norm, pool, self.dtype)
            if pool:
                x = self._dropout(x, 0.25, generator)
            if mask is not None:
                x = x * mask.to(x.dtype)

        # (B, heads * nf3, T, F/4) -> (B, T, heads, F/4 * nf3): each head's
        # channels, flattened frequency-major and channel-minor (one copy in
        # either layout: channels-last holds F/4 outside the heads)
        batch, _, frames, freqs = x.shape
        x = x.reshape(batch, self.heads, self.nf3, frames, freqs)
        x = x.permute(0, 3, 1, 4, 2).reshape(batch, frames, self.heads,
                                             freqs * self.nf3)

        # The per-head projections, one batched contraction
        x = head_linear(x, self, self.dtype)

        return self._dropout(x, 0.5, generator)


class LanguageModel(nn.Module):
    """LSTM language model: (B, T, dim_in) -> (B, T, dim_out).

    Bidirectional by default, with ``dim_out // 2`` hidden units per
    direction; the recurrence runs in the Hopper LSTM kernels on CUDA
    (kernel B, or E and F when autograd records; zero-padded to a multiple
    of 16 for a width they do not take). ``quant`` makes the input
    projections int8.
    """

    def __init__(self, dim_in, dim_out, bidirectional=True, dtype=None,
                 generator=None, quant=False):
        super().__init__()
        self.bidirectional = bidirectional

        if bidirectional:
            self.FastBiLSTM_0 = FastBiLSTM(dim_in, dim_out // 2, dtype=dtype,
                                           generator=generator, quant=quant)
        else:
            self.FastLSTM_0 = FastLSTM(dim_in, dim_out, dtype=dtype,
                                       generator=generator, quant=quant)

    def forward(self, feats, lengths=None):
        if self.bidirectional:
            return self.FastBiLSTM_0(feats, lengths)

        return self.FastLSTM_0(feats, lengths)


class OnlineLanguageModel(nn.Module):
    """Unidirectional LSTM with an explicit streaming carry: (B, T, dim_in)
    -> (B, T, dim_out).

    Called without a carry it is the whole-sequence recurrence (kernel B in
    eval, E and F when autograd records) and returns ``(out, None)``; with
    ``carry=(c, h)`` it runs from that carry (kernel B, or the carried E
    and F when autograd records: the gradient reaches the carry) and
    returns ``(out, new_carry)``, float32 (JAX ``:213-243``, whose layer
    computes in the input's dtype).
    """

    def __init__(self, dim_in, dim_out, generator=None):
        super().__init__()
        self.dim_out = dim_out
        self.FastLSTM_0 = FastLSTM(dim_in, dim_out, generator=generator)

    def init_carry(self, batch_size, device=None):
        """Zero (cell, hidden) carry for a new stream."""

        zeros = torch.zeros((batch_size, self.dim_out), device=device)

        return zeros, zeros.clone()

    def forward(self, feats, carry=None):
        if carry is None:
            return self.FastLSTM_0(feats), None

        new_carry, out = self.FastLSTM_0(feats, initial_carry=carry,
                                         return_carry=True)

        return out, new_carry


class OnsetsFrames(TranscriptionModel):
    """Onsets & Frames (V1), arXiv:1710.11153.

    Heads: onset = AM -> LM -> logistic; pitch = AM -> logistic; refined
    pitch = LM -> logistic over concat(onsets, pitch). ``generator`` seeds
    the random initialization (a fresh generator seeded 0 when omitted).
    ``detach_heads`` stops the refinement's gradient into the onset (and
    offset) heads. ``remat`` (``False``, ``True`` or ``'blocks'``)
    recomputes the acoustic stacks in the backward pass. Losses: pitch +
    onset BCE.

    ``fused_heads`` runs every acoustic head as one
    :class:`GroupedAcousticModel` (``grouped_am``); ``fused_lms`` (O&F2
    only: V1 has one independent language model) runs the independent
    language models as one ``GroupedBiLSTM`` (``group_lm``, streams in
    ``_fused_lm_streams``' order). Neither takes the int8 layers, and the
    fused stack takes no ``remat='blocks'`` (JAX's refusals).
    """

    head_names = ('pitch', 'onset')

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=2,
                 dtype=None, generator=None, dropout=True, detach_heads=False,
                 quant_acoustic=False, quant_lm=False, remat=False,
                 fused_heads=False, fused_lms=False):
        super().__init__(dim_in, profile, in_channels=in_channels,
                         model_complexity=model_complexity, dtype=dtype,
                         dropout=dropout, quant_acoustic=quant_acoustic,
                         quant_lm=quant_lm, remat=remat)
        self.detach_heads = detach_heads
        self.fused_heads = fused_heads
        self.fused_lms = fused_lms
        if model_complexity < 2:
            raise ValueError('OnsetsFrames requires model_complexity >= 2 '
                             '(the language-model width is 256 * (complexity - 1)).')

        if generator is None:
            generator = torch.Generator().manual_seed(0)

        self._setup_acoustic(generator)

        if fused_lms:
            if self._fused_lm_streams is None:
                raise ValueError('fused_lms requires a model with multiple '
                                 'independent language models '
                                 '(OnsetsFrames2); V1 has only the onset LM.')
            if quant_lm:
                raise ValueError('quant_lm is only supported with per-head '
                                 'language models (fused_lms=False).')
            self.group_lm = GroupedBiLSTM(self.dim_am, self.dim_lm // 2,
                                          len(self._fused_lm_streams),
                                          dtype=dtype, generator=generator)
        else:
            self.onset_lm = LanguageModel(self.dim_am, self.dim_lm,
                                          dtype=dtype, generator=generator,
                                          quant=quant_lm)
        self.onset_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                      generator=generator)
        self.pitch_out = LogisticBank(self.dim_am, self.dim_out, dtype=dtype,
                                      generator=generator)
        self.adjoin_lm = LanguageModel(self.dim_aj, self.dim_lm, dtype=dtype,
                                       generator=generator, quant=quant_lm)
        self.adjoin_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                       generator=generator)

    def _setup_acoustic(self, generator):
        """The acoustic stacks: one grouped module or one a head."""

        if self.fused_heads:
            if self.quant_acoustic:
                raise ValueError('quant_acoustic is only supported with '
                                 'per-head acoustic stacks (fused_heads=False)')
            self.grouped_am = GroupedAcousticModel(
                self.dim_in, self.dim_am, len(self.head_names),
                self.in_channels, self.model_complexity, dtype=self.dtype,
                generator=generator, dropout=self.dropout, remat=self.remat)
            return

        for name in self.head_names:
            setattr(self, f'{name}_am',
                    AcousticModel(self.dim_in, self.dim_am, self.in_channels,
                                  self.model_complexity, dtype=self.dtype,
                                  generator=generator, dropout=self.dropout,
                                  quant=self.quant_acoustic, remat=self.remat))

    @property
    def _fused_lm_streams(self):
        """Head order of the grouped-LM layout; None: not fusable (V1's only
        independent language model is the onset head's)."""

        return None

    @property
    def dim_am(self):
        return 256 * self.model_complexity

    @property
    def dim_lm(self):
        return 256 * (self.model_complexity - 1)

    @property
    def dim_out(self):
        return self.profile.get_range_len()

    @property
    def dim_aj(self):
        """Input width of the refinement stage (onsets + pitch)."""

        return 2 * self.dim_out

    def pre_proc(self, batch):
        """(B, C, F, T) features -> (B, T, F, C)."""

        batch = dict(batch)
        batch[tools.KEY_FEATS] = batch[tools.KEY_FEATS].permute(0, 3, 2, 1)

        return batch

    def _embeddings(self, feats, generator, lengths):
        """Per-head acoustic embeddings keyed by head name."""

        if self.fused_heads:
            emb = self.grouped_am(feats, generator, lengths)
            return {name: emb[..., i, :]
                    for i, name in enumerate(self.head_names)}

        return {name: getattr(self, f'{name}_am')(feats, generator, lengths)
                for name in self.head_names}

    def _lm_outputs(self, emb, lengths):
        """Per-head language-model features: one grouped BiLSTM or one
        module a head."""

        if self.fused_lms:
            streams = self._fused_lm_streams
            out = self.group_lm(torch.stack([emb[name] for name in streams]),
                                lengths)
            return {name: out[i] for i, name in enumerate(streams)}

        return {name: getattr(self, f'{name}_lm')(emb[name], lengths)
                for name in self._fused_lm_streams or ('onset',)}

    def _detach(self, x):
        return x.detach() if self.detach_heads else x

    def forward(self, feats, generator=None, lengths=None):
        """(B, T, F, C) features -> raw logits; in train mode dropout draws
        from ``generator``. ``lengths`` (B,) masks padded frames, in
        evaluation and in training (the masked E and F)."""

        output = {}

        emb = self._embeddings(feats, generator, lengths)
        multi_pitch = self.pitch_out(emb['pitch'])

        onsets = self.onset_out(self._lm_outputs(emb, lengths)['onset'])
        output[tools.KEY_ONSETS] = onsets

        joint = torch.cat((self._detach(onsets), multi_pitch), dim=-1)
        output[tools.KEY_MULTIPITCH] = self.adjoin_out(
            self.adjoin_lm(joint, lengths))

        return output

    def post_proc(self, batch):
        """Losses, where the batch has a multi-pitch reference (onset
        targets derived from it when absent), and thresholded onset and
        multi-pitch activations, (B, O, T)."""

        output = dict(batch[tools.KEY_OUTPUT])
        onsets_est = output[tools.KEY_ONSETS]
        multi_pitch_est = output[tools.KEY_MULTIPITCH]

        if tools.KEY_MULTIPITCH in batch:
            multi_pitch_ref = batch[tools.KEY_MULTIPITCH]
            onsets_ref = batch.get(tools.KEY_ONSETS)
            if onsets_ref is None:
                onsets_ref = decode.multi_pitch_to_onsets(multi_pitch_ref)

            loss = {tools.KEY_LOSS_PITCH: LogisticBank.get_loss(
                        multi_pitch_est, multi_pitch_ref),
                    tools.KEY_LOSS_ONSETS: LogisticBank.get_loss(
                        onsets_est, onsets_ref)}
            loss[tools.KEY_LOSS_TOTAL] = (loss[tools.KEY_LOSS_PITCH] +
                                          loss[tools.KEY_LOSS_ONSETS])
            output[tools.KEY_LOSS] = loss

        output[tools.KEY_ONSETS] = LogisticBank.finalize_output(onsets_est,
                                                                0.5)
        output[tools.KEY_MULTIPITCH] = LogisticBank.finalize_output(
            multi_pitch_est, 0.5)

        return output


class OnsetsFrames2(OnsetsFrames):
    """Onsets & Frames (V2), arXiv:1810.12247.

    Adds an offset head; the refinement stage consumes onsets, offsets and
    the initial pitch estimate. At complexity 3: three 48/48/96-channel
    acoustic stacks with a 5472 -> 768 dense (229 mels), three BiLSTMs of
    256 units per direction, 88-key logistic heads. The heads are detached
    by default; losses: pitch + onset + offset BCE.

    ``estimate_velocity`` adds a fourth acoustic stack, ``velocity_am``, a
    BiLSTM ``velocity_lm`` (kernels E and F in training, B in eval) and a
    ``RegressionBank`` ``velocity_out`` (JAX ``:770-917``): a masked MSE on
    every cell with a velocity target (``velocity > 0``) joins the total
    loss, a batch without velocities warns, and the finalized (B, O, T)
    velocity map in [0, 1] is output. Under ``fused_heads`` the velocity
    stack is the grouped stack's fourth head; under ``fused_lms`` its
    language model is ``group_lm``'s third stream.
    """

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=3,
                 dtype=None, generator=None, dropout=True, detach_heads=True,
                 quant_acoustic=False, quant_lm=False, remat=False,
                 estimate_velocity=False, fused_heads=False, fused_lms=False):
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        # The head names depend on it, and the base class builds the heads
        self.estimate_velocity = estimate_velocity
        super().__init__(dim_in, profile, in_channels=in_channels,
                         model_complexity=model_complexity, dtype=dtype,
                         generator=generator, dropout=dropout,
                         detach_heads=detach_heads,
                         quant_acoustic=quant_acoustic, quant_lm=quant_lm,
                         remat=remat, fused_heads=fused_heads,
                         fused_lms=fused_lms)

        if not fused_lms:
            self.offset_lm = LanguageModel(self.dim_am, self.dim_lm,
                                           dtype=dtype, generator=generator,
                                           quant=quant_lm)
        self.offset_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                       generator=generator)
        if estimate_velocity:
            if not fused_lms:
                self.velocity_lm = LanguageModel(self.dim_am, self.dim_lm,
                                                 dtype=dtype,
                                                 generator=generator,
                                                 quant=quant_lm)
            self.velocity_out = RegressionBank(self.dim_lm, self.dim_out,
                                               dtype=dtype,
                                               generator=generator)

    @property
    def head_names(self):
        if self.estimate_velocity:
            return ('pitch', 'onset', 'offset', 'velocity')

        return ('pitch', 'onset', 'offset')

    @property
    def _fused_lm_streams(self):
        if self.estimate_velocity:
            return ('onset', 'offset', 'velocity')

        return ('onset', 'offset')

    @property
    def dim_aj(self):
        """Refinement consumes onsets + offsets + pitch."""

        return 3 * self.dim_out

    def forward(self, feats, generator=None, lengths=None):
        output = {}

        emb = self._embeddings(feats, generator, lengths)
        multi_pitch = self.pitch_out(emb['pitch'])

        lm = self._lm_outputs(emb, lengths)
        onsets = self.onset_out(lm['onset'])
        output[tools.KEY_ONSETS] = onsets

        offsets = self.offset_out(lm['offset'])
        output[tools.KEY_OFFSETS] = offsets

        if self.estimate_velocity:
            output[tools.KEY_VELOCITY] = self.velocity_out(lm['velocity'])

        joint = torch.cat((self._detach(onsets), self._detach(offsets),
                           multi_pitch), dim=-1)
        output[tools.KEY_MULTIPITCH] = self.adjoin_out(
            self.adjoin_lm(joint, lengths))

        return output

    def post_proc(self, batch):
        output = super().post_proc(batch)
        offsets_est = output[tools.KEY_OFFSETS]

        if tools.KEY_LOSS in output:
            offsets_ref = batch.get(tools.KEY_OFFSETS)
            if offsets_ref is None:
                offsets_ref = decode.multi_pitch_to_offsets(
                    batch[tools.KEY_MULTIPITCH])

            loss = output[tools.KEY_LOSS]
            loss[tools.KEY_LOSS_OFFSETS] = LogisticBank.get_loss(offsets_est,
                                                                 offsets_ref)
            loss[tools.KEY_LOSS_TOTAL] = (loss[tools.KEY_LOSS_TOTAL] +
                                          loss[tools.KEY_LOSS_OFFSETS])

        output[tools.KEY_OFFSETS] = LogisticBank.finalize_output(offsets_est)

        if self.estimate_velocity and tools.KEY_VELOCITY in output:
            velocity_est = output[tools.KEY_VELOCITY]

            if tools.KEY_LOSS in output and tools.KEY_VELOCITY not in batch:
                # Loud, not silent: a dataset without velocities would
                # leave the head untrained with no indication
                warnings.warn('estimate_velocity=True but the batch carries '
                              'no velocity ground truth; the velocity head '
                              'receives no loss. Stale dataset caches need '
                              'reset_data=True.', category=RuntimeWarning)

            if tools.KEY_LOSS in output and tools.KEY_VELOCITY in batch:
                # MSE over every cell carrying a velocity target: the full
                # note spans
                velocity_ref = batch[tools.KEY_VELOCITY]
                loss = output[tools.KEY_LOSS]
                loss[tools.KEY_LOSS_VELOCITY] = self.velocity_out.get_loss(
                    velocity_est, velocity_ref, velocity_ref > 0)
                loss[tools.KEY_LOSS_TOTAL] = (loss[tools.KEY_LOSS_TOTAL] +
                                              loss[tools.KEY_LOSS_VELOCITY])

            output[tools.KEY_VELOCITY] = self.velocity_out.finalize_output(
                velocity_est)

        return output


class OnsetsFramesOnline(OnsetsFrames):
    """Streaming Onsets & Frames: unidirectional language models with
    explicit carries (JAX ``:922-990``).

    The V1 heads with ``OnlineLanguageModel`` in place of the BiLSTMs (the
    acoustic stacks take ``lengths``, the recurrences do not, as in JAX).
    ``forward(feats, carries=...)`` returns ``(output, new_carries)``: the
    onset and adjoin LMs run from their carries (kernel B; the carried E
    and F when autograd records, so chunks train through the chain), and
    frames fed one at a time keep their full recurrent context
    (``inference.run_online_stateful``). Without carries it is the
    whole-sequence unidirectional model: kernel B in eval, E and F in
    training.
    """

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=2,
                 dtype=None, generator=None, dropout=True, detach_heads=False,
                 quant_acoustic=False, remat=False, fused_heads=False,
                 fused_lms=False):
        if model_complexity < 2:
            raise ValueError('OnsetsFramesOnline requires model_complexity '
                             '>= 2.')
        if fused_lms:
            raise ValueError('fused_lms is not supported by the online model '
                             '(its LMs thread streaming carries and V1-style '
                             'heads leave nothing independent to group).')
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        TranscriptionModel.__init__(
            self, dim_in, profile, in_channels=in_channels,
            model_complexity=model_complexity, dtype=dtype, dropout=dropout,
            quant_acoustic=quant_acoustic, remat=remat)
        self.detach_heads = detach_heads
        self.fused_heads = fused_heads
        self.fused_lms = False

        self._setup_acoustic(generator)

        self.onset_lm = OnlineLanguageModel(self.dim_am, self.dim_lm,
                                            generator=generator)
        self.onset_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                      generator=generator)
        self.pitch_out = LogisticBank(self.dim_am, self.dim_out, dtype=dtype,
                                      generator=generator)
        self.adjoin_lm = OnlineLanguageModel(self.dim_aj, self.dim_lm,
                                             generator=generator)
        self.adjoin_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                       generator=generator)

    def init_carries(self, batch_size, device=None):
        """Zero float32 streaming state for both recurrent stages."""

        return {'onset': self.onset_lm.init_carry(batch_size, device),
                'adjoin': self.adjoin_lm.init_carry(batch_size, device)}

    def forward(self, feats, generator=None, carries=None, lengths=None):
        output = {}

        emb = self._embeddings(feats, generator, lengths)
        multi_pitch = self.pitch_out(emb['pitch'])

        onset_feats, onset_carry = self.onset_lm(
            emb['onset'], None if carries is None else carries['onset'])
        onsets = self.onset_out(onset_feats)
        output[tools.KEY_ONSETS] = onsets

        joint = torch.cat((self._detach(onsets), multi_pitch), dim=-1)
        adjoin_feats, adjoin_carry = self.adjoin_lm(
            joint, None if carries is None else carries['adjoin'])
        output[tools.KEY_MULTIPITCH] = self.adjoin_out(adjoin_feats)

        if carries is None:
            return output

        return output, {'onset': onset_carry, 'adjoin': adjoin_carry}


def _pop_subtree(state, prefix):
    """Remove the entries of ``state`` under ``prefix`` and return them,
    keyed without it."""

    return {key[len(prefix):]: state.pop(key) for key in list(state)
            if key.startswith(prefix)}


def fuse_acoustic_variables(state, head_names, grouped_name='grouped_am'):
    """A per-head ``state_dict`` -> the fused :class:`GroupedAcousticModel`
    layout (JAX ``:345-385``).

    The ``<name>_am`` stacks present, in ``head_names`` order (the model's
    ``head_names``), become one ``grouped_name`` stack: conv weights, conv
    biases and BatchNorm vectors concatenated on the channel axis (a conv
    weight's OIHW axis 0, where Flax's HWIO kernel concatenates on its last
    axis), each ``Dense_0`` stacked on a new leading head axis as
    ``head_kernels`` (heads, K, D), transposed from ``nn.Linear``'s (D, K),
    and ``head_bias`` (heads, D). Returns a new dict; the input is
    unmodified. Inverse: :func:`unfuse_acoustic_variables`."""

    state = dict(state)
    heads = [_pop_subtree(state, f'{name}_am.') for name in head_names
             if any(key.startswith(f'{name}_am.') for key in state)]
    if not heads:
        return state

    for key in heads[0]:
        layer, leaf = key.rsplit('.', 1)
        values = [head[key] for head in heads]
        if not layer.startswith('Dense'):
            state[f'{grouped_name}.{key}'] = torch.cat(values)
        elif leaf == 'weight':
            state[f'{grouped_name}.head_kernels'] = torch.stack(
                [value.t() for value in values])
        elif leaf == 'bias':
            state[f'{grouped_name}.head_bias'] = torch.stack(values)
        else:
            raise ValueError(f'{key} has no place in the fused layout (the '
                             f'int8 layers are per-head only)')

    return state


def unfuse_acoustic_variables(state, head_names, grouped_name='grouped_am'):
    """Split a fused ``grouped_name`` stack of a ``state_dict`` back into
    per-head ``<name>_am`` stacks (JAX ``:388-423``)."""

    state = dict(state)
    fused = _pop_subtree(state, f'{grouped_name}.')
    num_heads = len(head_names)

    for i, name in enumerate(head_names):
        for key, leaf in fused.items():
            if key == 'head_kernels':
                state[f'{name}_am.Dense_0.weight'] = leaf[i].t().contiguous()
            elif key == 'head_bias':
                state[f'{name}_am.Dense_0.bias'] = leaf[i].clone()
            else:
                width = leaf.shape[0] // num_heads
                state[f'{name}_am.{key}'] = leaf[i * width:
                                                 (i + 1) * width].clone()

    return state


def fuse_lm_variables(state, streams=('onset', 'offset'),
                      grouped_name='group_lm'):
    """Per-head ``<name>_lm`` language models of a ``state_dict`` -> the
    grouped ``GroupedBiLSTM`` layout (JAX ``:426-478``): each stream's
    ``FastBiLSTM_0`` parameters stacked on a new leading stream axis, the
    input projections as (S, E, 4H) kernels (``nn.Linear``'s (4H, E)
    transposed) and (S, 4H) biases, the recurrent kernels as (S, H, 4H).
    Pass ``model._fused_lm_streams`` for the stream order. Returns a new
    dict; inverse: :func:`unfuse_lm_variables`."""

    state = dict(state)

    def has(name):
        return any(key.startswith(f'{name}_lm.') for key in state)

    present = [name for name in streams if has(name)]
    if not present:
        return state

    if len(present) != len(streams):
        missing = sorted(set(streams) - set(present))
        raise ValueError(f'variables hold LM subtrees for {present} but '
                         f'not {missing}; pass the model\'s stream order '
                         f'(model._fused_lm_streams) as `streams`')

    # A fusable LM left out of `streams` would keep the per-head layout for
    # that stream, which the fused model does not read
    leftover = [name for name in ('onset', 'offset', 'velocity')
                if name not in streams and has(name)]
    if leftover:
        raise ValueError(f'variables also hold fusable LM subtrees '
                         f'{leftover} not named in `streams`; pass the '
                         f'model\'s stream order (model._fused_lm_streams)')

    lms = [_pop_subtree(state, f'{name}_lm.') for name in streams]
    for direction in ('fwd', 'bwd'):
        proj = f'FastBiLSTM_0.input_proj_{direction}'
        state[f'{grouped_name}.input_proj_{direction}_kernel'] = torch.stack(
            [lm[f'{proj}.weight'].t() for lm in lms])
        state[f'{grouped_name}.input_proj_{direction}_bias'] = torch.stack(
            [lm[f'{proj}.bias'] for lm in lms])
        state[f'{grouped_name}.recurrent_kernel_{direction}'] = torch.stack(
            [lm[f'FastBiLSTM_0.recurrent_kernel_{direction}'] for lm in lms])

    return state


def unfuse_lm_variables(state, streams=('onset', 'offset'),
                        grouped_name='group_lm'):
    """Inverse of :func:`fuse_lm_variables`: grouped -> per-head layout
    (JAX ``:481-508``)."""

    state = dict(state)
    fused = _pop_subtree(state, f'{grouped_name}.')
    if not fused:
        return state

    stacked = fused['recurrent_kernel_fwd'].shape[0]
    if stacked != len(streams):
        raise ValueError(f'{grouped_name} holds {stacked} streams but '
                         f'`streams` names {len(streams)} '
                         f'({tuple(streams)}); pass the model\'s stream '
                         f'order (model._fused_lm_streams) so no trained '
                         f'LM is silently dropped')

    for i, name in enumerate(streams):
        lm = f'{name}_lm.FastBiLSTM_0'
        for direction in ('fwd', 'bwd'):
            proj = f'{lm}.input_proj_{direction}'
            state[f'{proj}.weight'] = (
                fused[f'input_proj_{direction}_kernel'][i].t().contiguous())
            state[f'{proj}.bias'] = fused[f'input_proj_{direction}_bias'][i].clone()
            state[f'{lm}.recurrent_kernel_{direction}'] = (
                fused[f'recurrent_kernel_{direction}'][i].clone())

    return state
