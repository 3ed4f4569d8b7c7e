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

The acoustic stacks run NCHW as (B, C, T, F); the JAX package runs NHWC
(B, T, F, C). Before the dense projection the port permutes back to
(B, T, F/4, C), so the flatten is feature-major (index f * C + c) exactly
as in the JAX package (``onsetsframes.py:157-158``).
"""

import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import tools
from ..ops import decode
from ..ops.layers import (BatchNorm, checkpoint, conv2d_same, conv3x3,
                          dropout, lecun_normal_, linear)
from ..ops.lstm import FastBiLSTM, FastLSTM, lengths_to_mask
from ..ops.qconv import Int8Conv, Int8Dense
from .common import LogisticBank, RegressionBank, TranscriptionModel

__all__ = ['AcousticModel', 'LanguageModel', 'OnlineLanguageModel',
           'OnsetsFrames', 'OnsetsFrames2', 'OnsetsFramesOnline']


class AcousticModel(nn.Module):
    """Kelz-style conv stack: (B, T, F, C) features -> (B, T, dim_out).

    Three 3x3 conv + BatchNorm + ReLU blocks, two 1x2 max-pools over
    frequency (F -> F/4), then a dense projection. In train mode with
    ``dropout`` on, dropouts of 0.25 follow blocks 2 and 3 and 0.5 the
    dense, drawn from the forward's ``generator``. ``quant`` (serving only:
    ``False``, ``True`` or ``'static'``) makes ``Conv_1``, ``Conv_2`` and
    ``Dense_0`` int8 layers; ``Conv_0`` stays float (JAX ``:92-98``).
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
        x = conv2d_same(x, conv, self.dtype)
        x = F.relu(norm(x, self.dtype))
        if pool:
            x = F.max_pool2d(x, (1, 2), stride=(1, 2))
            x = self._dropout(x, 0.25, generator)
        return x

    def _remat(self, mode):
        return (self.remat == mode and self.training and
                torch.is_grad_enabled())

    def forward(self, feats, generator=None, lengths=None):
        if self.remat is True and self._remat(True):
            return checkpoint(
                lambda x: self._forward(x, generator, lengths), feats,
                module=self, generator=generator)

        return self._forward(feats, generator, lengths)

    def _forward(self, feats, generator, lengths):
        # (B, T, F, C) -> (B, C, T, F)
        x = feats.permute(0, 3, 1, 2)

        mask = None
        if lengths is not None:
            # Padded frames zeroed on the input and after every block
            mask = lengths_to_mask(torch.as_tensor(lengths, device=x.device),
                                   x.shape[2])[:, None, :, None].to(x.dtype)
            x = x * mask

        def block(x, conv, norm, pool):
            x = self._block(x, conv, norm, pool, generator)
            return x if mask is None else x * mask.to(x.dtype)

        blocks = ((self.Conv_0, self.BatchNorm_0, False),
                  (self.Conv_1, self.BatchNorm_1, True),
                  (self.Conv_2, self.BatchNorm_2, True))
        for conv, norm, pool in blocks:
            if self._remat('blocks'):
                x = checkpoint(
                    lambda x, conv=conv, norm=norm, pool=pool: block(
                        x, conv, norm, pool), x, module=norm,
                    generator=generator)
            else:
                x = block(x, conv, norm, pool)

        # (B, C, T, F/4) -> (B, T, F/4, C) -> (B, T, F/4 * C), feature-major
        x = x.permute(0, 2, 3, 1)
        x = x.reshape(x.shape[:2] + (-1,))

        return self._dropout(linear(x, self.Dense_0, self.dtype), 0.5,
                             generator)


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
    ``carry=(c, h)`` it runs kernel B from that carry and returns ``(out,
    new_carry)``, float32 (JAX ``:213-243``, whose layer computes in the
    input's dtype).
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
    """

    head_names = ('pitch', 'onset')

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=2,
                 dtype=None, generator=None, dropout=True, detach_heads=False,
                 quant_acoustic=False, quant_lm=False, remat=False):
        super().__init__(dim_in, profile, in_channels=in_channels,
                         model_complexity=model_complexity, dtype=dtype,
                         dropout=dropout, quant_acoustic=quant_acoustic,
                         quant_lm=quant_lm, remat=remat)
        self.detach_heads = detach_heads
        if model_complexity < 2:
            raise ValueError('OnsetsFrames requires model_complexity >= 2 '
                             '(the language-model width is 256 * (complexity - 1)).')

        if generator is None:
            generator = torch.Generator().manual_seed(0)

        for name in self.head_names:
            self._add_acoustic(name, generator)

        self.onset_lm = LanguageModel(self.dim_am, self.dim_lm, dtype=dtype,
                                      generator=generator, quant=quant_lm)
        self.onset_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                      generator=generator)
        self.pitch_out = LogisticBank(self.dim_am, self.dim_out, dtype=dtype,
                                      generator=generator)
        self.adjoin_lm = LanguageModel(self.dim_aj, self.dim_lm, dtype=dtype,
                                       generator=generator, quant=quant_lm)
        self.adjoin_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                       generator=generator)

    def _add_acoustic(self, name, generator):
        setattr(self, f'{name}_am',
                AcousticModel(self.dim_in, self.dim_am, self.in_channels,
                              self.model_complexity, dtype=self.dtype,
                              generator=generator, dropout=self.dropout,
                              quant=self.quant_acoustic, remat=self.remat))

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
        return {name: getattr(self, f'{name}_am')(feats, generator, lengths)
                for name in self.head_names}

    def _detach(self, x):
        return x.detach() if self.detach_heads else x

    def forward(self, feats, generator=None, lengths=None):
        """(B, T, F, C) features -> raw logits; in train mode dropout draws
        from ``generator``. ``lengths`` (B,) masks padded frames (inference
        only: the masked recurrence does not train)."""

        output = {}

        emb = self._embeddings(feats, generator, lengths)
        multi_pitch = self.pitch_out(emb['pitch'])

        onsets = self.onset_out(self.onset_lm(emb['onset'], lengths))
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
    velocity map in [0, 1] is output.
    """

    head_names = ('pitch', 'onset', 'offset')

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=3,
                 dtype=None, generator=None, dropout=True, detach_heads=True,
                 quant_acoustic=False, quant_lm=False, remat=False,
                 estimate_velocity=False):
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        super().__init__(dim_in, profile, in_channels=in_channels,
                         model_complexity=model_complexity, dtype=dtype,
                         generator=generator, dropout=dropout,
                         detach_heads=detach_heads,
                         quant_acoustic=quant_acoustic, quant_lm=quant_lm,
                         remat=remat)
        self.estimate_velocity = estimate_velocity

        self.offset_lm = LanguageModel(self.dim_am, self.dim_lm, dtype=dtype,
                                       generator=generator, quant=quant_lm)
        self.offset_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                       generator=generator)

        if estimate_velocity:
            self.head_names = self.head_names + ('velocity',)
            self._add_acoustic('velocity', generator)
            self.velocity_lm = LanguageModel(self.dim_am, self.dim_lm,
                                             dtype=dtype, generator=generator,
                                             quant=quant_lm)
            self.velocity_out = RegressionBank(self.dim_lm, self.dim_out,
                                               dtype=dtype,
                                               generator=generator)

    @property
    def dim_aj(self):
        """Refinement consumes onsets + offsets + pitch."""

        return 3 * self.dim_out

    def forward(self, feats, generator=None, lengths=None):
        output = {}

        emb = self._embeddings(feats, generator, lengths)
        multi_pitch = self.pitch_out(emb['pitch'])

        onsets = self.onset_out(self.onset_lm(emb['onset'], lengths))
        output[tools.KEY_ONSETS] = onsets

        offsets = self.offset_out(self.offset_lm(emb['offset'], lengths))
        output[tools.KEY_OFFSETS] = offsets

        if self.estimate_velocity:
            output[tools.KEY_VELOCITY] = self.velocity_out(
                self.velocity_lm(emb['velocity'], lengths))

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
    onset and adjoin LMs run kernel B from their carries, so frames fed
    one at a time keep their full recurrent context
    (``inference.run_online_stateful``). Without carries it is the
    whole-sequence unidirectional model: kernel B in eval, E and F in
    training.
    """

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=2,
                 dtype=None, generator=None, dropout=True, detach_heads=False,
                 quant_acoustic=False, remat=False):
        if model_complexity < 2:
            raise ValueError('OnsetsFramesOnline requires model_complexity '
                             '>= 2.')
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        TranscriptionModel.__init__(
            self, dim_in, profile, in_channels=in_channels,
            model_complexity=model_complexity, dtype=dtype, dropout=dropout,
            quant_acoustic=quant_acoustic, remat=remat)
        self.detach_heads = detach_heads

        for name in self.head_names:
            self._add_acoustic(name, generator)

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
