"""The note model of High-resolution Piano Transcription (Kong, Li, Song,
Wan and Wang, IEEE/ACM TASLP 29, 2021, arXiv:2010.01815): the published
``Regress_onset_offset_frame_velocity_CRNN`` of ``bytedance/
piano_transcription`` (``pytorch/models.py``), in eval and train mode.

The JAX package has no counterpart. Submodule and parameter names are the
published ones (``bn0``, ``frame_model.conv_block1.conv1``, ``frame_model.
gru.weight_hh_l0_reverse``, ``reg_onset_fc``, ...), so a state dict under
those names loads with ``strict=True``; the norms keep no
``num_batches_tracked``.

- ``bn0``: a BatchNorm over the mel bins, which act as its channels.
- Four acoustic stacks (:class:`AcousticCRNN`), ``frame_model``,
  ``reg_onset_model``, ``reg_offset_model`` and ``velocity_model``: four
  ConvBlocks of 48, 64, 96 and 128 channels, each two bias-free 3x3 convs
  with BatchNorm and ReLU and a (1, 2) average pool over frequency
  (229 -> 114 -> 57 -> 28 -> 14); the channel-major flatten to 1,792
  values a frame; ``fc5`` (no bias), BatchNorm1d and ReLU; a 2-layer BiGRU
  of 256 units a direction; a Linear to 88 keys.
- The onset curve conditioned on velocity: ``cat(onset, onset ** 0.5 *
  velocity)`` through ``reg_onset_gru`` and ``reg_onset_fc``; the frame
  curve conditioned on the other heads: ``cat(frame, onset, offset)``
  through ``frame_gru`` and ``frame_fc``.

:meth:`RegressCRNN.forward` takes (B, 1, F, T) features (``MelSpec`` with
``absolute_db``) and returns the four final heads' logits, (B, T, 88) each:
``frame``, ``reg_onset``, ``reg_offset`` and ``velocity``; each is the
published output before its sigmoid. The sigmoids between the heads and the
conditioning recurrences are ``torch.sigmoid`` in the compute dtype.

Computation runs in ``dtype`` (e.g. bf16) with float32 parameters and
float32 BatchNorm arithmetic. The stacks run channels-last: each conv is
``ops.layers.conv_block`` (in eval on CUDA a bias-free cuDNN conv and one
pass of the epilogue kernel, which average-pools after a block's second
conv), ``fc5`` with its norm and ReLU is ``ops.layers.dense_block``, and
the flatten reads the (B, T, F, C) memory as it lies, with ``fc5``'s
columns permuted to match. The ten BiGRUs run through
``ops.gru.bigru_layers``: the first layers of the four stacks are one
grouped recurrence, their second layers another, then the onset
conditioning and the frame conditioning, one each (kernel G in eval on
CUDA: four launches a forward). The four stacks' convs and ``fc5`` run
inside the span ``amt.acoustic``, the GRU layers inside ``amt.gru``.

Training mode (batch-statistics norms; dropout of 0.2 after each block
and 0.5 after ``fc5`` and after each head's recurrence, drawn from the
forward's ``generator``) runs the eager ops and the GRUs' plain version;
the published regression losses are not part of the port.
"""

import torch
import torch.nn as nn

from .. import profiling, tools
from ..ops.gru import BiGRU, bigru_layers
from ..ops.layers import (BatchNorm, conv_block, dense_block, dropout,
                          lecun_normal_, linear)
from .common import TranscriptionModel

__all__ = ['ConvBlock', 'AcousticCRNN', 'RegressCRNN', 'HEADS']

# The final heads, in the order the forward returns them
HEADS = ('frame', 'reg_onset', 'reg_offset', 'velocity')


def _conv(in_channels, out_channels, generator):
    conv = nn.Conv2d(in_channels, out_channels, (3, 3), padding=1,
                     bias=False)
    lecun_normal_(conv.weight, 9 * in_channels, generator)

    return conv


def _dense(in_features, out_features, generator, bias=True):
    layer = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(layer.weight, in_features, generator)
    if bias:
        nn.init.zeros_(layer.bias)

    return layer


class ConvBlock(nn.Module):
    """Two bias-free 3x3 convs, each with BatchNorm and ReLU, then a (1, 2)
    average pool over frequency: (B, C, T, F) -> (B, C', T, F // 2)."""

    def __init__(self, in_channels, out_channels, generator):
        super().__init__()
        self.conv1 = _conv(in_channels, out_channels, generator)
        self.conv2 = _conv(out_channels, out_channels, generator)
        self.bn1 = BatchNorm(out_channels)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x, dtype=None):
        x = conv_block(x, self.conv1, self.bn1, False, dtype)

        return conv_block(x, self.conv2, self.bn2, True, dtype, avg=True)


class AcousticCRNN(nn.Module):
    """One acoustic stack (the published ``AcousticModelCRnn8Dropout``):
    (B, 1, T, F) -> the stack's (B, T, 768) embedding (:meth:`embed`),
    then its BiGRU ``gru`` and the Linear ``fc`` to ``classes`` logits,
    which :class:`RegressCRNN` runs with the other stacks' (their BiGRUs
    grouped)."""

    widths = (48, 64, 96, 128)

    def __init__(self, dim_in, classes, dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        channels = 1
        for index, width in enumerate(self.widths, 1):
            setattr(self, f'conv_block{index}',
                    ConvBlock(channels, width, generator))
            channels = width
        self.freqs = dim_in
        for _ in self.widths:
            self.freqs //= 2
        self.channels = channels
        self.fc5 = _dense(channels * self.freqs, 768, generator, bias=False)
        self.bn5 = BatchNorm(768)
        self.gru = BiGRU(768, 256, num_layers=2, dtype=dtype,
                         generator=generator)
        self.fc = _dense(512, classes, generator)

    def embed(self, x, generator=None):
        """(B, 1, T, F) -> (B, T, 768): the conv blocks, the flatten, fc5,
        its norm and ReLU (dropouts from ``generator`` in train mode)."""

        x = x.contiguous(memory_format=torch.channels_last)
        for index in range(1, len(self.widths) + 1):
            x = getattr(self, f'conv_block{index}')(x, self.dtype)
            if self.training:
                x = dropout(x, 0.2, generator)

        # (B, C, T, F) channels-last is (B, T, F, C) in memory: flatten it
        # frequency-major and permute fc5's channel-major columns to match
        batch, channels, frames, freqs = x.shape
        x = x.permute(0, 2, 3, 1).reshape(batch, frames, freqs * channels)
        weight = self.fc5.weight.view(-1, channels, freqs).transpose(
            1, 2).reshape(self.fc5.weight.shape)
        x = dense_block(x, self.fc5, self.bn5, self.dtype, weight=weight)

        return dropout(x, 0.5, generator) if self.training else x


class RegressCRNN(TranscriptionModel):
    """High-resolution Piano Transcription's note model: (B, 1, F, T)
    absolute-dB mel features -> ``{frame, reg_onset, reg_offset,
    velocity}`` logits, each (B, T, keys) (the module docstring).

    ``dim_in`` is the mel bins (229), ``profile`` the piano
    (``tools.PianoProfile``, 88 keys). ``generator`` draws the initial
    values (a fresh generator seeded 0 when omitted)."""

    def __init__(self, dim_in=229, profile=None, dtype=None, generator=None):
        profile = tools.PianoProfile() if profile is None else profile
        super().__init__(dim_in, profile, dtype=dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        keys = profile.get_range_len()

        self.bn0 = BatchNorm(dim_in)
        for name in ('frame', 'reg_onset', 'reg_offset', 'velocity'):
            setattr(self, f'{name}_model',
                    AcousticCRNN(dim_in, keys, dtype=dtype,
                                 generator=generator))
        self.reg_onset_gru = BiGRU(2 * keys, 256, dtype=dtype,
                                   generator=generator)
        self.reg_onset_fc = _dense(512, keys, generator)
        self.frame_gru = BiGRU(3 * keys, 256, dtype=dtype,
                               generator=generator)
        self.frame_fc = _dense(512, keys, generator)

    def stacks(self):
        """The four acoustic stacks, in ``HEADS``' order."""

        return [getattr(self, f'{name}_model') for name in HEADS]

    def _dropout(self, x, rate, generator):
        return dropout(x, rate, generator) if self.training else x

    def forward(self, feats, generator=None):
        dtype = self.dtype or feats.dtype
        # bn0 over the mel bins: (B, 1, F, T) -> (B, F, T) -> (B, 1, T, F)
        x = self.bn0(feats[:, 0].float(), dtype)
        x = x.transpose(1, 2).unsqueeze(1).contiguous(
            memory_format=torch.channels_last)

        stacks = self.stacks()
        with profiling.span('amt.acoustic'):
            embeddings = [stack.embed(x, generator) for stack in stacks]
        hidden = bigru_layers([stack.gru for stack in stacks], embeddings)
        frame, onset, offset, velocity = (
            linear(self._dropout(h, 0.5, generator), stack.fc, dtype)
            for stack, h in zip(stacks, hidden))

        # The onset curve conditioned on velocity
        onset_p = torch.sigmoid(onset)
        cond = torch.cat([onset_p, onset_p.sqrt() *
                          torch.sigmoid(velocity).detach()], dim=-1)
        onset = linear(self._dropout(self.reg_onset_gru(cond), 0.5,
                                     generator), self.reg_onset_fc, dtype)

        # The frame curve conditioned on the onset and offset curves
        cond = torch.cat([torch.sigmoid(frame),
                          torch.sigmoid(onset).detach(),
                          torch.sigmoid(offset).detach()], dim=-1)
        frame = linear(self._dropout(self.frame_gru(cond), 0.5, generator),
                       self.frame_fc, dtype)

        return {'frame': frame, 'reg_onset': onset, 'reg_offset': offset,
                'velocity': velocity}

    def post_proc(self, batch):
        """The four curves as (B, keys, T) sigmoid activations."""

        output = batch[tools.KEY_OUTPUT]
        batch[tools.KEY_OUTPUT] = {key: torch.sigmoid(output[key]).transpose(
            -1, -2) for key in HEADS}

        return batch[tools.KEY_OUTPUT]
