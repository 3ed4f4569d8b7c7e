"""Onsets & Frames transcription models (V1/V2), inference forward.

Counterparts of ``amt_tools_tpu/models/onsetsframes.py``: ``AcousticModel``
(``:47``), ``LanguageModel`` (``:170``), ``OnsetsFrames`` (``:565``) and
``OnsetsFrames2`` (``:757``) in eval mode. Submodule and parameter names
follow the Flax tree (``pitch_am.Conv_0``, ``onset_lm.FastBiLSTM_0``,
``adjoin_out.Dense_0``, ...), so ``weights.from_flax`` maps one onto the
other by name.

The acoustic stacks run NCHW as (B, C, T, F); the JAX package runs NHWC
(B, T, F, C). Before the dense projection the port permutes back to
(B, T, F/4, C), so the flatten is feature-major (index f * C + c) exactly
as in the JAX package (``onsetsframes.py:157-158``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import tools
from ..ops.layers import BatchNorm, conv2d_same, lecun_normal_, linear
from ..ops.lstm import FastBiLSTM, FastLSTM
from .common import LogisticBank, TranscriptionModel

__all__ = ['AcousticModel', 'LanguageModel', 'OnsetsFrames', 'OnsetsFrames2']


def _conv(in_channels, out_channels, generator):
    conv = nn.Conv2d(in_channels, out_channels, (3, 3))
    lecun_normal_(conv.weight, 9 * in_channels, generator)
    nn.init.zeros_(conv.bias)
    return conv


class AcousticModel(nn.Module):
    """Kelz-style conv stack: (B, T, F, C) features -> (B, T, dim_out).

    Three 3x3 conv + BatchNorm + ReLU blocks, two 1x2 max-pools over
    frequency (F -> F/4), then a dense projection. Dropout is the identity
    at inference.
    """

    def __init__(self, dim_in, dim_out, in_channels=1, model_complexity=2,
                 dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        nf1 = 16 * model_complexity
        nf3 = 32 * model_complexity

        if generator is None:
            generator = torch.Generator().manual_seed(0)

        self.Conv_0 = _conv(in_channels, nf1, generator)
        self.BatchNorm_0 = BatchNorm(nf1)
        self.Conv_1 = _conv(nf1, nf1, generator)
        self.BatchNorm_1 = BatchNorm(nf1)
        self.Conv_2 = _conv(nf1, nf3, generator)
        self.BatchNorm_2 = BatchNorm(nf3)

        features = nf3 * (dim_in // 2 // 2)
        self.Dense_0 = nn.Linear(features, dim_out)
        lecun_normal_(self.Dense_0.weight, features, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def _block(self, x, conv, norm, pool):
        x = conv2d_same(x, conv, self.dtype)
        x = F.relu(norm(x, self.dtype))
        if pool:
            x = F.max_pool2d(x, (1, 2), stride=(1, 2))
        return x

    def forward(self, feats):
        # (B, T, F, C) -> (B, C, T, F)
        x = feats.permute(0, 3, 1, 2)

        x = self._block(x, self.Conv_0, self.BatchNorm_0, pool=False)
        x = self._block(x, self.Conv_1, self.BatchNorm_1, pool=True)
        x = self._block(x, self.Conv_2, self.BatchNorm_2, pool=True)

        # (B, C, T, F/4) -> (B, T, F/4, C) -> (B, T, F/4 * C), feature-major
        x = x.permute(0, 2, 3, 1)
        x = x.reshape(x.shape[:2] + (-1,))

        return linear(x, self.Dense_0, self.dtype)


class LanguageModel(nn.Module):
    """LSTM language model: (B, T, dim_in) -> (B, T, dim_out).

    Bidirectional by default, with ``dim_out // 2`` hidden units per
    direction; the recurrence runs in the Hopper LSTM kernel on CUDA.
    """

    def __init__(self, dim_in, dim_out, bidirectional=True, dtype=None,
                 generator=None):
        super().__init__()
        self.bidirectional = bidirectional

        if bidirectional:
            self.FastBiLSTM_0 = FastBiLSTM(dim_in, dim_out // 2, dtype=dtype,
                                           generator=generator)
        else:
            self.FastLSTM_0 = FastLSTM(dim_in, dim_out, dtype=dtype,
                                       generator=generator)

    def forward(self, feats):
        if self.bidirectional:
            return self.FastBiLSTM_0(feats)

        return self.FastLSTM_0(feats)


class OnsetsFrames(TranscriptionModel):
    """Onsets & Frames (V1), arXiv:1710.11153.

    Heads: onset = AM -> LM -> logistic; pitch = AM -> logistic; refined
    pitch = LM -> logistic over concat(onsets, pitch). ``generator`` seeds
    the random initialization (a fresh generator seeded 0 when omitted).
    """

    head_names = ('pitch', 'onset')

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=2,
                 dtype=None, generator=None):
        super().__init__(dim_in, profile, in_channels=in_channels,
                         model_complexity=model_complexity, dtype=dtype)
        if model_complexity < 2:
            raise ValueError('OnsetsFrames requires model_complexity >= 2 '
                             '(the language-model width is 256 * (complexity - 1)).')

        if generator is None:
            generator = torch.Generator().manual_seed(0)

        for name in self.head_names:
            setattr(self, f'{name}_am',
                    AcousticModel(dim_in, self.dim_am, in_channels,
                                  model_complexity, dtype=dtype,
                                  generator=generator))

        self.onset_lm = LanguageModel(self.dim_am, self.dim_lm, dtype=dtype,
                                      generator=generator)
        self.onset_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                      generator=generator)
        self.pitch_out = LogisticBank(self.dim_am, self.dim_out, dtype=dtype,
                                      generator=generator)
        self.adjoin_lm = LanguageModel(self.dim_aj, self.dim_lm, dtype=dtype,
                                       generator=generator)
        self.adjoin_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                       generator=generator)

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

    def _embeddings(self, feats):
        return {name: getattr(self, f'{name}_am')(feats)
                for name in self.head_names}

    def forward(self, feats):
        self._check_inference()
        output = {}

        emb = self._embeddings(feats)
        multi_pitch = self.pitch_out(emb['pitch'])

        onsets = self.onset_out(self.onset_lm(emb['onset']))
        output[tools.KEY_ONSETS] = onsets

        joint = torch.cat((onsets, multi_pitch), dim=-1)
        output[tools.KEY_MULTIPITCH] = self.adjoin_out(self.adjoin_lm(joint))

        return output

    def post_proc(self, batch):
        """Thresholded onset and multi-pitch activations, (B, O, T)."""

        output = dict(batch[tools.KEY_OUTPUT])
        output[tools.KEY_ONSETS] = LogisticBank.finalize_output(
            output[tools.KEY_ONSETS], 0.5)
        output[tools.KEY_MULTIPITCH] = LogisticBank.finalize_output(
            output[tools.KEY_MULTIPITCH], 0.5)

        return output


class OnsetsFrames2(OnsetsFrames):
    """Onsets & Frames (V2), arXiv:1810.12247.

    Adds an offset head; the refinement stage consumes onsets, offsets and
    the initial pitch estimate. At complexity 3: three 48/48/96-channel
    acoustic stacks with a 5472 -> 768 dense (229 mels), three BiLSTMs of
    256 units per direction, 88-key logistic heads.
    """

    head_names = ('pitch', 'onset', 'offset')

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=3,
                 dtype=None, generator=None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        super().__init__(dim_in, profile, in_channels=in_channels,
                         model_complexity=model_complexity, dtype=dtype,
                         generator=generator)

        self.offset_lm = LanguageModel(self.dim_am, self.dim_lm, dtype=dtype,
                                       generator=generator)
        self.offset_out = LogisticBank(self.dim_lm, self.dim_out, dtype=dtype,
                                       generator=generator)

    @property
    def dim_aj(self):
        """Refinement consumes onsets + offsets + pitch."""

        return 3 * self.dim_out

    def forward(self, feats):
        self._check_inference()
        output = {}

        emb = self._embeddings(feats)
        multi_pitch = self.pitch_out(emb['pitch'])

        onsets = self.onset_out(self.onset_lm(emb['onset']))
        output[tools.KEY_ONSETS] = onsets

        offsets = self.offset_out(self.offset_lm(emb['offset']))
        output[tools.KEY_OFFSETS] = offsets

        joint = torch.cat((onsets, offsets, multi_pitch), dim=-1)
        output[tools.KEY_MULTIPITCH] = self.adjoin_out(self.adjoin_lm(joint))

        return output

    def post_proc(self, batch):
        output = super().post_proc(batch)
        output[tools.KEY_OFFSETS] = LogisticBank.finalize_output(
            output[tools.KEY_OFFSETS])

        return output
