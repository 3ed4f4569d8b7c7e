"""Transcription model base class and the output heads.

Counterparts of ``amt_tools_tpu/models/common.py`` ``TranscriptionModel``
(``:42``), ``SoftmaxGroups`` (``:182``) and ``LogisticBank`` (``:246``) in
inference mode: features arrive as (B, C, F, T) and each model's
``pre_proc`` lays them out for its forward; ``finalize_output`` turns
(B, T, O) logits into (B, O, T) activations (``LogisticBank``) or (B, G, T)
class ids (``SoftmaxGroups``). Computation runs in ``dtype`` (e.g.
``torch.bfloat16``) while parameters stay float32. Losses come with the
training slice.
"""

from abc import abstractmethod

import torch
import torch.nn as nn

from ..ops.decode import sigmoid
from ..ops.layers import lecun_normal_, linear

__all__ = ['TranscriptionModel', 'SoftmaxGroups', 'LogisticBank']


class TranscriptionModel(nn.Module):
    """Base class for music transcription models (inference forward only)."""

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=1,
                 frame_width=1, dtype=None):
        super().__init__()
        self.dim_in = dim_in
        self.profile = profile
        self.in_channels = in_channels
        self.model_complexity = model_complexity
        self.frame_width = frame_width
        self.dtype = dtype

    def pre_proc(self, batch):
        """Model-specific feature pre-processing (default: identity)."""

        return batch

    def _check_inference(self):
        if self.training:
            raise NotImplementedError(
                f'{type(self).__name__} has an inference forward only (the '
                f'training forward comes with the training slice); call '
                f'.eval() first')

    @abstractmethod
    def forward(self, feats):
        """Features -> dict of raw logits."""

        raise NotImplementedError

    @abstractmethod
    def post_proc(self, batch):
        """Finalize the raw outputs under ``tools.KEY_OUTPUT``."""

        raise NotImplementedError

    @classmethod
    def model_name(cls):
        return cls.__name__


class SoftmaxGroups(nn.Module):
    """Multi-group softmax head for tablature: (B, T, E) -> (B, T, G*C).

    Each degree of freedom (a guitar string) is an independent softmax over
    ``num_classes`` (frets + silence, silence last). The bias starts at
    zero, as Flax's ``Dense`` does.
    """

    def __init__(self, dim_in, dim_out, num_groups, num_classes, dtype=None,
                 generator=None):
        super().__init__()
        self.dim_in = dim_in
        self.dim_out = dim_out
        self.num_groups = num_groups
        self.num_classes = num_classes
        self.dtype = dtype
        self.Dense_0 = nn.Linear(dim_in, dim_out)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        lecun_normal_(self.Dense_0.weight, dim_in, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, feats):
        return linear(feats, self.Dense_0, self.dtype)

    def finalize_output(self, raw_output, last_negative=True):
        """(B, T, G*C) logits -> (B, G, T) int64 class ids (-1 = silence).

        ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does,
        so tied logits (common in bf16) decode alike in both packages.
        """

        out = raw_output.detach()
        out = out.reshape(out.shape[:-1] + (self.num_groups, self.num_classes))
        out = torch.argmax(out, dim=-1)

        if last_negative:
            out = torch.where(out == self.num_classes - 1, -1, out)

        return out.transpose(-1, -2)


class LogisticBank(nn.Module):
    """Multi-label logistic head: (B, T, E) -> (B, T, O) logits.

    The bias starts at ``prior_logit`` (-2, a sparse-activity prior), as in
    the JAX package.
    """

    def __init__(self, dim_in, dim_out, dtype=None, prior_logit=-2.0,
                 generator=None):
        super().__init__()
        self.dim_in = dim_in
        self.dim_out = dim_out
        self.dtype = dtype
        self.Dense_0 = nn.Linear(dim_in, dim_out)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        lecun_normal_(self.Dense_0.weight, dim_in, generator)
        nn.init.constant_(self.Dense_0.bias, prior_logit)

    def forward(self, feats):
        return linear(feats, self.Dense_0, self.dtype)

    @staticmethod
    def finalize_output(raw_output, threshold=None):
        """(B, T, O) logits -> (B, O, T) activations in [0, 1].

        Sigmoid and threshold run in the logits' dtype.
        """

        out = sigmoid(raw_output.detach()).transpose(-1, -2)

        if threshold is not None:
            out = torch.where(out >= threshold, 1.0, 0.0)

        return out
