"""Transcription model base class and the logistic output head.

Counterparts of ``amt_tools_tpu/models/common.py`` ``TranscriptionModel``
(``:42``) and ``LogisticBank`` (``:246``) in inference mode: features arrive
as (B, C, F, T), ``pre_proc`` gives the models (B, T, F, C) as in the JAX
package, and ``finalize_output`` turns (B, T, O) logits into (B, O, T)
activations. Computation runs in ``dtype`` (e.g. ``torch.bfloat16``) while
parameters stay float32. Losses come with the training slice.
"""

from abc import abstractmethod

import torch
import torch.nn as nn

from ..ops.decode import sigmoid
from ..ops.layers import lecun_normal_, linear

__all__ = ['TranscriptionModel', 'LogisticBank']


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
