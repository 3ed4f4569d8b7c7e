"""Transcription model base class and the output heads.

Counterparts of ``amt_tools_tpu/models/common.py`` ``TranscriptionModel``
(``:42``), ``run_on_batch`` (``:122``), ``SoftmaxGroups`` (``:182``) and
``LogisticBank`` (``:246``): features arrive as (B, C, F, T) and each
model's ``pre_proc`` lays them out for its forward; ``finalize_output``
turns (B, T, O) logits into (B, O, T) activations (``LogisticBank``) or
(B, G, T) class ids (``SoftmaxGroups``). Computation runs in ``dtype``
(e.g. ``torch.bfloat16``) while parameters stay float32; losses are float32:
``LogisticBank.get_loss`` (BCE) and ``SoftmaxGroups.get_loss`` (softmax CE
over integer tablature labels, ``:203-230``). The O&F models train; TabCNN
computes its loss in eval mode (validation) and its train-mode forward is
not ported yet.
"""

import inspect

from abc import abstractmethod

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import tools
from ..ops.decode import sigmoid
from ..ops.layers import lecun_normal_, linear

__all__ = ['TranscriptionModel', 'SoftmaxGroups', 'LogisticBank',
           'run_on_batch']


class TranscriptionModel(nn.Module):
    """Base class for music transcription models.

    ``dropout=False`` trains without dropout noise (BatchNorm still takes
    batch statistics), as the JAX package's flag does (``:79-83``): for
    reproducible fine-tuning and for tests that step two frameworks side by
    side.

    Serving only (``:66-78``): ``quant_acoustic`` runs the acoustic conv
    stacks, ``quant_lm`` the language models' hoisted input projections, as
    int8 contractions (``ops.qconv``). Each is ``False``, ``True`` (dynamic
    activation scales) or ``'static'`` (calibrated scales, filled by
    ``serving.calibrate_quant_stats``). The parameters keep the float
    model's names; do not train with these.
    """

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=1,
                 frame_width=1, dtype=None, dropout=True, quant_acoustic=False,
                 quant_lm=False):
        super().__init__()
        self.dim_in = dim_in
        self.profile = profile
        self.in_channels = in_channels
        self.model_complexity = model_complexity
        self.frame_width = frame_width
        self.dtype = dtype
        self.dropout = dropout
        self.quant_acoustic = quant_acoustic
        self.quant_lm = quant_lm

    def pre_proc(self, batch):
        """Model-specific feature pre-processing (default: identity)."""

        return batch

    def _check_inference(self):
        if self.training:
            raise NotImplementedError(
                f'{type(self).__name__} has an inference forward only (its '
                f'train-mode forward is not ported yet); call .eval() first')

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


def run_on_batch(model, batch, train=False, generator=None):
    """Full pipeline on one batch: ``pre_proc`` -> forward -> ``post_proc``.

    Sets the model's mode to ``train`` first. In train mode BatchNorm takes
    batch statistics and updates its running buffers in place (the JAX
    function returns them as ``mutated``), and dropout draws from
    ``generator``. A batch with ``tools.KEY_VALID_FRAMES`` (bucketed
    evaluation) passes it as ``lengths`` to a model whose ``forward`` takes
    them (JAX ``:135-140``). Returns the output dict, with
    ``tools.KEY_LOSS`` when the batch carries ground truth; differentiable
    through the losses.
    """

    batch = model.pre_proc(dict(batch))
    model.train(train)

    kwargs = {} if generator is None else {'generator': generator}
    if (tools.KEY_VALID_FRAMES in batch and
            'lengths' in inspect.signature(model.forward).parameters):
        kwargs['lengths'] = batch[tools.KEY_VALID_FRAMES]
    batch[tools.KEY_OUTPUT] = model(batch[tools.KEY_FEATS], **kwargs)
    output = model.post_proc(batch)

    if tools.query_dict(batch, tools.KEY_TIMES):
        output[tools.KEY_TIMES] = batch[tools.KEY_TIMES]

    return output


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

    def get_loss(self, estimated, reference, weights=None):
        """Softmax CE: (B, T, G*C) logits vs (B, G, T) class ids, float32.

        Silence (-1) is the last class; ``optax.softmax_cross_entropy_with_
        integer_labels``' form (the max-shifted log-normalizer less the
        label's logit); ``weights`` (G*C,) scale each (group, class) label.
        Summed over the groups, averaged over frames, then the batch.
        """

        num_classes = self.num_classes
        labels = reference.transpose(-1, -2).long()
        labels = torch.where(labels == -1, num_classes - 1, labels)

        logits = estimated.float().reshape(
            estimated.shape[:-1] + (self.num_groups, num_classes))
        shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
        label_logits = torch.gather(shifted, -1, labels[..., None])[..., 0]
        loss = torch.log(torch.exp(shifted).sum(dim=-1)) - label_logits

        if weights is not None:
            weights = torch.as_tensor(weights, dtype=torch.float32,
                                      device=loss.device).reshape(
                                          self.num_groups, num_classes)
            loss = loss * torch.gather(
                weights.expand(labels.shape[:-1] + weights.shape), -1,
                labels[..., None])[..., 0]

        return loss.sum(dim=-1).mean(dim=-1).mean()

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
    def get_loss(estimated, reference, weights=None):
        """BCE loss: (B, T, O) logits vs (B, O, T) reference, in float32.

        ``optax.sigmoid_binary_cross_entropy``'s form, ``-y log s(x) -
        (1 - y) log s(-x)``; averaged over frames, summed over keys,
        averaged over the batch. ``weights`` (O,) scales each key.
        """

        logits = estimated.transpose(-1, -2).float()
        labels = reference.float()

        loss = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(
            -logits)

        if weights is not None:
            loss = loss * torch.as_tensor(weights, dtype=torch.float32,
                                          device=loss.device)[..., None]

        return loss.mean(dim=-1).sum(dim=-1).mean()

    @staticmethod
    def finalize_output(raw_output, threshold=None):
        """(B, T, O) logits -> (B, O, T) activations in [0, 1].

        Sigmoid and threshold run in the logits' dtype.
        """

        out = sigmoid(raw_output.detach()).transpose(-1, -2)

        if threshold is not None:
            out = torch.where(out >= threshold, 1.0, 0.0)

        return out
