"""Transcription model base class and the output heads.

Counterparts of ``amt_tools_tpu/models/common.py`` ``TranscriptionModel``
(``:42``), ``run_on_batch`` (``:122``), ``SoftmaxGroups`` (``:182``),
``LogisticBank`` (``:246``) and ``RegressionBank`` (``:302``): features
arrive as (B, C, F, T) and each model's ``pre_proc`` lays them out for its
forward; ``finalize_output`` turns (B, T, O) logits into (B, O, T)
activations (``LogisticBank``), (B, G, T) class ids (``SoftmaxGroups``) or
(B, O, T) linear values (``RegressionBank``). Computation runs in ``dtype``
(e.g. ``torch.bfloat16``) while parameters stay float32; losses are float32:
``LogisticBank.get_loss`` (BCE), ``SoftmaxGroups.get_loss`` (softmax CE
over integer tablature labels, ``:203-230``) and ``RegressionBank.get_loss``
(masked MSE in the log domain). Every model trains. The three heads derive
from ``OutputLayer`` (``:156``), the projection with its loss and decode.
"""

import inspect

from abc import abstractmethod

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import tools
from ..ops.decode import sigmoid
from ..ops.layers import lecun_normal_, linear

__all__ = ['TranscriptionModel', 'OutputLayer', 'SoftmaxGroups',
           'LogisticBank', 'RegressionBank', 'run_on_batch']


class TranscriptionModel(nn.Module):
    """Base class for music transcription models.

    ``dropout=False`` trains without dropout noise (BatchNorm still takes
    batch statistics), as the JAX package's flag does (``:79-83``): for
    reproducible fine-tuning and for tests that step two frameworks side by
    side.

    ``remat`` (``:60-66``) recomputes the acoustic conv stacks in the
    backward pass instead of keeping their activations: ``True`` checkpoints
    each whole stack, ``'blocks'`` each conv block
    (``torch.utils.checkpoint``, ``ops.layers.checkpoint``). It changes
    memory and never math: the parameter tree, the losses, the gradients and
    the BatchNorm running statistics are those of ``remat=False`` bit for
    bit (``models/onsetsframes.py`` ``AcousticModel``).

    Serving only (``:66-78``): ``quant_acoustic`` runs the acoustic conv
    stacks, ``quant_lm`` the language models' hoisted input projections, as
    int8 contractions (``ops.qconv``). Each is ``False``, ``True`` (dynamic
    activation scales) or ``'static'`` (calibrated scales, filled by
    ``serving.calibrate_quant_stats``). The parameters keep the float
    model's names; do not train with these.
    """

    def __init__(self, dim_in, profile, in_channels=1, model_complexity=1,
                 frame_width=1, dtype=None, dropout=True, quant_acoustic=False,
                 quant_lm=False, remat=False):
        super().__init__()
        if remat not in (False, True, 'blocks'):
            raise ValueError(f"remat must be False, True or 'blocks', got "
                             f"{remat!r}")
        self.dim_in = dim_in
        self.profile = profile
        self.in_channels = in_channels
        self.model_complexity = model_complexity
        self.frame_width = frame_width
        self.dtype = dtype
        self.dropout = dropout
        self.quant_acoustic = quant_acoustic
        self.quant_lm = quant_lm
        self.remat = remat

    def pre_proc(self, batch):
        """Model-specific feature pre-processing (default: identity)."""

        return batch

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


class OutputLayer(nn.Module):
    """Generic output layer: a projection plus its loss and decode (JAX
    ``:156-180``). ``dtype`` is the projection's compute dtype (parameters
    stay float32; losses accumulate in float32); ``weights`` are the
    layer's loss weights, if any."""

    def __init__(self, dim_in, dim_out, weights=None, dtype=None):
        super().__init__()
        self.dim_in = dim_in
        self.dim_out = dim_out
        self.weights = weights
        self.dtype = dtype

    @abstractmethod
    def forward(self, feats):
        raise NotImplementedError

    @abstractmethod
    def get_loss(self, estimated, reference):
        raise NotImplementedError

    def finalize_output(self, raw_output):
        """Raw output cut from the gradient graph."""

        return raw_output.detach()


class SoftmaxGroups(OutputLayer):
    """Multi-group softmax head for tablature: (B, T, E) -> (B, T, G*C).

    Each degree of freedom (a guitar string) is an independent softmax over
    ``num_classes`` (frets + silence, silence last). The bias starts at
    zero, as Flax's ``Dense`` does.
    """

    def __init__(self, dim_in, dim_out, num_groups, num_classes, dtype=None,
                 generator=None):
        super().__init__(dim_in, dim_out, dtype=dtype)
        self.num_groups = num_groups
        self.num_classes = num_classes
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


class LogisticBank(OutputLayer):
    """Multi-label logistic head: (B, T, E) -> (B, T, O) logits.

    The bias starts at ``prior_logit`` (-2, a sparse-activity prior), as in
    the JAX package.
    """

    def __init__(self, dim_in, dim_out, dtype=None, prior_logit=-2.0,
                 generator=None):
        super().__init__(dim_in, dim_out, dtype=dtype)
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


class RegressionBank(OutputLayer):
    """Per-key bounded regression head (note velocities in [0, 1]):
    (B, T, E) -> (B, T, O) logits.

    The JAX package's head (``:302-373``): a sigmoid-squashed projection
    (LeCun-normal kernel, zero bias), trained with a masked MSE, that
    regresses in the log (decibel) domain: references arrive and finalized
    outputs leave as linear [0, 1] values. ``floor_db`` sets the range:
    1.0 maps to 1 and ``10^(floor_db / 20)`` (about 0.03 at -30 dB) to 0.
    """

    def __init__(self, dim_in, dim_out, dtype=None, floor_db=-30.0,
                 generator=None):
        super().__init__(dim_in, dim_out, dtype=dtype)
        self.floor_db = floor_db
        self.Dense_0 = nn.Linear(dim_in, dim_out)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        lecun_normal_(self.Dense_0.weight, dim_in, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, feats):
        return linear(feats, self.Dense_0, self.dtype)

    def to_log_domain(self, values):
        """Linear [0, 1] -> dB-normalized [0, 1] (1.0 -> 1, floor -> 0), in
        float32."""

        floor = 10.0 ** (self.floor_db / 20.0)
        values = torch.clamp(torch.as_tensor(values).float(), floor, 1.0)

        return 1.0 - 20.0 * torch.log10(values) / self.floor_db

    def from_log_domain(self, values):
        """dB-normalized [0, 1] -> linear [0, 1], in the values' dtype."""

        return 10.0 ** (self.floor_db * (1.0 - values) / 20.0)

    def get_loss(self, estimated, reference, mask):
        """Masked MSE: (B, T, O) logits vs (B, O, T) reference, float32.

        ``mask`` (B, O, T) marks the cells that count; the squared error of
        the sigmoid against the log-domain reference is averaged over them
        (over at least one).
        """

        predicted = sigmoid(estimated.transpose(-1, -2).float())
        mask = mask.float()
        squared = (predicted - self.to_log_domain(reference)) ** 2

        return (squared * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def finalize_output(self, raw_output):
        """(B, T, O) logits -> (B, O, T) linear values in [0, 1]; the
        sigmoid and the exponent in the logits' dtype."""

        return self.from_log_domain(
            sigmoid(raw_output.detach()).transpose(-1, -2))
