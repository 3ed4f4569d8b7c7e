"""Bulk serving of a sequence-to-sequence transcriber: ``serve.py``'s
closed loop, with a capture and a check of its own.

The set-up, the loop of ``in_flight`` batches, the reservoir sampling of
one batch over the window and the window itself are ``serve.py``'s. The
model's forward returns tokens, so the capture differs. For the kept batch
it takes, as the batch runs: the features of ``CHECK_CLIPS`` clips'
segments (drawn from the seed when the batch is armed; the benchmark's
wrapper on the features' ``process``), every segment's tokens (a hook on
the model), and the float32 step logits of ``LOGIT_ROWS`` of those
segments (a hook on ``logits_dense``, which every step calls), so that the
timed path keeps no batch's worth of logits.

The check compares, after the window:

- ``features_err``: the largest gap of the served log-mel features from
  the plain reference's float32 features of the same audio, with every bin
  more than :data:`FEATURES_RANGE` below its frame's loudest bin in the
  reference read at that level on both sides (:func:`features_error`);
- ``logit_err``: the served step logits of the ``LOGIT_ROWS`` segments
  against the reference's teacher-forced float32 logits over the served
  tokens (``serve.logit_error``: the RMS gap over the reference's spread);
- ``tokens_bad``: served tokens of those segments that are not the argmax
  of their served logits (PAD after a row's EOS), plus a token for each
  step the logits and tokens disagree in count;
- ``rows_ended``: segments of the batch whose decode ended before the cap
  (an EOS, or fewer steps than the cap);
- ``notes_bad``: the served notes of the checked clips against the
  reference's decode of the served tokens, both ways, a dropped clip
  counting.
"""

import math

import numpy as np
import torch

from .. import trace as spans
from ..reference import plain
from . import serve

CHECK_CLIPS = serve.CHECK_CLIPS

# Segments whose step logits the check compares
LOGIT_ROWS = 8

# The range of a frame's log-mel features that ``features_err`` compares:
# 80 dB of magnitude below the frame's loudest mel bin
FEATURES_RANGE = math.log(1e4)


def features_error(served, reference):
    """The largest gap of (..., n_mels, T) natural-log features from the
    reference's, each bin read no lower than :data:`FEATURES_RANGE` below
    the reference's loudest bin of its frame, on both sides. Below that a
    float32 FFT's rounding, some 1e-7 of a frame's level, is of the bins'
    own size and puts them tens of percent apart however right the
    features are; above it a gain or a filter off by a few percent shows
    in full."""

    level = reference.amax(dim=-2, keepdim=True) - FEATURES_RANGE

    return float((torch.maximum(served, level) -
                  torch.maximum(reference, level)).abs().max())


class Bench(serve.Bench):

    def _instrument(self):
        pipeline = self.pipeline
        model = pipeline.model

        def keep_features(feats):
            if not self.armed:
                return
            size = self.config['input_length'] * self.config['hop_length']
            segments = -(-self.pool[0].shape[1] // size)
            batch = feats.shape[0] // segments
            clips = np.sort(self.rng.choice(batch, min(CHECK_CLIPS, batch),
                                            replace=False))
            rows = (clips[:, None] * segments + np.arange(segments)).ravel()
            picked = np.sort(self.rng.choice(len(rows),
                                             min(LOGIT_ROWS, len(rows)),
                                             replace=False))
            self.captured.update(
                clips=clips, segments=segments, picked=picked,
                features=feats[torch.as_tensor(rows, device=feats.device)]
                .detach().clone(), logits=[],
                index=torch.as_tensor(rows[picked], device=feats.device))

        def keep_tokens(module, args, output):
            if self.armed:
                self.captured['tokens'] = output.detach().clone()

        def keep_logits(module, args, output):
            if self.armed:
                self.captured['logits'].append(
                    output.detach().index_select(0, self.captured['index']))

        spans.wrap_method(pipeline.data_proc, 'process', 'bench.features',
                          keep_features)
        spans.hook_module(model, 'bench.model')
        model.register_forward_hook(keep_tokens)
        model.decoder.logits_dense.register_forward_hook(keep_logits)

    def check(self):
        ctx, limits, config = self.ctx, self.workload['limits'], self.config
        reference = ctx.reference
        index, captured = self.kept
        audio = self.pool[index % len(self.pool)]
        clips, segments = captured['clips'], captured['segments']
        picked = captured['picked']
        tokens = captured['tokens']
        logits = torch.stack(captured['logits'], dim=1)
        feats = captured['features'].float()

        # The decode: every segment to the cap, the tokens the argmax
        ended = (tokens == reference.EOS).any(dim=1)
        rows_ended = (tokens.shape[0] if tokens.shape[1] <
                      self.workload['capacity'] else int(ended.sum()))
        rows = torch.as_tensor(clips[:, None] * segments +
                               np.arange(segments), device=tokens.device)
        served_tokens = tokens[rows.flatten()[torch.as_tensor(
            picked, device=tokens.device)]]
        steps = min(served_tokens.shape[1], logits.shape[1])
        before = torch.cumsum(served_tokens == reference.EOS, dim=1) - (
            served_tokens == reference.EOS).long()
        want = logits[:, :steps].argmax(-1).masked_fill(
            before[:, :steps] > 0, reference.PAD)
        tokens_bad = (int((served_tokens[:, :steps] != want).sum()) +
                      len(picked) * abs(served_tokens.shape[1] -
                                        logits.shape[1]))

        # The served notes against the reference's decode of the tokens
        served = self.kept_notes or []
        bad = 0
        for clip in clips:
            if clip >= len(served):
                bad += 1
                continue
            held = reference.decode(
                tokens[clip * segments:(clip + 1) * segments].cpu().numpy(),
                config)
            bad += reference.note_mismatches(
                reference.served(served[clip], config), held)

        # Free the program's state before the reference runs
        self.pipeline = self.kept = self.captured = None
        if ctx.device.type == 'cuda':
            torch.cuda.empty_cache()

        with torch.no_grad(), plain.exact_float32():
            ref_feats = reference.features(audio[torch.as_tensor(
                clips, device=audio.device)], config)
            ref_logits = reference.forward(
                self.params, ref_feats[torch.as_tensor(
                    picked, device=ref_feats.device)],
                served_tokens[:, :steps], config)
        features_err = features_error(feats, ref_feats)
        logit_err = serve.logit_error({'logits': logits[:, :steps]},
                                      {'logits': ref_logits})

        return [('features_err', features_err, limits['features_err']),
                ('logit_err', logit_err, limits['logit_err']),
                ('tokens_bad', float(tokens_bad), limits['tokens_bad']),
                ('rows_ended', float(rows_ended), limits['rows_ended']),
                ('notes_bad', float(bad), limits['notes_bad'])]
