"""Bulk serving: a closed loop over the port's serving pipeline.

The loop keeps ``in_flight`` batches dispatched: the next ``dispatch`` is
made before the oldest batch's ``finalize``, so the host's note decode of
one batch overlaps the device's work on the next. Batches come from the
mix's pool of distinct batches, cycled. A clip counts when its notes have
come back to the host.

The check compares, for clips the timed path served (one batch drawn from
the seed by reservoir sampling over the window's batches, then clips of it
drawn from the seed), the features and the logits that path computed
(taken by the benchmark's hooks as the batch ran) with the plain
reference's float32 features and logits of the same audio and weights, and
the notes it served with the notes that its own logits hold (the
reference's decode, on the logits' device and dtype).
"""

import collections
import time

import numpy as np
import torch

from .. import trace as spans
from .. import weights
from ..harness import Record
from ..reference import plain

# The reference sets the head biases on a probe of this many clips of the
# first batch, cut to this many seconds
PROBE_CLIPS = 2
PROBE_SECONDS = 10

# Clips of the kept batch that the check compares
CHECK_CLIPS = 4


def inputs(ctx):
    """(weights, pool of audio batches) of a run: the weights from the
    seed, their head biases set by the reference on a probe of the first
    batch."""

    params = weights.make(ctx.reference.parameters(ctx.config), ctx.seed,
                          ctx.device)
    ctx.mark('weights')
    pool = ctx.generator.make(ctx.traffic, ctx.config, ctx.reference,
                              ctx.seed, ctx.device)
    ctx.mark('traffic')
    probe = int(PROBE_SECONDS * ctx.config['sample_rate'])
    ctx.reference.calibrate(params, pool[0][:PROBE_CLIPS, :probe], ctx.config)
    ctx.mark('calibrate')

    return params, pool


class Bench:

    def __init__(self, ctx):
        self.ctx = ctx
        self.workload = ctx.workload
        self.config = ctx.config
        self.profiler = None
        self.kept = None
        self.kept_notes = None
        self.armed = False
        self.captured = {}
        self.seen = 0
        self.next = 0
        self.counts = {'clips': 0, 'failed': 0}

    # Set-up

    def setup(self):
        ctx, workload = self.ctx, self.workload
        self.params, self.pool = inputs(ctx)
        self.pipeline = ctx.program.serving(self.config, self.params,
                                            ctx.device, workload['capacity'])
        self._instrument()
        ctx.mark('program')
        self.rng = np.random.RandomState(
            weights.derive(ctx.seed, 'check') % (1 << 32))

        # Every shape the window uses, the capture's copies included
        self.sampling = False
        self._loop(count=workload['in_flight'] + 1)
        self.counts = {'clips': 0, 'failed': 0}
        self.kept = self.kept_notes = None
        if ctx.trace:
            self.profiler = spans.Profiler(ctx.device)
            self.profiler.warm()

    def _instrument(self):
        pipeline = self.pipeline

        def keep_features(feats):
            if self.armed:
                self.captured['features'] = feats.detach().clone()

        def keep_logits(module, args, output):
            if self.armed:
                self.captured['logits'] = {
                    key: value.detach().clone() for key, value in
                    self.ctx.reference.logits_of(output).items()}

        spans.wrap_method(pipeline.data_proc, 'process', 'bench.features',
                          keep_features)
        spans.hook_module(pipeline.model, 'bench.model')
        pipeline.model.register_forward_hook(keep_logits)
        for module in self.ctx.program.language_models(pipeline.model):
            spans.hook_module(module, 'bench.lm')

    # The window

    def _dispatch(self, pending):
        index = self.next
        self.next += 1
        keep = False
        if self.sampling:
            # Reservoir sampling of one batch over the window's batches
            keep = self.rng.randint(self.seen + 1) == 0
            self.seen += 1
        elif index == 0:
            # The warm-up takes one capture too, so the window's find the
            # allocator ready
            keep = True
        self.armed = keep
        with spans.span('bench.dispatch'):
            handle = self.pipeline.dispatch(self.pool[index % len(self.pool)])
        self.armed = False
        if keep:
            self.kept = index, self.captured
            self.captured = {}
        pending.append((index, handle))

    def _finalize(self, pending):
        index, handle = pending.popleft()
        with spans.span('bench.finalize'):
            notes = self.pipeline.finalize(handle)
        batch = self.pool[index % len(self.pool)].shape[0]
        self.counts['clips'] += min(len(notes), batch)
        self.counts['failed'] += max(0, batch - len(notes))
        if self.kept is not None and self.kept[0] == index:
            self.kept_notes = notes

    def _loop(self, count=None, seconds=None):
        """Serve until ``count`` batches are dispatched or ``seconds`` have
        passed, then finish those in flight -> seconds taken."""

        pending = collections.deque()
        dispatched = 0
        start = time.perf_counter()
        while not (count is not None and dispatched >= count or
                   seconds is not None and
                   time.perf_counter() - start >= seconds):
            self._dispatch(pending)
            dispatched += 1
            if len(pending) >= self.workload['in_flight']:
                self._finalize(pending)
        while pending:
            self._finalize(pending)
        if self.ctx.device.type == 'cuda':
            torch.cuda.synchronize(self.ctx.device)

        return time.perf_counter() - start

    def window(self, seconds):
        self.sampling = True
        elapsed = self._loop(seconds=seconds)
        traced = None
        if self.profiler is not None:
            items = self.workload['trace_items']
            with self.profiler.stretch():
                elapsed += self._loop(count=items)
            traced = self.profiler.reduce(items)
        self.sampling = False

        batch, num_samples = self.pool[0].shape
        clip_seconds = num_samples / self.config['sample_rate']
        work = {'clips': self.counts['clips'],
                'audio_s': self.counts['clips'] * clip_seconds}

        return Record(self.ctx, elapsed, work,
                      attempted=self.counts['clips'] + self.counts['failed'],
                      failed=self.counts['failed'],
                      shape={'batch': batch, 'num_samples': num_samples,
                             'frames': 1 + num_samples //
                             self.config['hop_length']},
                      trace=traced)

    # The check

    def check(self):
        ctx, limits = self.ctx, self.workload['limits']
        reference = ctx.reference
        index, captured = self.kept
        audio = self.pool[index % len(self.pool)]
        clips = np.sort(self.rng.choice(audio.shape[0],
                                        min(CHECK_CLIPS, audio.shape[0]),
                                        replace=False))
        # A clip the timed path dropped is wrong; the rest are compared
        served = self.kept_notes or []
        present = [c for c in clips if c < len(served) and
                   c < captured['features'].shape[0]]
        bad = len(clips) - len(present)
        picked = torch.as_tensor(present, dtype=torch.long, device=ctx.device)
        feats = captured['features'][picked].float()
        logits = {key: value[picked] for key, value in
                  captured['logits'].items()}
        audio = audio[picked].clone()

        # The served notes against what the served logits hold
        for n, clip in enumerate(present):
            held = reference.decode({key: value[n] for key, value in
                                     logits.items()}, self.config)
            bad += plain.note_mismatches(
                reference.served(served[clip], self.config), held)

        # Free the program's state before the reference runs
        self.pipeline = self.kept = self.captured = None
        if ctx.device.type == 'cuda':
            torch.cuda.empty_cache()

        features_err = logit_err = None
        if present:
            with torch.no_grad(), plain.exact_float32():
                ref_feats = reference.features(audio, self.config)
                ref_logits = reference.forward(self.params, ref_feats,
                                               self.config)
            features_err = float((feats - ref_feats).abs().max())
            logit_err = logit_error(logits, ref_logits)

        return [('features_err', features_err, limits['features_err']),
                ('logit_err', logit_err, limits['logit_err']),
                ('notes_bad', float(bad), limits['notes_bad'])]


def logit_error(got, want):
    """The worst head's RMS gap between served and reference logits, over
    the spread (standard deviation) of the reference's logits."""

    worst = 0.0
    for key in got:
        ref = want[key]
        gap = got[key].double() - ref.double()
        worst = max(worst, float(gap.pow(2).mean().sqrt() /
                                 ref.double().std().clamp_min(1e-30)))

    return worst
