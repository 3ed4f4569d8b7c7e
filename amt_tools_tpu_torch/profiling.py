"""Tracing and profiling: spans, traces, stage timers, peaks, FLOPs and MFU.

Counterpart of ``amt_tools_tpu/profiling.py`` (``trace``, ``StageTimer``,
``block_and_time``, ``peak_flops``, ``compiled_flops``, ``mfu``, and
``compiled_cost``, ``peak_hbm_bw``):

- :func:`trace` is a ``torch.profiler`` run that writes a trace TensorBoard
  reads (``tensorboard_trace_handler``), with the card's activity where
  there is one;
- :func:`block_and_time` and :class:`StageTimer` read the host clock after
  ``torch.cuda.synchronize()`` wherever CUDA is in use, so a stage is
  charged its device work;
- :func:`peak_flops` and :func:`peak_hbm_bw` read a table keyed by
  ``torch.cuda.get_device_name``: the published dense peaks of the H100 SXM
  at 700 W; an unknown card and the CPU give 0.0;
- :func:`compiled_flops` runs the function once under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts the aten ops it
  knows (convolutions, matmuls) and the hand-written kernels A-F through
  the FLOP formulas their custom ops register (``ops.cuda_build.
  register_cost``);
- :func:`compiled_cost` adds the bytes of every dispatched op.

Nothing here is compiled: the counts come from one eager run of ``fn``.

The port opens named ranges (:func:`span`) at its layer boundaries, once a
layer call. A profiler that records, :func:`trace`'s for one, shows them
on the timeline of the device's work and gives each kernel to the ranges
around its launch; with no profiler recording they cost one check:

- ``amt.features``: ``MelSpec.process`` and ``VQT.process`` (``CQT``'s);
- ``amt.acoustic``: ``AcousticModel`` and ``GroupedAcousticModel``'s
  forwards, TabCNN's conv stack and its max-pool, the four conv stacks of
  ``RegressCRNN`` with their ``fc5``, the front end of ``HFTransformer``
  (each frame's context, the conv and the bins' embedding);
- ``amt.lstm``: ``FastLSTM``, ``FastBiLSTM`` and ``GroupedBiLSTM``'s
  forwards, the input projections and the recurrences;
- ``amt.gru``: each grouped GRU layer of ``ops.gru.bigru_layers`` (the
  High-resolution Piano Transcription model's four a forward), the input
  projections and the recurrence (kernel G);
- ``amt.transformer``: each transformer stack of ``HFTransformer``, three
  a forward (the frequency encoder, the frequency decoder, the time
  encoder), their projections, attention and feed-forward layers; the
  attention calls count by kind in ``ops.attention.attention``
  (``frequency_self``, ``cross``, ``pitch_self``, ``time_self``, 11 a
  forward, and ``plain`` for those off the fused route), the segments and
  their padded frames in ``models.hft.pad_segments`` (``segments``,
  ``padded_frames``);
- ``amt.lstm.backward``: the backward of the differentiable recurrences
  (kernel F, dW_h and d(xw)), on autograd's thread;
- ``amt.decode``: the serving pipelines' device decode after the model's
  forward (sigmoid and threshold, or the argmax and local one-hot, then
  ``notes_on_device``; or the regression decode's device stage);
- ``amt.serving.decode_host``: ``finalize``'s host decode of a batch,
  after its wait for the device, re-decodes after an overflow included;
- ``amt.train.forward``: the train step's forward and losses
  (``run_on_batch``), once a microbatch.
"""

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .ops import cuda_build

__all__ = ['span', 'trace', 'StageTimer', 'block_and_time', 'peak_flops',
           'compiled_flops', 'mfu', 'compiled_cost', 'peak_hbm_bw']

# Published dense peaks (NVIDIA's data sheet, SXM part, at 700 W): FLOP/s
# by dtype ('float32' outside the tensor cores, the rate float32 convs and
# matmuls run at with TF32 off) and HBM bytes/s, by device name
_PEAKS = {
    'H100 80GB HBM3': ({'bf16': 989e12, 'fp16': 989e12, 'tf32': 495e12,
                        'float32': 67e12, 'int8': 1979e12, 'fp8': 1979e12},
                       3.35e12),
}

_DTYPE_NAMES = {torch.bfloat16: 'bf16', 'bfloat16': 'bf16',
                torch.float16: 'fp16', 'float16': 'fp16',
                torch.float32: 'float32', 'fp32': 'float32',
                torch.int8: 'int8'}


# The one context every span gives while no profiler records
_NO_SPAN = contextlib.nullcontext()


def span(name):
    """The port's range named ``name`` around a block: a
    ``torch.profiler.record_function`` while a profiler records, else one
    shared ``nullcontext`` (no RecordFunction is made, so nothing of it
    reaches ``torch.export``).

    Usage::

        with profiling.span('amt.features'):
            ...
    """

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)

    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace into ``log_dir`` (a
    ``*.pt.trace.json`` TensorBoard's profiler plugin reads), the card's
    kernels included where CUDA is available; yields the profiler.

    The trace holds the port's spans (:func:`span`) beside the host's
    calls and the device's kernels.

    Usage::

        with profiling.trace('/tmp/torch-trace'):
            train_step(batch, generator)
    """

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof
        _synchronize()


def _synchronize():
    """Wait for the card's queued work, where CUDA is in use."""

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def block_and_time(fn, *args, repeats=1, **kwargs):
    """Run a function, forcing device completion; returns (result, best_secs)."""

    result = None
    best = float('inf')
    _synchronize()
    for _ in range(max(1, repeats)):
        start = time.perf_counter()
        result = fn(*args, **kwargs)
        _synchronize()
        best = min(best, time.perf_counter() - start)

    return result, best


class StageTimer(object):
    """Accumulate wall-clock timings per named pipeline stage.

    Usage::

        timer = StageTimer()
        with timer('features'):
            feats = mel.process(audio)
        with timer('forward'):
            ...
        print(timer.report())
    """

    def __init__(self, sync=True):
        self.sync = sync
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, stage):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                # Wait for the stage's device work so it is charged
                _synchronize()
            self.times[stage].append(time.perf_counter() - start)

    def report(self):
        """Human-readable per-stage summary (total / mean / count)."""

        lines = []
        for stage, samples in self.times.items():
            arr = np.asarray(samples)
            lines.append(f'{stage:24s} total {arr.sum():8.4f}s  '
                         f'mean {arr.mean():8.4f}s  n={len(arr)}')

        return '\n'.join(lines)

    def totals(self):
        """Dict of per-stage total seconds."""

        return {stage: float(np.sum(samples))
                for stage, samples in self.times.items()}


def _peaks(device):
    """The table's entry for ``device`` (the current card when None), or
    None for the CPU and an unknown card."""

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    elif torch.device(device).type != 'cuda':
        return None

    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks

    return None


def peak_flops(device=None, dtype='bf16'):
    """Peak dense FLOP/s of a card in ``dtype`` (0.0 if unknown, and on the
    CPU); the MFU denominator.

    ``dtype`` is ``'bf16'`` (default), ``'fp16'``, ``'tf32'``, ``'float32'``
    (outside the tensor cores: the rate of float32 convs and matmuls under
    ``tools.use_exact_fp32``), ``'int8'`` or ``'fp8'``, or a torch dtype.
    """

    peaks = _peaks(device)
    if peaks is None:
        return 0.0

    return peaks[0].get(_DTYPE_NAMES.get(dtype, dtype), 0.0)


def peak_hbm_bw(device=None):
    """Published HBM bandwidth of a card in bytes/s (0.0 if unknown, and on
    the CPU)."""

    peaks = _peaks(device)

    return 0.0 if peaks is None else peaks[1]


def compiled_flops(fn, *args, **kwargs):
    """FLOPs of one call of ``fn``, counted by ``FlopCounterMode`` over one
    eager run (so it also runs ``fn`` once): the convolutions and matmuls
    it knows, and kernels A-F by their ops' formulas. Combine with a
    measured time and :func:`peak_flops` for MFU::

        flops = profiling.compiled_flops(step, batch, generator)
        _, secs = profiling.block_and_time(step, batch, generator, repeats=5)
        mfu = flops / secs / profiling.peak_flops()
    """

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
        _synchronize()

    return float(counter.get_total_flops())


def _nbytes(tensors):
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            seen[id(t)] = t.numel() * t.element_size()

    return sum(seen.values())


class _BytesMode(TorchDispatchMode):
    """Sums the bytes each dispatched op moves: its cost function's for
    kernels A-F, else its tensor inputs read and outputs written once;
    views and allocations move none."""

    _FREE = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default}

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cost = cuda_build.OP_COSTS.get(func.overloadpacket)
        if cost is not None:
            self.bytes += cost(*args, **kwargs)[1]
        elif not (func.is_view or func in self._FREE):
            self.bytes += (_nbytes(tree_leaves((args, kwargs))) +
                           _nbytes(tree_leaves(out)))

        return out


def compiled_cost(fn, *args, **kwargs):
    """FLOPs and bytes of one call of ``fn``: ``(flops, bytes_accessed)``.

    The FLOPs are :func:`compiled_flops`'s. The bytes are the sum over
    every dispatched op of what it reads and writes: kernels A-F count
    their own (the bytes of their cost functions), any other op its tensor
    inputs and outputs once each. This is not XLA's fused count: an
    elementwise chain that XLA fuses into one pass counts here once per op,
    as the eager port runs it. Dividing by a measured time and
    :func:`peak_hbm_bw` says how close the run is to the memory bound.
    """

    with FlopCounterMode(display=False) as counter, _BytesMode() as moved:
        fn(*args, **kwargs)
        _synchronize()

    return float(counter.get_total_flops()), float(moved.bytes)


def mfu(fn, *args, repeats=5, device=None, peak_dtype='bf16', **kwargs):
    """Measured model FLOPs utilization of a callable.

    Returns ``(mfu_fraction, achieved_flops_per_sec, seconds_per_call)``,
    the FLOPs counted by :func:`compiled_flops` (which also warms the call
    up) and the best of ``repeats`` synchronized calls, against the card's
    peak in ``peak_dtype``; ``mfu_fraction`` is 0.0 when that peak is
    unknown (the CPU).
    """

    flops = compiled_flops(fn, *args, **kwargs)
    _, secs = block_and_time(fn, *args, repeats=repeats, **kwargs)

    achieved = flops / secs
    peak = peak_flops(device, peak_dtype)

    return (achieved / peak if peak else 0.0), achieved, secs
