"""Deployment artifacts for the serving and streaming paths (``torch.export``).

Counterpart of ``amt_tools_tpu/export.py`` (``export_serving``,
``save_serving``, ``load_serving``, ``ServingArtifact``,
``export_streaming``, ``load_streaming``, ``StreamingArtifact``), with its
zip layout and metadata keys: ``meta.json``, ``times.npy`` (serving),
``module.bin`` and ``init.bin`` (streaming). Each module is the bytes of
``torch.export.save`` of an ``ExportedProgram``:

- serving: ``TranscriptionPipeline._decode`` at the pipeline's capacity,
  audio (B, N) -> the four note buffers, with the weights, the mel bank and
  the decode frozen in; :meth:`ServingArtifact.finalize` is the host decode
  (``ops.decode.notes_from_device``);
- streaming: the step ``(carries, feats) -> (outputs, carries)`` of a
  carry-threading model (``pre_proc`` -> ``model(feats, carries=)`` ->
  ``post_proc``, with float32 carries), and a zero-argument carry
  initializer.

The batch is symbolic (``torch.export.Dim``) where the trace allows it;
otherwise the program is exported at the concrete ``batch_size``, with a
warning, and ``meta['symbolic_batch']`` says which.

The hand-written kernels A-F are custom ops of ``torch.ops.
amt_tools_tpu_torch``, so a loaded program calls them: loading imports
this package's ``ops`` first, and on the card the kernels build from
``csrc/`` at their first launch (an artifact needs this package, where
JAX's needs only ``jax`` and numpy). ``platforms`` is the device type the
program was exported on; a CUDA artifact loaded where there is no card
raises, and never runs on the CPU. Loading turns TF32 off
(``tools.use_exact_fp32``): the flags are no part of a program, and a
float32 artifact computes in IEEE float32 as the live pipeline does.
"""

import io
import json
import warnings
import zipfile

import numpy as np
import torch

from . import tools
from .ops import decode  # importing ops registers kernels A-F as ops
from .tools.instrument import InstrumentProfile

__all__ = ['export_serving', 'save_serving', 'load_serving',
           'ServingArtifact', 'export_streaming', 'load_streaming',
           'StreamingArtifact']

_META_NAME = 'meta.json'
_TIMES_NAME = 'times.npy'
_MODULE_NAME = 'module.bin'
_INIT_NAME = 'init.bin'


class _Serving(torch.nn.Module):
    """The pipeline's device function at its capacity, as a module."""

    def __init__(self, pipeline):
        super().__init__()
        self.pipeline = pipeline
        self.model = pipeline.model

    def forward(self, audio):
        return self.pipeline._decode(audio, self.pipeline.capacity)


class _StreamingStep(torch.nn.Module):
    """One streaming step: feature frames and carries in, thresholded
    activation maps and the next carries out."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, carries, feats):
        batch = self.model.pre_proc({tools.KEY_FEATS: feats})
        raw, new_carries = self.model(batch[tools.KEY_FEATS], carries=carries)
        out = self.model.post_proc({tools.KEY_OUTPUT: raw})

        return out, new_carries


class _StreamingInit(torch.nn.Module):
    def __init__(self, model, batch_size, device):
        super().__init__()
        self.model = model
        self.batch_size = batch_size
        self.device = device

    def forward(self):
        return self.model.init_carries(self.batch_size, self.device)


def _check_platforms(platforms, device):
    if platforms is not None and list(platforms) != [device.type]:
        raise ValueError(f'the program runs where it was exported, on '
                         f'{device.type}; got platforms {list(platforms)}')


def _save_program(program):
    buf = io.BytesIO()
    torch.export.save(program, buf)

    return buf.getvalue()


def _zip(meta, entries):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, 'w', zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_META_NAME, json.dumps(meta, indent=1))
        for name, data in entries.items():
            zf.writestr(name, data)

    return buf.getvalue()


def export_serving(pipeline, num_samples, batch_size=8, platforms=None):
    """Freeze a :class:`~amt_tools_tpu_torch.serving.TranscriptionPipeline`.

    Parameters
    ----------
    pipeline : TranscriptionPipeline
        The live pipeline; its model's weights are frozen into the artifact.
    num_samples : int
        Clip length in samples (static: the decode shapes depend on it).
    batch_size : int
        The example batch of the trace, and the fixed batch when a
        symbolic batch does not trace.
    platforms : sequence of str, optional
        Must name the pipeline's device type (``['cuda']`` or ``['cpu']``)
        where given: the program runs where it was exported.

    Returns
    -------
    bytes
        A zip container: the ``torch.export`` program + host metadata.
    """

    if getattr(pipeline, 'mesh', None) is not None:
        raise ValueError('cannot export a mesh-sharded pipeline: the '
                         'artifact would bake in this process\'s rank. '
                         'Export a single-device pipeline and shard batches '
                         'across loaded artifacts instead.')
    _check_platforms(platforms, pipeline.device)

    module = _Serving(pipeline)
    example = torch.zeros((batch_size, num_samples), dtype=torch.float32,
                          device=pipeline.device)

    symbolic = True
    with torch.no_grad():
        try:
            batch = torch.export.Dim('batch', min=1)
            program = torch.export.export(
                module, (example,), dynamic_shapes=({0: batch},),
                strict=False)
        except Exception as exc:  # a shape the trace cannot keep symbolic
            symbolic = False
            # If this ALSO fails, the problem is the pipeline itself, not the
            # symbolic batch: let that error surface with its own traceback
            program = torch.export.export(module, (example,), strict=False)
            warnings.warn(f'symbolic-batch export unavailable ({exc}); '
                          f'exported at fixed batch {batch_size}')

    # In the pipeline's own dtype, so the intervals are the live pipeline's
    times = np.asarray(pipeline._times_for(num_samples))
    hop = float(times[1] - times[0]) if len(times) > 1 else 0.0

    meta = {
        'format_version': 1,
        'kind': 'serving',
        'num_samples': int(num_samples),
        'symbolic_batch': symbolic,
        'batch_size': None if symbolic else int(batch_size),
        'capacity': int(pipeline.capacity),
        'profile_low': int(pipeline.profile.low),
        'profile_high': int(pipeline.profile.high),
        'hop_seconds': hop,
        'platforms': [pipeline.device.type],
    }

    times_io = io.BytesIO()
    np.save(times_io, times)

    return _zip(meta, {_TIMES_NAME: times_io.getvalue(),
                       _MODULE_NAME: _save_program(program)})


def save_serving(path, pipeline, num_samples, **kwargs):
    """``export_serving`` straight to a file; returns the metadata dict."""

    data = export_serving(pipeline, num_samples, **kwargs)
    with open(path, 'wb') as handle:
        handle.write(data)

    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        return json.loads(zf.read(_META_NAME))


def _device(meta):
    """The device an artifact runs on: its platform's (the current card
    for CUDA), or raise where that is not here."""

    platform = meta['platforms'][0]
    if platform == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('this artifact was exported for CUDA and no '
                               'CUDA device is available; it does not run '
                               'on the CPU')
        return torch.device('cuda', torch.cuda.current_device())

    return torch.device(platform)


class ServingArtifact:
    """A loaded deployment artifact: ``(B, N) audio -> per-clip notes``.

    The device computation is the loaded ``ExportedProgram`` (weights
    inside it); :meth:`finalize` is plain numpy over the O(capacity) note
    buffers.
    """

    def __init__(self, meta, times, program):
        self.meta = meta
        self.times = times
        self.device = _device(meta)
        self._module = program.module()

    @property
    def num_samples(self):
        return self.meta['num_samples']

    def __call__(self, audio):
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        if audio.dim() == 1:
            audio = audio[None]

        if audio.shape[-1] != self.num_samples:
            raise ValueError(f'artifact expects clips of '
                             f'{self.num_samples} samples, got '
                             f'{audio.shape[-1]}')
        fixed = self.meta['batch_size']
        if fixed is not None and audio.shape[0] != fixed:
            raise ValueError(f'artifact was exported at fixed batch size '
                             f'{fixed}, got {audio.shape[0]}')

        with torch.no_grad():
            buffers = self._module(audio.contiguous())

        return self.finalize(buffers)

    def finalize(self, buffers):
        """Device note buffers -> list of (pitches, intervals) per clip.

        Delegates to the one buffer decoder (``ops.decode.
        notes_from_device``) so the artifact path cannot drift from the
        live pipeline's; an overflow past the frozen capacity warns and
        truncates (re-export with a larger ``capacity`` for denser
        material: the live ``TranscriptionPipeline`` re-decodes instead,
        but an artifact's capacity is fixed at export time).
        """

        profile = InstrumentProfile(self.meta['profile_low'],
                                    self.meta['profile_high'])
        rows, on, off, counts = (tools.to_numpy(b) for b in buffers)

        return [decode.notes_from_device(rows[b], on[b], off[b], counts[b],
                                         self.times, profile)
                for b in range(rows.shape[0])]


def _read(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)

    with open(path_or_bytes, 'rb') as handle:
        return handle.read()


def _load_program(data):
    return torch.export.load(io.BytesIO(data))


def load_serving(path_or_bytes):
    """Load an artifact produced by :func:`export_serving` (TF32 off)."""

    data = _read(path_or_bytes)
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        meta = json.loads(zf.read(_META_NAME))
        _device(meta)
        tools.use_exact_fp32()
        times = np.load(io.BytesIO(zf.read(_TIMES_NAME)))
        program = _load_program(zf.read(_MODULE_NAME))

    return ServingArtifact(meta, times, program)


def export_streaming(model, batch_size=1, frames_per_chunk=1, platforms=None):
    """Freeze a carry-threading streaming model's step into an artifact.

    For models with the ``init_carries`` / ``forward(feats, carries=...)``
    streaming contract (``OnsetsFramesOnline``): exports two programs, a
    zero-argument carry initializer and the per-chunk step ``(carries,
    feats) -> (thresholded outputs, carries)`` with ``pre_proc`` and
    ``post_proc`` frozen in, on the device the model's weights are on. The
    port's model holds its weights, so there is no ``variables`` argument.
    The frozen step is the computation ``inference.run_online_stateful``
    drives live.
    """

    if not hasattr(model, 'init_carries'):
        raise TypeError(f'{type(model).__name__} has no init_carries: '
                        f'only carry-threading streaming models can be '
                        f'exported with export_streaming')

    device = next(model.parameters()).device
    _check_platforms(platforms, device)
    model.eval()

    feats = torch.zeros((batch_size, model.in_channels, model.dim_in,
                         frames_per_chunk), dtype=torch.float32,
                        device=device)
    with torch.no_grad():
        init = torch.export.export(
            _StreamingInit(model, batch_size, device), (), strict=False)
        step = torch.export.export(
            _StreamingStep(model),
            (model.init_carries(batch_size, device), feats), strict=False)

    meta = {
        'format_version': 1,
        'kind': 'streaming',
        'batch_size': int(batch_size),
        'frames_per_chunk': int(frames_per_chunk),
        'dim_in': int(model.dim_in),
        'in_channels': int(model.in_channels),
        'profile_low': int(model.profile.low),
        'profile_high': int(model.profile.high),
        'platforms': [device.type],
    }

    return _zip(meta, {_INIT_NAME: _save_program(init),
                       _MODULE_NAME: _save_program(step)})


class StreamingArtifact:
    """A loaded streaming artifact: feature chunks in, activation maps out.

    Usage::

        art = load_streaming('online.amtx')
        carries = art.init_carries()
        for chunk in feature_frames:          # (B, C, F, W) each
            outputs, carries = art.step(carries, chunk)
    """

    def __init__(self, meta, init_program, step_program):
        self.meta = meta
        self.device = _device(meta)
        self._init = init_program.module()
        self._step = step_program.module()

    def init_carries(self):
        with torch.no_grad():
            return self._init()

    def step(self, carries, feats):
        feats = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
        expected = (self.meta['batch_size'], self.meta['in_channels'],
                    self.meta['dim_in'], self.meta['frames_per_chunk'])
        if tuple(feats.shape) != expected:
            raise ValueError(f'artifact expects feature chunks of shape '
                             f'{expected}, got {tuple(feats.shape)}')

        with torch.no_grad():
            return self._step(carries, feats.contiguous())


def load_streaming(path_or_bytes):
    """Load an artifact produced by :func:`export_streaming` (TF32 off)."""

    data = _read(path_or_bytes)
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        meta = json.loads(zf.read(_META_NAME))
        _device(meta)
        tools.use_exact_fp32()
        init_program = _load_program(zf.read(_INIT_NAME))
        step_program = _load_program(zf.read(_MODULE_NAME))

    return StreamingArtifact(meta, init_program, step_program)
