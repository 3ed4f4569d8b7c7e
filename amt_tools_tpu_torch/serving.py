"""Production serving: audio batches in, per-clip notes out.

Counterpart of ``amt_tools_tpu/serving.py``: :func:`calibrate_activity`
(``:71``), ``_ServingPipeline`` (``:167``) with its asynchronous
dispatch/finalize protocol and overflow re-decode (``:288``), and
:class:`TranscriptionPipeline` (``:312``). One dispatch runs feature
extraction (the STFT kernel), the model forward (the LSTM kernel), the
sigmoid threshold and the full note decode on the device; the host gets
four fixed-capacity int32 buffers per batch.

:meth:`dispatch` never waits for the device: it enqueues the work and the
copy of the buffers into pinned host memory, and returns. Dispatching batch
n+1 before finalizing batch n overlaps the host's decode with the device.
"""

import numpy as np
import torch

from . import tools
from .ops import decode

__all__ = ['TranscriptionPipeline', 'calibrate_activity']


def _as_audio(audio, device):
    """(B, N) or (N,) float32 audio -> a (B, N) tensor on ``device``.

    Host arrays go through pinned memory with a non-blocking copy, so the
    upload does not wait for work already queued on the device.
    """

    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.ascontiguousarray(audio, dtype=np.float32))
        if device.type == 'cuda':
            audio = audio.pin_memory()

    audio = audio.to(device, dtype=torch.float32, non_blocking=True)

    return audio[None] if audio.dim() == 1 else audio


def _forward(model, data_proc, audio):
    """Raw model logits for an audio batch (inference).

    The callers have turned TF32 off (:func:`tools.use_exact_fp32`), so the
    float32 path computes in IEEE fp32 as the JAX reference does.
    """

    with torch.inference_mode():
        feats = data_proc.process(audio)
        batch = model.pre_proc({tools.KEY_FEATS: feats})
        return model(batch[tools.KEY_FEATS])


def calibrate_activity(model, data_proc, audio,
                       rates=((tools.KEY_MULTIPITCH, 'adjoin_out', 0.03),
                              (tools.KEY_ONSETS, 'onset_out', 0.001)),
                       device=None):
    """Shift output-head biases so activation rates match a trained model.

    Demo/benchmark utility: with random weights the sparse-activity bias
    prior keeps every output silent. This runs one forward pass on a probe
    batch, takes each head's logit quantile (linear interpolation, as
    ``jnp.quantile``) and subtracts it from that head's ``Dense_0`` bias in
    place, so the requested fraction of cells clears the 0.5 threshold.
    ``torch.quantile`` takes at most 16M values: probe with a few clips.

    ``rates``: (output key, head module name, target rate) triples. Moves
    the model to ``device`` (CUDA unless given) and returns the shifts.
    Turns TF32 off for the process (:func:`tools.use_exact_fp32`).
    """

    device = tools.resolve_device(device)
    tools.use_exact_fp32()
    model = model.to(device).eval()

    raw = _forward(model, data_proc, _as_audio(audio, device))

    shifts = {}
    with torch.no_grad():
        for key, head, rate in rates:
            shift = torch.quantile(raw[key].float().flatten(), 1.0 - rate)
            getattr(model, head).Dense_0.bias -= shift
            shifts[head] = float(shift)

    return shifts


class _ServingPipeline:
    """Shared serving machinery: per-length frame-time cache and the
    asynchronous dispatch/finalize protocol. Subclasses provide
    ``_decode(audio, capacity)`` (the device function) and
    ``_finalize_clip`` (host decode of one clip's buffers)."""

    def __init__(self, model, data_proc, capacity, device=None):
        self.device = tools.resolve_device(device)
        tools.use_exact_fp32()
        self.model = model.to(self.device).eval()
        self.data_proc = data_proc
        self.capacity = capacity
        self.profile = model.profile
        self._times_cache = {}

    def _decode(self, audio, capacity):
        raise NotImplementedError

    def _finalize_clip(self, arrays, b, times):
        raise NotImplementedError

    def _times_for(self, num_samples):
        """Frame times depend only on the clip length; cache (16 lengths)."""

        if num_samples not in self._times_cache:
            if len(self._times_cache) >= 16:
                self._times_cache.pop(next(iter(self._times_cache)))
            self._times_cache[num_samples] = self.data_proc.get_times(
                np.zeros(num_samples, dtype=np.float32))

        return self._times_cache[num_samples]

    def _to_host(self, buffers):
        """Start copying device buffers into pinned host memory.

        Returns the host tensors and an event that completes with the copy
        (None on the CPU, where the buffers already are host memory).
        """

        if self.device.type != 'cuda':
            return buffers, None

        host = tuple(torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                     .copy_(b, non_blocking=True) for b in buffers)
        done = torch.cuda.Event()
        done.record()

        return host, done

    def dispatch(self, audio):
        """Start the device computation for one (B, N) audio batch.

        Returns an opaque handle for :meth:`finalize` without waiting for
        the device. Host arrays are uploaded; tensors already on the
        pipeline's device are used in place.
        """

        audio = _as_audio(audio, self.device)
        times = self._times_for(audio.shape[-1])

        host, done = self._to_host(self._decode(audio, self.capacity))

        return host, done, times, audio

    def finalize(self, handle):
        """Wait for a :meth:`dispatch` handle -> per-clip decoded notes.

        Clips whose true note count exceeds ``capacity`` are decoded again
        at a sufficient capacity (the device reports the exact count, so one
        retry always completes) instead of losing notes.
        """

        host, done, times, audio = handle
        if done is not None:
            done.synchronize()
        arrays = tuple(h.numpy() for h in host)
        counts = arrays[-1]

        groups = []
        for b in range(counts.shape[0]):
            needed = int(np.max(counts[b]))
            if needed > self.capacity:
                groups.append(self._redecode_overflow(audio[b], needed, times))
            else:
                groups.append(self._finalize_clip(arrays, b, times))

        return groups

    def _redecode_overflow(self, clip, count, times):
        """Re-run one clip at a capacity that fits its true note count
        (a multiple of 1024, at least twice the default)."""

        capacity = max(2 * self.capacity, -(-count // 1024) * 1024)
        buffers = self._decode(clip[None], capacity)
        arrays = tuple(b.cpu().numpy() for b in buffers)

        return self._finalize_clip(arrays, 0, times)

    def __call__(self, audio):
        """Synchronous convenience: dispatch + finalize one batch."""

        return self.finalize(self.dispatch(audio))


class TranscriptionPipeline(_ServingPipeline):
    """Audio batches in, per-clip ``(pitches, intervals)`` notes out.

    Parameters
    ----------
    model : TranscriptionModel
        A model whose raw outputs include multi-pitch (and optionally
        onset) logits, e.g. ``OnsetsFrames2``; moved to ``device``.
    data_proc : FeatureModule
        Feature extraction run on the device via ``process``.
    capacity : int
        Maximum notes decoded per clip before a re-decode retry.
    threshold : float
        Sigmoid threshold for activation maps.
    use_onsets : bool
        Gate note starts with the model's onset head when available.
    device : str or torch.device, optional
        Where the pipeline runs: CUDA unless given; without a CUDA device
        and without ``device='cpu'`` construction raises.

    Construction turns TF32 off for the process (:func:`tools.use_exact_fp32`),
    so a float32 pipeline computes in IEEE fp32 as the JAX reference does.
    """

    def __init__(self, model, data_proc, capacity=2048, threshold=0.5,
                 use_onsets=True, device=None):
        self.threshold = threshold
        self.use_onsets = use_onsets
        super().__init__(model, data_proc, capacity, device=device)

    def _decode(self, audio, capacity):
        raw = _forward(self.model, self.data_proc, audio)

        with torch.inference_mode():
            # Sigmoid and threshold in the logits' dtype (bf16 when serving
            # in bf16), as the JAX pipeline does
            multi_pitch = decode.threshold(
                decode.sigmoid(raw[tools.KEY_MULTIPITCH].transpose(-1, -2)),
                self.threshold)

            onsets = None
            if self.use_onsets and tools.KEY_ONSETS in raw:
                onsets = decode.threshold(
                    decode.sigmoid(raw[tools.KEY_ONSETS].transpose(-1, -2)),
                    self.threshold)

            return decode.notes_on_device(multi_pitch, onsets,
                                          capacity=capacity)

    def _finalize_clip(self, arrays, b, times):
        rows, on, off, counts = arrays

        return decode.notes_from_device(rows[b], on[b], off[b], counts[b],
                                        times, self.profile)
