"""Production serving: audio batches in, per-clip notes out.

Counterpart of ``amt_tools_tpu/serving.py``: :func:`calibrate_quant_stats`
(``:32``), :func:`calibrate_activity` (``:71``),
:func:`calibrate_tablature_activity` (``:116``), ``_ServingPipeline``
(``:167``) with its check of static int8 scales at construction
(``:184-189``), its asynchronous dispatch/finalize protocol and overflow
re-decode (``:265-301``), :class:`TranscriptionPipeline`
(``:312``) and :class:`TablaturePipeline` (``:378``). One piano dispatch
runs feature extraction (the STFT kernel), the model forward (the LSTM
kernel), the sigmoid threshold and the full note decode on the device; one
guitar dispatch runs the CQT (kernel C or D), TabCNN, the per-string argmax
and the per-string note decode. The host gets four fixed-capacity int32
buffers per batch. :class:`RegressionPipeline` serves the High-resolution
Piano Transcription model (``models.RegressCRNN``) and hFT-Transformer
(``models.HFTransformer``), which the JAX package lacks: its dispatch runs
the features, the model (kernel G for the GRUs, fused attention for the
transformer) and the regression decode's device stage (``decode.
regression_events_on_device``); its host stage assembles each clip's notes
from the compacted events. :class:`Seq2SeqPipeline` serves MT3's piano
transcriber (``models.Seq2SeqTranscriber``): its dispatch cuts each clip
into the model's segments and runs their features and the greedy decode;
its host stage decodes each segment's tokens to notes
(``tools.event_codec``).

:meth:`dispatch` never waits for the device: it enqueues the work and the
copy of the buffers into pinned host memory, and returns. Dispatching batch
n+1 before finalizing batch n overlaps the host's decode with the device.

With a ``mesh`` (``parallel.get_mesh``; JAX ``:176-193``) every rank
builds the same pipeline and is given the same batch: the model's weights
are rank 0's (``replicate``), each rank runs features, model and decode
on its clips of the batch (its rows; the batch must divide over the
``data`` dimension, as JAX requires), and :meth:`finalize` returns every
clip's notes,
in clip order, on every rank (``all_gather_object``; JAX returns them
from its one controller).

A pipeline counts what its host decode does, in integer attributes that
only grow: ``clips_decoded``, ``notes_decoded`` (the notes of those
clips; a tablature clip's over its strings) and ``redecodes``, the clips
whose notes overflowed ``capacity`` and were decoded again. With a mesh
each rank counts its own clips. A ``redecodes`` count above 0 means
``capacity`` is too small for the audio: each re-decode runs that clip's
whole forward again (features, model and device decode), one clip at a
time, inside :meth:`finalize`.

Under a profiler (``profiling.trace``) a batch shows the port's spans
(``profiling.span``): ``amt.features``, ``amt.acoustic``, ``amt.lstm``
(``amt.gru`` for the GRU layers, ``amt.transformer`` for a transformer
stack, ``amt.generate`` for a greedy decode) and ``amt.decode`` (the
device decode after the forward) inside
:meth:`dispatch`, and ``amt.serving.decode_host`` (the host decode of the
batch, re-decodes included) inside :meth:`finalize`, after its wait for
the device.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import profiling, tools
from .ops import decode
from .ops.qconv import int8_layers, validate_quant_stats
from .parallel.mesh import _axis, replicate
from .tools import event_codec

__all__ = ['TranscriptionPipeline', 'TablaturePipeline',
           'RegressionPipeline', 'Seq2SeqPipeline', 'calibrate_activity',
           'calibrate_tablature_activity', 'calibrate_quant_stats']


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


def calibrate_quant_stats(model, data_proc, audio_batches, device=None):
    """Fill the calibrated activation scales for static int8 serving.

    A model built with ``quant_acoustic='static'`` (or ``quant_lm``) reads
    one activation scale per int8 layer from its ``act_amax`` buffer. This
    runs the eval forward once per audio batch with every int8 layer
    calibrating: each folds the abs-max it sees into ``act_amax`` before it
    quantizes, so the scales are the running maximum over the batches (and
    over what the buffers held before). Mutates the model in place, moved
    to ``device`` (CUDA unless given), and returns the scales by layer name.

    Activations louder than the calibrated range saturate at the int8
    limit, so calibrate on audio at the loudness you serve.
    """

    device = tools.resolve_device(device)
    tools.use_exact_fp32()
    model = model.to(device).eval()
    if not isinstance(audio_batches, (list, tuple)):
        audio_batches = [audio_batches]

    layers = int8_layers(model)
    for _, layer in layers:
        layer.calibrating = True
    try:
        for audio in audio_batches:
            _forward(model, data_proc, _as_audio(audio, device))
    finally:
        for _, layer in layers:
            layer.calibrating = False

    return {name: float(layer.act_amax) for name, layer in layers
            if layer.static_scale}


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


def calibrate_tablature_activity(model, data_proc, audio, rate=0.05,
                                 device=None):
    """Shift the silence-class biases so string activity is trained-like.

    Demo/benchmark utility, the tablature counterpart of
    :func:`calibrate_activity`: an untrained ``SoftmaxGroups`` head argmaxes
    to an arbitrary class per (string, frame). This probes one forward
    pass, takes per string the margin of the best fret logit over the
    silence logit (in the logits' dtype), and raises that string's
    silence-class bias of ``tablature_out.Dense_0`` in place by the margin's
    ``1 - rate`` quantile (linear interpolation, as ``jnp.quantile``), so
    about ``rate`` of (string, frame) cells decode to a fret.

    Moves the model to ``device`` (CUDA unless given) and returns the
    per-string shifts as a float32 numpy array. Turns TF32 off for the
    process (:func:`tools.use_exact_fp32`).
    """

    device = tools.resolve_device(device)
    tools.use_exact_fp32()
    model = model.to(device).eval()
    num_groups, num_classes = model.num_groups, model.num_classes

    logits = _forward(model, data_proc, _as_audio(audio, device))[
        tools.KEY_TABLATURE]

    with torch.no_grad():
        logits = logits.reshape(logits.shape[:-1] + (num_groups, num_classes))
        # Margin of the best fret over silence (last class), per string
        margin = torch.amax(logits[..., :-1], dim=-1) - logits[..., -1]
        shifts = torch.quantile(margin.reshape(-1, num_groups).float(),
                                1.0 - rate, dim=0)

        bias = model.tablature_out.Dense_0.bias
        silence = torch.arange(num_groups, device=device) * num_classes + (
            num_classes - 1)
        bias[silence] += shifts

    return shifts.cpu().numpy()


class _ServingPipeline:
    """Shared serving machinery: per-length frame-time cache and the
    asynchronous dispatch/finalize protocol. Subclasses provide
    ``_decode(audio, capacity)`` (the device function) and
    ``_finalize_clip`` (host decode of one clip's buffers).

    A model with static int8 layers must carry calibrated scales
    (:func:`calibrate_quant_stats`): construction raises otherwise, since
    zero scales would decode garbage. With a ``mesh`` each rank serves its
    clips of every batch and gathers the notes (the module docstring)."""

    def __init__(self, model, data_proc, capacity, device=None, mesh=None):
        if 'static' in (model.quant_acoustic, model.quant_lm):
            validate_quant_stats(model, type(self).__name__)

        self.device = tools.resolve_device(device)
        tools.use_exact_fp32()
        self.model = model.to(self.device).eval()
        self.data_proc = data_proc
        self.capacity = capacity
        self.profile = model.profile
        self.mesh = mesh
        self._times_cache = {}
        # The host decode's counts (the module docstring)
        self.clips_decoded = 0
        self.notes_decoded = 0
        self.redecodes = 0
        if mesh is not None:
            replicate(self.model, mesh)

    def _decode(self, audio, capacity):
        raise NotImplementedError

    def _finalize_clip(self, arrays, b, times):
        raise NotImplementedError

    def _notes_in(self, counts):
        """The notes of one clip's counts (all within its capacity)."""

        return int(np.sum(counts))

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

        if self.mesh is not None:
            audio = self._rows(audio)
        audio = _as_audio(audio, self.device)
        times = self._times_for(audio.shape[-1])

        host, done = self._to_host(self._decode(audio, self.capacity))

        return host, done, times, audio

    def _rows(self, audio):
        """This rank's clips of a (B, N) batch; B must divide the ``data``
        dimension (JAX's ``device_put`` raises likewise)."""

        _, size, index = _axis(self.mesh, 'data')
        if audio.ndim == 1:
            audio = audio[None]
        if audio.shape[0] % size:
            raise ValueError(f'a batch of {audio.shape[0]} clips does not '
                             f'divide over {size} ranks of the mesh\'s '
                             f'"data" dimension')
        rows = audio.shape[0] // size

        return audio[index * rows:(index + 1) * rows]

    def finalize(self, handle):
        """Wait for a :meth:`dispatch` handle -> per-clip decoded notes.

        Clips whose true note count exceeds ``capacity`` are decoded again
        at a sufficient capacity (the device reports the exact count, so one
        retry always completes) instead of losing notes. With a mesh every
        rank returns every clip's notes, in clip order.
        """

        host, done, times, audio = handle
        if done is not None:
            done.synchronize()
        arrays = tuple(h.numpy() for h in host)

        with profiling.span('amt.serving.decode_host'):
            groups = self._finalize_batch(
                arrays, times,
                lambda b, capacity: self._decode(audio[b][None], capacity))
        if self.mesh is None:
            return groups

        group, size, _ = _axis(self.mesh, 'data')
        gathered = [None] * size
        dist.all_gather_object(gathered, groups, group=group)

        return [clip for part in gathered for clip in part]

    def _finalize_batch(self, arrays, times, redecode):
        """Per-clip results of one batch's host buffers.

        A clip whose true note count exceeds ``capacity`` is decoded again
        by ``redecode(b, capacity)`` at a capacity that fits it (a multiple
        of 1024, at least twice the default). Counts the clips, their notes
        and the re-decodes.
        """

        counts = arrays[-1]
        groups = []
        for b in range(counts.shape[0]):
            clip, row = arrays, b
            needed = int(np.max(counts[b]))
            if needed > self.capacity:
                capacity = max(2 * self.capacity, -(-needed // 1024) * 1024)
                clip = tuple(x.cpu().numpy() for x in redecode(b, capacity))
                row = 0
                self.redecodes += 1
            groups.append(self._finalize_clip(clip, row, times))
            # Every count fits the capacity the clip was decoded at
            self.notes_decoded += self._notes_in(clip[-1][row])
        self.clips_decoded += counts.shape[0]

        return groups

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
    mesh : DeviceMesh, optional
        Data-parallel serving over the mesh's ``data`` dimension (the
        module docstring); the batch must divide over it.

    Construction turns TF32 off for the process (:func:`tools.use_exact_fp32`),
    so a float32 pipeline computes in IEEE fp32 as the JAX reference does.
    """

    def __init__(self, model, data_proc, capacity=2048, threshold=0.5,
                 use_onsets=True, device=None, mesh=None):
        self.threshold = threshold
        self.use_onsets = use_onsets
        super().__init__(model, data_proc, capacity, device=device, mesh=mesh)

    def _decode(self, audio, capacity):
        raw = _forward(self.model, self.data_proc, audio)

        with torch.inference_mode(), profiling.span('amt.decode'):
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


class TablaturePipeline(_ServingPipeline):
    """Audio batches in, per-clip stacked notes ``{string: (pitches,
    intervals)}`` out.

    The guitar serving path: CQT features, the TabCNN forward, per-string
    softmax argmax to class ids, a LOCAL fret one-hot per string
    (``decode.tablature_to_local_multi_pitch``: 20 rows per string on a
    19-fret guitar instead of the 44-pitch range) and the note decode of
    each string's map, all on the device. The host maps fret rows back to
    MIDI with the string's tuning. Semantics per clip match the JAX
    pipeline: onsets from pitch-activity edges, no inhibition window, no
    duration filter.

    Parameters
    ----------
    model : TabCNN
        A model whose raw output carries ``KEY_TABLATURE`` logits decoded by
        its ``tablature_out`` ``SoftmaxGroups`` head (last class silence).
    data_proc : FeatureModule
        Feature extraction run on the device via ``process``.
    capacity : int
        Maximum notes decoded per STRING per clip before a re-decode retry.
    device : str or torch.device, optional
        Where the pipeline runs: CUDA unless given; without a CUDA device
        and without ``device='cpu'`` construction raises.
    mesh : DeviceMesh, optional
        Data-parallel serving over the mesh's ``data`` dimension.

    Construction turns TF32 off for the process (:func:`tools.use_exact_fp32`).
    """

    def __init__(self, model, data_proc, capacity=512, device=None,
                 mesh=None):
        super().__init__(model, data_proc, capacity, device=device, mesh=mesh)

    def _decode_stage(self, tablature, capacity):
        """(B, S, T) class ids -> (B, S, capacity) note buffers and (B, S)
        counts, in local fret rows."""

        with torch.inference_mode():
            local = decode.tablature_to_local_multi_pitch(
                tablature, self.model.num_classes - 1)  # drop silence

            return decode.notes_on_device(local, None, capacity=capacity)

    def _decode(self, audio, capacity):
        raw = _forward(self.model, self.data_proc, audio)

        with profiling.span('amt.decode'):
            with torch.inference_mode():
                tablature = self.model.tablature_out.finalize_output(
                    raw[tools.KEY_TABLATURE])

            return self._decode_stage(tablature, capacity)

    def decode_tablature(self, tablature, times):
        """Decode pre-computed (B, S, T) tablature through the pipeline's
        device decode stage -> per-clip stacked notes.

        Overflowing clips re-decode at a sufficient capacity from the same
        tablature (no forward re-run).
        """

        tablature = torch.as_tensor(tablature, device=self.device)
        arrays = tuple(b.cpu().numpy()
                       for b in self._decode_stage(tablature, self.capacity))

        return self._finalize_batch(
            arrays, times,
            lambda b, capacity: self._decode_stage(tablature[b][None],
                                                   capacity))

    def _finalize_clip(self, arrays, b, times):
        rows, on, off, counts = arrays
        tuning = self.profile.get_midi_tuning()

        # Rows are local fret classes: row + the string's open tuning is the
        # MIDI pitch
        return {slc: decode.notes_from_device(
                    rows[b, slc], on[b, slc], off[b, slc], counts[b, slc],
                    times, self.profile, low=int(tuning[slc]))
                for slc in range(counts.shape[1])}


class RegressionPipeline(_ServingPipeline):
    """Audio batches in, per-clip ``(pitches, intervals, velocities)`` notes
    out, from the onset and offset curves of a note model: the regressed
    onset and offset times of the High-resolution Piano Transcription model
    (the published ``RegressionPostProcessor``'s notes; the pedal model is
    a separate network and not served), or heads B of hFT-Transformer.

    One dispatch runs the features, the model's forward and, inside
    ``amt.decode``, the sigmoids of its frame, onset and offset heads, the
    velocity levels and ``decode.regression_events_on_device``: the onset
    and offset peaks with their shifts, the onsets' velocities and the
    frame curve's first drop after each onset, compacted into buffers of
    ``capacity`` events a clip. :meth:`finalize` assembles each clip's
    notes on the host (``decode.regression_notes_from_device``); a clip
    with more onset or offset peaks than ``capacity`` is decoded again at a
    capacity that fits.

    Parameters
    ----------
    model : RegressCRNN or HFTransformer
        Moved to ``device``; its forward returns the ``frame``,
        ``reg_onset``, ``reg_offset`` and ``velocity`` logits, (B, T, K)
        each, or ``velocity`` as (B, T, K, C) class logits.
    data_proc : FeatureModule
        Feature extraction run on the device via ``process`` (``MelSpec``
        with ``absolute_db`` for the High-resolution model, with
        ``log_offset`` for hFT-Transformer).
    capacity : int
        Onset (and offset) peaks a clip before a re-decode.
    device : str or torch.device, optional
        Where the pipeline runs: CUDA unless given.
    mesh : DeviceMesh, optional
        Data-parallel serving over the mesh's ``data`` dimension.
    onset_threshold, offset_threshold, frame_threshold : float
        The decode's thresholds on the sigmoids: the defaults are the High-
        resolution model's published 0.3, 0.3 and 0.1.

    A note closes at most 600 frames after its onset (the published rule).
    A velocity curve gives ``int(velocity * 128)``, the published levels;
    class logits give their argmax class.
    """

    def __init__(self, model, data_proc, capacity=2048, device=None,
                 mesh=None, onset_threshold=0.3, offset_threshold=0.3,
                 frame_threshold=0.1):
        super().__init__(model, data_proc, capacity, device=device, mesh=mesh)
        self.thresholds = {'onset_threshold': onset_threshold,
                           'offset_threshold': offset_threshold,
                           'frame_threshold': frame_threshold}

    def _decode(self, audio, capacity):
        raw = _forward(self.model, self.data_proc, audio)

        with torch.inference_mode(), profiling.span('amt.decode'):
            # The sigmoid in the logits' dtype, compared in float32
            curves = {key: torch.sigmoid(raw[key]).float().transpose(-1, -2)
                      for key in ('frame', 'reg_onset', 'reg_offset')}
            # The velocity levels: the argmax class of class logits, or a
            # curve times 128 (exact in float32: a power of two)
            velocity = raw['velocity']
            levels = (velocity.argmax(-1).float() if velocity.dim() == 4 else
                      torch.sigmoid(velocity).float() * 128.0)

            return decode.regression_events_on_device(
                curves['frame'], curves['reg_onset'], curves['reg_offset'],
                levels.transpose(-1, -2), capacity, **self.thresholds)

    def _finalize_clip(self, arrays, b, times):
        return decode.regression_notes_from_device(
            *(x[b] for x in arrays), num_frames=len(times),
            frame_seconds=(self.data_proc.hop_length /
                           self.data_proc.sample_rate),
            low=self.profile.low, velocity_scale=1)

    def _notes_in(self, counts):
        # One note an onset peak
        return int(counts[0])


class Seq2SeqPipeline(_ServingPipeline):
    """Audio batches in, per-clip ``(pitches, intervals, velocities)``
    notes out, from the tokens of a sequence-to-sequence transcriber (MT3's
    piano model, ``models.Seq2SeqTranscriber``).

    One dispatch cuts each (B, N) clip into S = ceil(N / segment) segments
    of the model's input length (512 frames of the features' hop: 4.096 s
    at MT3's settings), the last zero-padded, computes their features and
    runs the model's forward, greedy decoding of at most ``capacity``
    tokens a segment, every segment of the batch at once; the tokens are
    copied to pinned host memory without a wait. :meth:`finalize` decodes
    each segment's tokens to notes from the segment's start
    (``tools.event_codec.decode_rows``) and returns each clip's notes,
    sorted by onset, then pitch.

    Parameters
    ----------
    model : Seq2SeqTranscriber
        Moved to ``device``; ``model.encoder`` takes ``input_length``
        frames a segment.
    data_proc : MelSpec
        Feature extraction run on the device via ``process`` (MT3's:
        ``magnitude``, ``filterbank='tf'``, ``pad_end``, ``log_floor``).
    capacity : int
        Tokens a segment: the decode's cap.
    input_length : int
        Feature frames a segment.
    device : str or torch.device, optional
        Where the pipeline runs: CUDA unless given.

    Beside the counts of every pipeline it counts ``segments`` (dispatched),
    ``decode_steps`` (the decode loops' steps), ``rows_ended`` (segments
    whose tokens hold an EOS, so that they ended before the cap) and
    ``tokens_invalid`` (tokens the host decode skipped or dropped).
    """

    def __init__(self, model, data_proc, capacity=1024, input_length=512,
                 device=None):
        super().__init__(model, data_proc, capacity, device=device)
        self.segment_samples = input_length * data_proc.hop_length
        self.segment_seconds = self.segment_samples / data_proc.sample_rate
        self.segments = 0
        self.decode_steps = 0
        self.rows_ended = 0
        self.tokens_invalid = 0

    def _times_for(self, num_samples):
        """A clip's segment start times, in seconds."""

        segments = max(1, -(-num_samples // self.segment_samples))

        return np.arange(segments) * self.segment_seconds

    def _decode(self, audio, capacity):
        clips, num_samples = audio.shape
        segments = len(self._times_for(num_samples))
        audio = F.pad(audio, (0, segments * self.segment_samples -
                              num_samples)).view(-1, self.segment_samples)
        with torch.inference_mode():
            tokens = self.model(self.data_proc.process(audio), capacity)
        self.segments += audio.shape[0]
        self.decode_steps += tokens.shape[1]

        return (tokens.to(torch.int32),)

    def _finalize_batch(self, arrays, times, redecode):
        tokens = arrays[0]
        segments = len(times)
        clips = tokens.shape[0] // segments
        rows, pitches, onsets, offsets, velocities, invalid = \
            event_codec.decode_rows(tokens, np.tile(times, clips),
                                    self.segment_seconds)
        self.rows_ended += int((tokens == event_codec.EOS).any(axis=1).sum())
        self.tokens_invalid += invalid

        bounds = np.searchsorted(rows // segments, np.arange(clips + 1))
        groups = []
        for c in range(clips):
            part = slice(bounds[c], bounds[c + 1])
            order = np.lexsort((pitches[part], onsets[part]))
            groups.append((pitches[part][order],
                           np.stack([onsets[part][order],
                                     offsets[part][order]], axis=-1),
                           velocities[part][order]))
        self.clips_decoded += clips
        self.notes_decoded += len(rows)

        return groups
