"""Streaming against the JAX package on the CPU: the carried recurrence
(kernel B's plain version with an initial carry, ``FastLSTM(initial_carry,
return_carry)``), ``OnsetsFramesOnline`` whole and carried,
``run_online_stateful``, ``AudioStream`` and ``MicrophoneStream`` (with a
fake ``sounddevice``, as ``tests/test_microphone_stream.py``).

Tolerances:
- float32 LSTM outputs, carries and logits: 1e-5 absolute (float32
  products in another order over tens of steps);
- chunks that thread the carry against one whole call: bit for bit, in
  float32 and bf16 (the carry returned is the state the next step reads);
- thresholded maps and notes of ``run_online_stateful``: bit for bit;
- mel features of a stream frame: 1e-5 on the [0, 1] scale, against the
  JAX module's unbucketed ``process_jax`` (see
  ``test_audio_stream_frames_match_jax`` for why not its ``process_audio``,
  which differs by more than 4e-4 on a one-frame clip);
- microphone frames: bit for bit (the ring buffer holds the samples).
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.features import MelSpec as JaxMelSpec
from amt_tools_tpu.features import stream as jstream
from amt_tools_tpu.inference import run_online_stateful as jax_online_stateful
from amt_tools_tpu.models import OnsetsFramesOnline as JaxOnsetsFramesOnline
from amt_tools_tpu.ops.lstm import FastLSTM as JaxFastLSTM
from amt_tools_tpu.transcribe import (IterativeNoteTranscriber as
                                      JaxIterativeNoteTranscriber)

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.features import stream
from amt_tools_tpu_torch.inference import run_online_stateful
from amt_tools_tpu_torch.models import OnsetsFramesOnline
from amt_tools_tpu_torch.ops.lstm import FastLSTM
from amt_tools_tpu_torch.ops.lstm_kernel import lstm_scan, lstm_scan_plain
from amt_tools_tpu_torch.transcribe import IterativeNoteTranscriber
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

TOL = 1e-5
MEL_TOL = 4e-4
CHUNKS = (1, 7, 64)


def _flax_lstm(rng, batch=3, frames=20, dim_in=10, hidden=16):
    layer = JaxFastLSTM(features=hidden)
    x = rng.randn(batch, frames, dim_in).astype(np.float32)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    carry = (rng.randn(batch, hidden).astype(np.float32),
             np.tanh(rng.randn(batch, hidden)).astype(np.float32))
    port = FastLSTM(dim_in, hidden)
    port.load_state_dict(from_flax(variables))
    return layer, variables, port, x, carry


def test_carried_recurrence_matches_flax():
    layer, variables, port, x, carry = _flax_lstm(np.random.RandomState(0))

    (ref_c, ref_h), ref = layer.apply(
        variables, jnp.asarray(x),
        initial_carry=tuple(jnp.asarray(v) for v in carry),
        return_carry=True)
    with torch.no_grad():
        (c, h), out = port(torch.from_numpy(x),
                           initial_carry=tuple(map(torch.from_numpy, carry)),
                           return_carry=True)

    assert c.dtype == h.dtype == torch.float32
    for got, want in ((out, ref), (c, ref_c), (h, ref_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)

    # return_carry alone starts from zeros, as JAX's
    (ref_c, _), ref = layer.apply(variables, jnp.asarray(x),
                                  return_carry=True)
    with torch.no_grad():
        (c, _), out = port(torch.from_numpy(x), return_carry=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=0,
                               atol=TOL)


def _chunks(frames):
    bounds, start, k = [], 0, 0
    while start < frames:
        stop = min(frames, start + CHUNKS[k % len(CHUNKS)])
        bounds.append((start, stop))
        start, k = stop, k + 1
    return bounds


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_chunks_threading_the_carry_equal_one_call(dtype, reverse):
    """Chunks of 1, 7 and 64 frames in turn, each given the previous one's
    carry, equal one whole call bit for bit: outputs and final carry; and
    the carried call from zeros equals the uncarried one."""

    g = torch.Generator().manual_seed(1)
    frames, hidden = 2 * sum(CHUNKS), 32
    xw = (torch.randn(2, frames, 4 * hidden, generator=g) * 0.5).to(dtype)
    w_h = torch.nn.init.orthogonal_(torch.empty(hidden, 4 * hidden),
                                    generator=g).to(dtype)
    carry = (torch.randn(2, hidden, generator=g),
             torch.rand(2, hidden, generator=g) - 0.5)

    whole, (c, h) = lstm_scan(xw, w_h, reverse=reverse, initial_carry=carry,
                              return_carry=True)
    bounds = _chunks(frames)
    assert {b - a for a, b in bounds} == set(CHUNKS)

    pieces, state = {}, carry
    for start, stop in (reversed(bounds) if reverse else bounds):
        pieces[start], state = lstm_scan(
            xw[:, start:stop].contiguous(), w_h, reverse=reverse,
            initial_carry=state, return_carry=True)
    assert torch.equal(torch.cat([pieces[a] for a, _ in bounds], 1), whole)
    assert torch.equal(state[0], c) and torch.equal(state[1], h)
    # The returned h is what the next step reads: the last output widened
    assert torch.equal(h.to(dtype), whole[:, 0 if reverse else -1])

    zeros = tuple(torch.zeros_like(v) for v in carry)
    assert torch.equal(lstm_scan(xw, w_h, reverse=reverse,
                                 initial_carry=zeros),
                       lstm_scan_plain(xw, w_h, reverse=reverse))


@pytest.mark.parametrize('dtype', [None, torch.bfloat16])
def test_fast_lstm_frame_by_frame_equals_whole(dtype):
    """The layer fed one frame a call (the streaming path) against one
    whole call, bit for bit."""

    layer, variables, port, x, carry = _flax_lstm(np.random.RandomState(2),
                                                  frames=30)
    port.dtype = dtype
    x = torch.from_numpy(x)
    with torch.no_grad():
        whole_carry, whole = port(x, return_carry=True)
        state, outs = None, []
        for t in range(x.shape[1]):
            state, out = port(x[:, t: t + 1], initial_carry=state,
                              return_carry=True)
            outs.append(out)
    assert torch.equal(torch.cat(outs, 1), whole)
    assert all(torch.equal(a, b) for a, b in zip(state, whole_carry))

    # A carry while autograd records is refused (kernels E and F take none)
    with pytest.raises(NotImplementedError, match='carried training'):
        port(x, initial_carry=state)


def _online_pair(dim_in=32):
    jax_model = JaxOnsetsFramesOnline(dim_in=dim_in,
                                      profile=jtools.PianoProfile(),
                                      model_complexity=2)
    variables = jax_model.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, dim_in, 1)), carries=jax_model.init_carries(1))
    # A bias on the heads keeps some cells on, so the maps say something
    variables = jax.tree_util.tree_map(np.array, variables)
    variables['params']['adjoin_out']['Dense_0']['bias'] += 2.0
    variables['params']['onset_out']['Dense_0']['bias'] += 2.0
    model = OnsetsFramesOnline(dim_in=dim_in, profile=tools.PianoProfile(),
                               model_complexity=2)
    model.load_state_dict(from_flax(variables))
    return jax_model, variables, model.eval()


def test_online_model_whole_and_carried_match_flax():
    jax_model, variables, model = _online_pair()
    assert sorted(from_flax(variables)) == sorted(model.state_dict())
    feats = np.random.RandomState(3).rand(2, 1, 32, 9).astype(np.float32)

    jax_feats = jax_model.pre_proc({jtools.KEY_FEATS: jnp.asarray(feats)})[
        jtools.KEY_FEATS]
    port_feats = model.pre_proc({tools.KEY_FEATS: torch.from_numpy(feats)})[
        tools.KEY_FEATS]

    ref = jax_model.apply(variables, jax_feats)
    with torch.no_grad():
        got = model(port_feats)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=TOL, err_msg=key)

    # Carried, three frames a call
    jax_carries = jax_model.init_carries(2)
    carries = model.init_carries(2)
    assert all(c.dtype == torch.float32 for pair in carries.values()
               for c in pair)
    for start in range(0, 9, 3):
        ref, jax_carries = jax_model.apply(
            variables, jax_feats[:, start: start + 3], carries=jax_carries)
        with torch.no_grad():
            got, carries = model(port_feats[:, start: start + 3],
                                 carries=carries)
        for key in ref:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                       rtol=0, atol=TOL, err_msg=key)
        for name in ('onset', 'adjoin'):
            for mine, theirs in zip(carries[name], jax_carries[name]):
                np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                           rtol=0, atol=TOL)


def test_online_model_trains_whole_sequence():
    """Without carries in train mode the LMs are differentiable (kernels E
    and F on the card, their plain versions here)."""

    _, _, model = _online_pair()
    model.train()
    feats = model.pre_proc({tools.KEY_FEATS: torch.rand(2, 1, 32, 6)})[
        tools.KEY_FEATS]
    out = model(feats, torch.Generator().manual_seed(0))
    out[tools.KEY_MULTIPITCH].sum().backward()
    grad = model.onset_lm.FastLSTM_0.recurrent_kernel.grad
    assert grad is not None and torch.count_nonzero(grad) > 0


def test_run_online_stateful_matches_jax():
    jax_model, variables, model = _online_pair()
    feats = np.random.RandomState(4).rand(1, 32, 14).astype(np.float32)
    track = {tools.KEY_FEATS: feats,
             tools.KEY_TIMES: np.arange(14) * 0.032,
             tools.KEY_TRACK: 'stream'}

    ref = jax_online_stateful(dict(track), jax_model, variables,
                              JaxIterativeNoteTranscriber(
                                  profile=jtools.PianoProfile()))
    got = run_online_stateful(dict(track), model,
                              IterativeNoteTranscriber(
                                  profile=tools.PianoProfile()),
                              device='cpu')

    assert sorted(got) == sorted(ref)
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS, tools.KEY_TIMES,
                tools.KEY_NOTES):
        assert np.asarray(got[key]).shape == np.asarray(ref[key]).shape, key
        assert np.array_equal(np.asarray(got[key]), np.asarray(ref[key])), key
    assert got[tools.KEY_MULTIPITCH].shape == (88, 14)
    assert got[tools.KEY_MULTIPITCH].any()


class _Unbucketed:
    """A JAX feature module whose ``process_audio`` runs ``process_jax`` on
    the audio as it is, without the length bucket."""

    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        return getattr(self.module, name)

    def process_audio(self, audio):
        return np.asarray(self.module.process_jax(jnp.asarray(audio)))


def test_audio_stream_frames_match_jax():
    """An AudioStream over the same audio gives JAX's frames: one hop
    apart, each the features of the samples it covers, until the pointer
    passes the end; the buffered frames come back batched. A centred
    MelSpec frame covers 511 samples, which JAX's ``process_audio`` pads to
    its 16384-sample bucket: the padded run's second frame still holds the
    clip and raises the dB reference, so the JAX stream's own frames sit
    4.6e-4 below the unpadded function's; the port matches the unpadded
    function (within 1e-5 here, 6e-8 as measured)."""

    audio = np.random.RandomState(5).uniform(-0.5, 0.5, 16000).astype(
        np.float32)
    jax_mel = JaxMelSpec(n_mels=64)
    ref_stream = jstream.AudioStream(_Unbucketed(jax_mel),
                                     frame_buffer_size=3, audio=audio)
    got_stream = stream.AudioStream(MelSpec(n_mels=64), frame_buffer_size=3,
                                    audio=audio, feature_device='cpu')
    for s in (ref_stream, got_stream):
        s.start_streaming()

    count = 0
    while not got_stream.query_finished():
        assert not ref_stream.query_finished()
        ref = ref_stream.extract_frame_features()
        got = got_stream.extract_frame_features()
        assert got.shape == ref.shape == (1, 64, 1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
        buffered = got_stream.buffer_new_frame(got)
        count += 1
    assert ref_stream.query_finished()
    assert count == 1 + len(audio) // 512
    assert buffered[tools.KEY_FEATS].shape == (1, 1, 64, 3)

    got_stream.stop_streaming()
    assert not got_stream.query_active()
    assert got_stream.extract_frame_features() is None

    # The JAX-side bucket effect, as measured
    clip = audio[:jax_mel.get_num_samples_required()]
    bucketed = np.asarray(jax_mel.process_audio(clip))
    assert np.abs(bucketed - _Unbucketed(jax_mel).process_audio(clip)).max(
    ) > MEL_TOL


class FakeInputStream:
    """sounddevice.InputStream stand-in: ``push(n)`` feeds the next n
    samples of a ramp through the callback, synchronously."""

    def __init__(self, samplerate, channels, device, callback, **_kwargs):
        self.callback = callback
        self.next_sample = 0
        self.started = False

    def start(self):
        self.started = True

    def stop(self):
        self.started = False

    def close(self):
        pass

    def push(self, n):
        samples = np.arange(self.next_sample, self.next_sample + n).astype(
            np.float32)
        self.next_sample += n
        self.callback(samples, n, None, None)


class _FakeSounddevice:
    InputStream = FakeInputStream

    @staticmethod
    def query_devices():
        return ['fake-mic']


class _IdentityModule:
    """Passes audio through as its 'features' and records the device it was
    asked for."""

    sample_rate = 16000

    def __init__(self):
        self.devices = []

    def get_num_samples_required(self):
        return 2048

    def get_hop_length(self):
        return 512

    def process_audio(self, audio, device=None):
        self.devices.append(device)
        return np.asarray(audio)[None]


class _JaxIdentityModule(_IdentityModule):
    def process_audio(self, audio):
        return np.asarray(audio)[None]


@pytest.fixture
def fake_sd(monkeypatch):
    for module in (stream, jstream):
        monkeypatch.setattr(module, 'sd', _FakeSounddevice)
        monkeypatch.setattr(module, '_HAVE_SOUNDDEVICE', True)


def test_microphone_without_sounddevice_raises(monkeypatch):
    monkeypatch.setattr(stream, '_HAVE_SOUNDDEVICE', False)
    with pytest.raises(RuntimeError, match='sounddevice'):
        stream.MicrophoneStream(_IdentityModule())


def test_microphone_frames_match_jax(fake_sd):
    """The same pushes give JAX's frames bit for bit: contiguous slices of
    the ramp one hop apart, on the feature device asked for."""

    module = _IdentityModule()
    mic = stream.MicrophoneStream(module, feature_device='cpu')
    ref_mic = jstream.MicrophoneStream(_JaxIdentityModule())
    for m in (mic, ref_mic):
        m.start_streaming()
        for chunk in (100, 2048 - 150, 50):
            m._stream.push(chunk)

    frames = []
    for _ in range(3):
        got = np.asarray(mic.extract_frame_features()).ravel()
        ref = np.asarray(ref_mic.extract_frame_features()).ravel()
        assert np.array_equal(got, ref)
        frames.append(got)
        for m in (mic, ref_mic):
            m._stream.push(512)

    assert module.devices == ['cpu'] * 3
    assert all(np.array_equal(np.diff(f), np.ones(2047)) for f in frames)
    assert frames[1][0] - frames[0][0] == 512
    for m in (mic, ref_mic):
        m.stop_streaming()
    assert mic.query_finished() and mic._stream is None


def test_microphone_lag_warning(fake_sd):
    mic = stream.MicrophoneStream(_IdentityModule(), suppress_warnings=False)
    mic.start_streaming()
    mic._stream.push(2048 + 10 * 512)
    with pytest.warns(RuntimeWarning, match='too slow'):
        mic.extract_frame_features()
    mic.stop_streaming()


def test_microphone_callback_thread_safety(fake_sd):
    """A producer thread pushes through the callback while the caller
    extracts: every frame is a whole ramp slice (the lock prevents a torn
    read) and the stream moves forward."""

    mic = stream.MicrophoneStream(_IdentityModule())
    mic.start_streaming()
    stop = threading.Event()

    def producer():
        while not stop.is_set():
            mic._stream.push(256)
            time.sleep(0.0005)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    frames = []
    for _ in range(5):
        frames.append(np.asarray(mic.extract_frame_features()).ravel())
        time.sleep(0.005)
    stop.set()
    thread.join(timeout=2)
    mic.stop_streaming()

    starts = [f[0] for f in frames]
    for f in frames:
        np.testing.assert_array_equal(np.diff(f), 1.0)
    assert all(b >= a for a, b in zip(starts, starts[1:]))
    assert starts[-1] > starts[0]


def test_microphone_enter_stops_the_stream(fake_sd, monkeypatch):
    events = {}

    class FakeKey:
        enter = 'ENTER'

    class FakeListener:
        def __init__(self, on_press):
            self.on_press = on_press
            self.daemon = False
            events['listener'] = self

        def start(self):
            events['started'] = True

    class FakeKeyboard:
        Key = FakeKey
        Listener = FakeListener

    monkeypatch.setattr(stream, 'keyboard', FakeKeyboard)
    monkeypatch.setattr(stream, '_HAVE_PYNPUT', True)

    mic = stream.MicrophoneStream(_IdentityModule(), enter_to_stop=True)
    mic.start_streaming()
    assert events.get('started') and not mic.query_finished()
    assert events['listener'].on_press('x') is not False
    assert not mic.query_finished()
    assert events['listener'].on_press(FakeKey.enter) is False
    assert mic.query_finished()
