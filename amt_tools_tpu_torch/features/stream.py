"""Online feature streaming: frame buffers, microphone and audio streams.

Counterpart of ``amt_tools_tpu/features/stream.py``: ``FeatureStream``
(``:52``), ``MicrophoneStream`` (``:155``), ``AudioStream`` (``:286``) and
``AudioFileStream`` (``:367``), host numpy and threads around the feature
module's ``process_audio``, which runs on ``feature_device`` (the card
unless the caller names one). As in JAX, the microphone's ring buffer is
guarded by a lock against the capture callback's thread, waiting sleeps
instead of spinning, and ``sounddevice``/``pynput`` are optional: a stream
that needs one raises at construction when it is missing.
"""

import threading
import time
import warnings
from abc import abstractmethod

import numpy as np

from .. import tools

try:
    import sounddevice as sd
    _HAVE_SOUNDDEVICE = True
except Exception:
    sd = None
    _HAVE_SOUNDDEVICE = False

try:
    from pynput import keyboard
    _HAVE_PYNPUT = True
except Exception:
    keyboard = None
    _HAVE_PYNPUT = False

# Lag past which processing is falling behind
MIC_LAG_TOL = 0.250  # seconds

__all__ = [
    'FeatureStream',
    'MicrophoneStream',
    'AudioStream',
    'AudioFileStream',
]


class FeatureStream(object):
    """Generic feature streaming wrapper with a rolling frame buffer."""

    def __init__(self, module, frame_buffer_size=1, feature_device=None):
        self.module = module
        self.feature_device = feature_device

        self.frame_buffer = None
        self.frame_buffer_size = frame_buffer_size

        self.start_time = None

    def _features(self, audio):
        return self.module.process_audio(audio, device=self.feature_device)

    @abstractmethod
    def reset_stream(self):
        """Stop streaming and clear the frame buffer."""

        self.stop_streaming()
        self.frame_buffer = list()

    @abstractmethod
    def start_streaming(self):
        """Begin streaming (starts the elapsed-time clock)."""

        self.start_time = tools.get_current_time()

    @abstractmethod
    def stop_streaming(self):
        """Stop streaming (clears the elapsed-time clock)."""

        self.start_time = None

    @abstractmethod
    def extract_frame_features(self):
        """Acquire the next frame of features from the stream."""

        raise NotImplementedError

    def query_active(self):
        """Whether the stream is up and running."""

        return self.start_time is not None

    @abstractmethod
    def query_finished(self):
        """Whether the stream has finished."""

        raise NotImplementedError

    def buffer_new_frame(self, frame=None):
        """Add a frame (extracted if not given); return buffered features."""

        if frame is None:
            frame = self.extract_frame_features()

        if self.query_frame_buffer_full():
            start_idx = len(self.frame_buffer) - self.frame_buffer_size + 1
            self.frame_buffer = self.frame_buffer[start_idx:]

        self.frame_buffer += [frame]

        return self.get_buffered_frames()

    def buffer_empty_frame(self):
        """Add one zero frame to the buffer."""

        empty_frame = np.zeros((self.module.get_num_channels(),
                                self.module.get_feature_size(), 1),
                               dtype=np.float32)

        return self.buffer_new_frame(empty_frame)

    def prime_frame_buffer(self, amount):
        """Add ``amount`` empty frames to the buffer."""

        for _ in range(amount):
            self.buffer_empty_frame()

    def query_frame_buffer_full(self):
        """Whether the frame buffer is at (or beyond) capacity."""

        return len(self.frame_buffer) >= self.frame_buffer_size

    def get_buffered_frames(self):
        """The buffered frames as a batched {features, times} dict."""

        features = np.concatenate(self.frame_buffer, axis=-1)

        current_time = np.array([self.get_elapsed_time()])

        return tools.dict_unsqueeze({tools.KEY_FEATS: features,
                                     tools.KEY_TIMES: current_time})

    def get_elapsed_time(self, decimals=3):
        """Seconds since the stream started (0 when stopped)."""

        elapsed_time = 0

        if self.start_time is not None:
            elapsed_time = round(tools.get_current_time(decimals) -
                                 self.start_time, decimals)

        return elapsed_time


class MicrophoneStream(FeatureStream):
    """Real-time microphone capture on a daemon thread.

    A lock-guarded rolling audio buffer receives samples from the
    ``sounddevice`` callback thread; the caller's thread takes complete hops
    out of it. An optional ENTER-key listener (``pynput``) stops the stream.
    ``device`` is the audio input device; ``feature_device`` the torch
    device of the features.
    """

    def __init__(self, module, frame_buffer_size=1, audio_buffer_size=None,
                 device=None, enter_to_stop=False, suppress_warnings=True,
                 feature_device=None):
        if not _HAVE_SOUNDDEVICE:
            raise RuntimeError('MicrophoneStream requires the sounddevice '
                               'package (and PortAudio).')

        super().__init__(module, frame_buffer_size, feature_device)

        if audio_buffer_size is None:
            # One full frame plus a safety hop
            audio_buffer_size = (module.get_num_samples_required() +
                                 module.get_hop_length())

        self.audio_buffer_size = int(audio_buffer_size)
        self.device = device
        self.suppress_warnings = suppress_warnings

        self._lock = threading.Lock()
        self.audio_buffer = None
        self.current_sample = None
        self._killed = False

        self._stream = None
        self._listener = None

        self.reset_stream()

        if enter_to_stop:
            if not _HAVE_PYNPUT:
                raise RuntimeError('enter_to_stop requires the pynput '
                                   'package.')
            self._listener = keyboard.Listener(on_press=self._on_key)
            self._listener.daemon = True
            self._listener.start()

    def _on_key(self, key):
        if key == keyboard.Key.enter:
            self.stop_streaming()
            return False

    @staticmethod
    def query_devices():
        """The available audio input devices."""

        if not _HAVE_SOUNDDEVICE:
            raise RuntimeError('sounddevice is not available.')

        return sd.query_devices()

    def reset_stream(self):
        super().reset_stream()

        with self._lock:
            self.audio_buffer = np.zeros(self.audio_buffer_size,
                                         dtype=np.float32)
            # Samples captured since the stream started
            self.current_sample = 0
            # Samples consumed by feature extraction
            self._consumed = 0

    def _callback(self, indata, frames, _time_info, _status):
        """sounddevice callback: roll new samples into the ring buffer."""

        samples = np.asarray(indata, dtype=np.float32).mean(axis=-1) \
            if indata.ndim > 1 else np.asarray(indata, dtype=np.float32)

        with self._lock:
            n = len(samples)
            if n >= self.audio_buffer_size:
                self.audio_buffer = samples[-self.audio_buffer_size:].copy()
            else:
                self.audio_buffer = np.roll(self.audio_buffer, -n)
                self.audio_buffer[-n:] = samples
            self.current_sample += n

    def start_streaming(self):
        super().start_streaming()

        self._killed = False
        self._stream = sd.InputStream(samplerate=self.module.sample_rate,
                                      channels=1, device=self.device,
                                      callback=self._callback)
        self._stream.start()

    def stop_streaming(self):
        super().stop_streaming()

        self._killed = True
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None

    def extract_frame_features(self):
        """Wait for one new hop of audio and extract its features."""

        required = self.module.get_num_samples_required()
        hop = self.module.get_hop_length()

        # Wait (sleeping, not spinning) until a new hop is available
        while self.query_active():
            with self._lock:
                available = self.current_sample - self._consumed
            if available >= hop and self.current_sample >= required:
                break
            time.sleep(hop / (4 * self.module.sample_rate))

        if not self.query_active():
            return None

        with self._lock:
            lag = ((self.current_sample - self._consumed - hop) /
                   self.module.sample_rate)
            audio = self.audio_buffer[-required:].copy()
            self._consumed += hop

        if lag > MIC_LAG_TOL and not self.suppress_warnings:
            warnings.warn(f'Processing might be too slow. Currently out of '
                          f'sync by {lag:.3f} seconds.',
                          category=RuntimeWarning)

        return self._features(audio)

    def query_finished(self):
        return self._killed


class AudioStream(FeatureStream):
    """Mock-real-time streaming over in-memory audio: each frame takes the
    ``get_num_samples_required()`` samples from the current sample, which
    then advances one hop."""

    def __init__(self, module, frame_buffer_size=1, audio=None,
                 real_time=False, playback=False, suppress_warnings=True,
                 feature_device=None):
        FeatureStream.__init__(self, module, frame_buffer_size,
                               feature_device)

        if playback and not _HAVE_SOUNDDEVICE:
            raise RuntimeError('playback requires the sounddevice package.')

        self.audio = None
        self.current_sample = None

        self.playback = playback
        self.real_time = real_time
        self.suppress_warnings = suppress_warnings

        self.reset_stream(audio)

    def reset_stream(self, audio=None):
        super().reset_stream()

        self.current_sample = 0

        if audio is not None:
            self.audio = np.asarray(audio, dtype=np.float32)

    def start_streaming(self):
        super().start_streaming()

        if self.playback and self.audio is not None:
            sd.play(self.audio, self.module.sample_rate)

    def stop_streaming(self):
        super().stop_streaming()

        if self.playback and _HAVE_SOUNDDEVICE:
            sd.stop(ignore_errors=True)

    def extract_frame_features(self):
        """Acquire the next frame of features from the stream."""

        features = None

        if self.query_active() and not self.query_finished():
            required = self.module.get_num_samples_required()
            sample_time = ((self.current_sample + required) /
                           self.module.sample_rate)

            if self.real_time:
                time_lag = self.get_elapsed_time() - sample_time

                if time_lag > MIC_LAG_TOL and not self.suppress_warnings:
                    warnings.warn(f'Processing might be too slow. Currently '
                                  f'out of sync by {time_lag} seconds.',
                                  category=RuntimeWarning)

                # Sleep until it is time to acquire the next frame
                remaining = sample_time - self.get_elapsed_time()
                if remaining > 0:
                    time.sleep(remaining)

            audio = self.audio[..., self.current_sample:
                               self.current_sample + required]

            self.current_sample += self.module.get_hop_length()

            features = self._features(audio)

        return features

    def query_finished(self):
        """Whether the sample pointer has passed the end of the audio."""

        finished = True

        if self.audio is not None:
            finished = self.current_sample > len(self.audio)

        return finished


class AudioFileStream(AudioStream):
    """Mock-real-time streaming over an audio file, read with
    ``tools.load_normalize_audio`` at the module's sample rate."""

    def __init__(self, module, frame_buffer_size=1, audio_path=None,
                 audio_norm=-1, real_time=False, playback=False,
                 suppress_warnings=True, feature_device=None):
        audio, _ = tools.load_normalize_audio(audio_path,
                                              fs=module.sample_rate,
                                              norm=audio_norm)

        self.original_audio = audio

        AudioStream.__init__(self, module, frame_buffer_size, audio,
                             real_time, playback, suppress_warnings,
                             feature_device)
