"""Synthetic piano tracks with exactly-known notes (host numpy).

Copies of ``amt_tools_tpu/datasets/synthetic.py``: ``render_notes``
(``:17``, without its ``velocity_range`` knob), ``add_room`` (``:70``),
``random_notes`` (``:102``) and ``SyntheticPiano`` (``:115``), so training,
benchmarks and the chip smoke test make the JAX package's tracks, bit for
bit, without it.
"""

import os
import zlib

import numpy as np

from .. import tools
from .common import TranscriptionDataset

__all__ = ['render_notes', 'add_room', 'random_notes', 'SyntheticPiano']


def render_notes(pitches, intervals, sample_rate, duration, harmonics=4,
                 amplitude=0.25, decay=3.0, seed=0, timbre_jitter=0.0,
                 velocities=None):
    """Render MIDI notes as decaying harmonic tones (mono float32 audio).

    ``timbre_jitter`` perturbs each note's per-harmonic amplitudes
    log-normally (sigma in nats); ``velocities`` (in [0, 1]) scale each
    note's amplitude.
    """

    rng = np.random.RandomState(seed)
    num_samples = int(duration * sample_rate)
    audio = np.zeros(num_samples, dtype=np.float64)

    for index, (pitch, (onset, offset)) in enumerate(
            zip(pitches, np.asarray(intervals).reshape(-1, 2))):
        freq = float(tools.midi_to_hz(pitch))
        start = int(onset * sample_rate)
        end = min(num_samples, int(offset * sample_rate))
        if end <= start:
            continue

        t = np.arange(end - start) / sample_rate
        envelope = np.exp(-decay * t)
        phase = rng.uniform(0, 2 * np.pi)

        velocity = 1.0 if velocities is None else float(velocities[index])

        tone = np.zeros_like(t)
        for h in range(1, harmonics + 1):
            if h * freq < sample_rate / 2:
                gain = 1.0 / h
                if timbre_jitter > 0:
                    gain *= np.exp(timbre_jitter * rng.randn())
                tone += gain * np.sin(2 * np.pi * h * freq * t + phase)

        audio[start: end] += amplitude * velocity * envelope * tone

    peak = np.max(np.abs(audio))
    if peak > 1.0:
        audio /= peak

    return audio.astype(np.float32)


def add_room(audio, sample_rate, rng, noise_snr_db=None, reverb_time=0.0):
    """Degrade clean audio with reverberation and broadband noise.

    ``reverb_time`` convolves with an exponentially decaying noise impulse
    response of that length (seconds); ``noise_snr_db`` adds white noise at
    that signal-to-noise ratio.
    """

    audio = np.asarray(audio, dtype=np.float64)

    if reverb_time and reverb_time > 0:
        ir_len = max(1, int(reverb_time * sample_rate))
        t = np.arange(ir_len) / sample_rate
        ir = rng.randn(ir_len) * np.exp(-6.9 * t / reverb_time)  # -60 dB tail
        ir[0] = 1.0
        ir /= np.sqrt(np.sum(ir ** 2))
        from scipy.signal import fftconvolve
        audio = fftconvolve(audio, ir)[:len(audio)]

    if noise_snr_db is not None:
        signal_power = np.mean(audio ** 2)
        noise_power = signal_power / (10.0 ** (noise_snr_db / 10.0))
        audio = audio + np.sqrt(noise_power) * rng.randn(len(audio))

    peak = np.max(np.abs(audio))
    if peak > 1.0:
        audio = audio / peak

    return audio.astype(np.float32)


def random_notes(profile, duration, num_notes, rng, min_dur=0.2, max_dur=0.8):
    """Random non-degenerate notes within a profile's range."""

    pitches = rng.randint(profile.low, profile.high + 1, num_notes).astype(float)
    onsets = rng.uniform(0, max(1e-3, duration - max_dur), num_notes)
    durations = rng.uniform(min_dur, max_dur, num_notes)
    intervals = np.stack([onsets, np.minimum(onsets + durations, duration)], axis=-1)

    order = np.argsort(onsets)

    return pitches[order], intervals[order]


class SyntheticPiano(TranscriptionDataset):
    """Synthetic piano-style dataset (multi-pitch, onset, offset and
    velocity ground truth), generated per track from the track's name.

    Difficulty knobs (clean by default): ``noise_snr_db``, ``reverb_time``,
    ``velocity_range`` (per-note amplitude spread) and ``timbre_jitter``.
    Features run on ``device`` (the card unless the caller names one).
    """

    def __init__(self, base_dir=None, splits=None, hop_length=512,
                 sample_rate=16000, data_proc=None, profile=None,
                 num_frames=None, audio_norm=-1, split_notes=False,
                 reset_data=False, store_data=True, save_data=False,
                 save_loc=None, seed=0, num_tracks=4, track_duration=4.0,
                 notes_per_track=12, noise_snr_db=None, reverb_time=0.0,
                 velocity_range=None, timbre_jitter=0.0, device=None):
        self.num_tracks = num_tracks
        self.track_duration = track_duration
        self.notes_per_track = notes_per_track
        self.noise_snr_db = noise_snr_db
        self.reverb_time = reverb_time
        self.velocity_range = velocity_range
        self.timbre_jitter = timbre_jitter

        super().__init__(base_dir or '.', splits, hop_length, sample_rate,
                         data_proc, profile, num_frames, audio_norm,
                         split_notes, reset_data, store_data, save_data,
                         save_loc, seed, device=device)

    def get_tracks(self, split):
        return [f'{split}_{i:03d}' for i in range(self.num_tracks)]

    @staticmethod
    def available_splits():
        return ['train']

    @staticmethod
    def download(save_dir):
        # Nothing to download: tracks are generated on the fly
        os.makedirs(save_dir, exist_ok=True)

    def _generate(self, track):
        """Deterministic per-track note content derived from the track name."""

        track_seed = zlib.crc32(track.encode()) % (2 ** 31)
        rng = np.random.RandomState(track_seed)

        pitches, intervals = random_notes(self.profile, self.track_duration,
                                          self.notes_per_track, rng)

        # Explicit per-note velocities so velocity ground truth is exact
        if self.velocity_range is not None:
            velocities = rng.uniform(*self.velocity_range, len(pitches))
        else:
            velocities = np.ones(len(pitches))

        audio = render_notes(pitches, intervals, self.sample_rate,
                             self.track_duration, seed=track_seed,
                             velocities=velocities,
                             timbre_jitter=self.timbre_jitter)
        audio = add_room(audio, self.sample_rate, rng,
                         noise_snr_db=self.noise_snr_db,
                         reverb_time=self.reverb_time)

        return pitches, intervals, velocities, audio

    def load(self, track):
        data = super().load(track)

        pitches, intervals, velocities, audio = self._generate(track)

        if self.audio_norm == -1:
            audio = tools.rms_norm(audio)

        times = self.data_proc.get_times(audio)

        multi_pitch = tools.notes_to_multi_pitch(pitches, intervals, times,
                                                 self.profile)

        ambiguity = self.hop_length / self.sample_rate
        onsets = tools.notes_to_onsets(pitches, intervals, times,
                                       self.profile, ambiguity)
        offsets = tools.notes_to_offsets(pitches, intervals, times,
                                         self.profile, ambiguity)
        velocity = tools.notes_to_velocity(pitches, intervals, velocities,
                                           times, self.profile)

        data.update({tools.KEY_FS: self.sample_rate,
                     tools.KEY_AUDIO: audio,
                     tools.KEY_MULTIPITCH: multi_pitch,
                     tools.KEY_ONSETS: onsets,
                     tools.KEY_OFFSETS: offsets,
                     tools.KEY_VELOCITY: velocity,
                     tools.KEY_NOTES: tools.notes_to_batched_notes(pitches,
                                                                   intervals)})

        return data
