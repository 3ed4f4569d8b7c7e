"""Synthetic piano and guitar tracks with exactly-known notes (host numpy).

Copies of ``amt_tools_tpu/datasets/synthetic.py``: ``render_notes``
(``:17``), ``add_room`` (``:70``), ``random_notes`` (``:102``),
``SyntheticPiano`` (``:115``) and ``SyntheticGuitar`` (``:213``), so
training, benchmarks and the chip smoke test make the JAX package's tracks,
bit for bit, without it.
"""

import os
import zlib

import numpy as np

from .. import tools
from .common import TranscriptionDataset

__all__ = ['render_notes', 'add_room', 'random_notes', 'SyntheticPiano',
           'SyntheticGuitar']


def render_notes(pitches, intervals, sample_rate, duration, harmonics=4,
                 amplitude=0.25, decay=3.0, seed=0, velocity_range=None,
                 timbre_jitter=0.0, velocities=None):
    """Render MIDI notes as decaying harmonic tones (mono float32 audio).

    ``velocity_range=(lo, hi)`` scales each note's amplitude by a uniform
    draw; ``timbre_jitter`` perturbs each note's per-harmonic amplitudes
    log-normally (sigma in nats); explicit per-note ``velocities`` (in
    [0, 1]) override ``velocity_range``. The draws come in the JAX
    package's order (phase, velocity, jitter a note), so the audio is its
    bit for bit.
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

        if velocities is not None:
            velocity = float(velocities[index])
        elif velocity_range is not None:
            velocity = rng.uniform(*velocity_range)
        else:
            velocity = 1.0

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


class SyntheticGuitar(SyntheticPiano):
    """Synthetic guitar-style dataset (tablature ground truth).

    One monophonic line a string, each note cut before the string's next
    onset, rendered with a timbre of the string's own (harmonic count and
    decay grow with the string), so string disambiguation is learnable
    from the audio; the track's seed is the ``crc32`` of its name. A track
    holds audio, tablature (S, T), multi-pitch (F, T) and batched notes.
    """

    def __init__(self, base_dir=None, splits=None, hop_length=512,
                 sample_rate=22050, data_proc=None, profile=None,
                 num_frames=None, audio_norm=-1, split_notes=False,
                 reset_data=False, store_data=True, save_data=False,
                 save_loc=None, seed=0, num_tracks=4, track_duration=4.0,
                 notes_per_track=10, noise_snr_db=None, reverb_time=0.0,
                 velocity_range=None, timbre_jitter=0.0, device=None):
        if profile is None:
            profile = tools.GuitarProfile()

        super().__init__(base_dir, splits, hop_length, sample_rate, data_proc,
                         profile, num_frames, audio_norm, split_notes,
                         reset_data, store_data, save_data, save_loc, seed,
                         num_tracks, track_duration, notes_per_track,
                         noise_snr_db, reverb_time, velocity_range,
                         timbre_jitter, device=device)

    def _generate_strings(self, track):
        """Each string's notes and the rendered audio of the track."""

        track_seed = zlib.crc32(track.encode()) % (2 ** 31)
        rng = np.random.RandomState(track_seed)

        # One monophonic line a string (no overlaps on a string)
        stacked_notes = {}
        tuning = self.profile.get_midi_tuning()
        for string, open_pitch in enumerate(tuning):
            count = max(1, self.notes_per_track // len(tuning))
            frets = rng.randint(0, self.profile.num_pitches, count)
            onsets = np.sort(rng.uniform(0, self.track_duration - 0.5, count))
            # Each note ends before the next onset
            offsets = np.minimum(onsets + rng.uniform(0.2, 0.5, count),
                                 np.append(onsets[1:], self.track_duration))
            pitches = (open_pitch + frets).astype(float)
            stacked_notes[string] = (pitches, np.stack([onsets, offsets], -1))

        num_samples = int(self.track_duration * self.sample_rate)
        audio = np.zeros(num_samples, dtype=np.float32)
        for string, (pitches, intervals) in stacked_notes.items():
            audio = audio + render_notes(
                pitches, intervals, self.sample_rate, self.track_duration,
                harmonics=2 + string, decay=2.0 + 0.7 * string,
                seed=track_seed + string, velocity_range=self.velocity_range,
                timbre_jitter=self.timbre_jitter)
        peak = np.max(np.abs(audio))
        if peak > 1.0:
            audio = audio / peak
        audio = add_room(audio, self.sample_rate, rng,
                         noise_snr_db=self.noise_snr_db,
                         reverb_time=self.reverb_time)

        return stacked_notes, audio

    def load(self, track):
        data = TranscriptionDataset.load(self, track)

        stacked_notes, audio = self._generate_strings(track)
        all_pitches, all_intervals = tools.stacked_notes_to_notes(
            stacked_notes)

        if self.audio_norm == -1:
            audio = tools.rms_norm(audio)

        times = self.data_proc.get_times(audio)

        stacked_multi_pitch = tools.stacked_notes_to_stacked_multi_pitch(
            stacked_notes, times, self.profile)
        tablature = tools.stacked_multi_pitch_to_tablature(
            stacked_multi_pitch, self.profile)
        multi_pitch = tools.stacked_multi_pitch_to_multi_pitch(
            stacked_multi_pitch)

        data.update({tools.KEY_FS: self.sample_rate,
                     tools.KEY_AUDIO: audio,
                     tools.KEY_TABLATURE: tablature,
                     tools.KEY_MULTIPITCH: multi_pitch,
                     tools.KEY_NOTES: tools.notes_to_batched_notes(
                         all_pitches, all_intervals)})

        return data
