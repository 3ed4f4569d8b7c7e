"""Synthetic piano audio with exactly-known notes (host numpy).

Copies of ``render_notes`` (``amt_tools_tpu/datasets/synthetic.py:17``,
without the optional difficulty knobs) and ``random_notes`` (``:102``), so
benchmarks and the chip smoke test can make audio without the JAX package.
"""

import numpy as np

from .. import tools

__all__ = ['render_notes', 'random_notes']


def render_notes(pitches, intervals, sample_rate, duration, harmonics=4,
                 amplitude=0.25, decay=3.0, seed=0):
    """Render MIDI notes as decaying harmonic tones (mono float32 audio)."""

    rng = np.random.RandomState(seed)
    num_samples = int(duration * sample_rate)
    audio = np.zeros(num_samples, dtype=np.float64)

    for pitch, (onset, offset) in zip(pitches,
                                      np.asarray(intervals).reshape(-1, 2)):
        freq = float(tools.midi_to_hz(pitch))
        start = int(onset * sample_rate)
        end = min(num_samples, int(offset * sample_rate))
        if end <= start:
            continue

        t = np.arange(end - start) / sample_rate
        envelope = np.exp(-decay * t)
        phase = rng.uniform(0, 2 * np.pi)

        tone = np.zeros_like(t)
        for h in range(1, harmonics + 1):
            if h * freq < sample_rate / 2:
                tone += (1.0 / h) * np.sin(2 * np.pi * h * freq * t + phase)

        audio[start: end] += amplitude * envelope * tone

    peak = np.max(np.abs(audio))
    if peak > 1.0:
        audio /= peak

    return audio.astype(np.float32)


def random_notes(profile, duration, num_notes, rng, min_dur=0.2, max_dur=0.8):
    """Random non-degenerate notes within a profile's range."""

    pitches = rng.randint(profile.low, profile.high + 1, num_notes).astype(float)
    onsets = rng.uniform(0, max(1e-3, duration - max_dur), num_notes)
    durations = rng.uniform(min_dur, max_dur, num_notes)
    intervals = np.stack([onsets, np.minimum(onsets + durations, duration)], axis=-1)

    order = np.argsort(onsets)

    return pitches[order], intervals[order]
