"""Seeded note traffic, rendered on the device.

The note draw and the tone are those of the port's
``datasets/synthetic.py`` (``random_notes``, ``render_notes``; the JAX
package's ``bench.py:430-437`` at about 2 notes a second): pitches uniform
over the mix's range, onsets uniform over the clip, durations uniform in
[``min_dur``, ``max_dur``], each note ``harmonics`` partials of weight 1/h
under an exp(-``decay`` t) envelope at ``amplitude``, with a random phase,
each clip scaled down to a peak of 1 if louder. The notes are drawn on the
host (a few thousand numbers); the audio is rendered on the device, one
note of every clip a pass, so that no index is written twice in a pass
and the same seed gives the same bits.

A mix's parameters (``traffic/<mix>.json``):

- ``output``: ``"audio"`` (a pool of (batch, samples) audio batches to
  serve) or ``"labelled"`` (a pool of training batches: the reference's
  features of rendered crops and the reference's targets of their notes);
- ``batch``, ``pool`` (distinct batches, cycled), ``clip_seconds`` or
  ``frames`` (a crop of that many frames), ``notes_per_second``,
  ``pitch_low``, ``pitch_high``, ``min_dur``, ``max_dur``, ``harmonics``,
  ``amplitude``, ``decay``.

Every seed draws the same number of notes of the same length ranges, so
the work does not change with the seed.
"""

import math

import numpy as np
import torch

from .. import weights


def draw_notes(traffic, clips, seconds, rng):
    """(clips, K) pitches, onsets and offsets in seconds, and phases."""

    count = int(round(traffic['notes_per_second'] * seconds))
    shape = (clips, count)
    pitches = rng.randint(traffic['pitch_low'], traffic['pitch_high'] + 1,
                          shape)
    latest = max(1e-3, seconds - traffic['max_dur'])
    onsets = rng.uniform(0.0, latest, shape)
    offsets = np.minimum(onsets + rng.uniform(traffic['min_dur'],
                                              traffic['max_dur'], shape),
                         seconds)
    phases = rng.uniform(0.0, 2 * np.pi, shape)

    return pitches, onsets, offsets, phases


def render(traffic, notes, sample_rate, num_samples, device):
    """(clips, samples) float32 audio of the drawn notes, on ``device``."""

    pitches, onsets, offsets, phases = (torch.as_tensor(x, device=device)
                                        for x in notes)
    clips, count = pitches.shape
    span = int(math.ceil(traffic['max_dur'] * sample_rate)) + 1
    step = torch.arange(span, device=device)
    t = step.to(torch.float32) / sample_rate
    envelope = traffic['amplitude'] * torch.exp(-traffic['decay'] * t)
    base = torch.arange(clips, device=device)[:, None] * num_samples

    audio = torch.zeros(clips * num_samples, device=device)
    freqs = 440.0 * 2.0 ** ((pitches.double() - 69.0) / 12.0)
    starts = (onsets * sample_rate).long()
    ends = torch.clamp_max((offsets * sample_rate).long(), num_samples)
    for k in range(count):
        f = freqs[:, k, None].float()
        tone = torch.zeros(clips, span, device=device)
        for h in range(1, traffic['harmonics'] + 1):
            audible = (h * f < sample_rate / 2).float()
            tone += audible / h * torch.sin(2 * math.pi * h * f * t +
                                            phases[:, k, None].float())
        live = step[None] < (ends[:, k] - starts[:, k])[:, None]
        index = torch.clamp_max(starts[:, k, None] + step[None],
                                num_samples - 1) + base
        audio.index_add_(0, index.flatten(),
                         (tone * envelope * live).flatten())

    audio = audio.view(clips, num_samples)
    peak = audio.abs().amax(dim=1, keepdim=True)

    return audio / torch.where(peak > 1.0, peak, torch.ones_like(peak))


def make(traffic, config, reference, seed, device):
    """The mix's pool: a list of ``pool`` batches."""

    rng = np.random.RandomState(weights.derive(seed, 'traffic') % (1 << 32))
    sample_rate = config['sample_rate']
    hop = config['hop_length']
    clips = traffic['pool'] * traffic['batch']
    if traffic['output'] == 'audio':
        seconds = traffic['clip_seconds']
        num_samples = int(seconds * sample_rate)
    else:
        num_samples = (traffic['frames'] - 1) * hop
        seconds = num_samples / sample_rate

    notes = draw_notes(traffic, clips, seconds, rng)
    audio = render(traffic, notes, sample_rate, num_samples, device)
    batches = list(audio.view(traffic['pool'], traffic['batch'],
                              num_samples).unbind(0))
    if traffic['output'] == 'audio':
        return batches

    return [labelled(batches[b], notes, b * traffic['batch'], traffic,
                     config, reference, rng, device)
            for b in range(traffic['pool'])]


def labelled(audio, notes, first, traffic, config, reference, rng, device):
    """A training batch: the reference's float32 features of the crops and
    its targets of their notes."""

    from ..reference import plain

    with torch.no_grad(), plain.exact_float32():
        feats = reference.features(audio, config)
    batch = {'features': feats}
    pitches, onsets, offsets, _ = notes
    rows = []
    for c in range(first, first + traffic['batch']):
        crop = list(zip(pitches[c], onsets[c], offsets[c]))
        rows.append(reference.targets(crop, traffic['frames'], config,
                                      device, rng))
    for key in rows[0]:
        batch[key] = torch.stack([row[key] for row in rows])

    return batch
