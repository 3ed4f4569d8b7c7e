"""The regression decode of High-resolution Piano Transcription
(``ops/decode.py`` ``regression_events_on_device`` and
``regression_notes_from_device``, through ``serving.RegressionPipeline``)
against the published ``RegressionPostProcessor`` as a plain loop
(``tests/hpt_reference.py``), on the CPU.

Hand-built curves put each rule of the published note detection on its
own: plateaus, peaks within two frames of each other and of the clip's
edges, an offset before the frame curve's drop on either side of the
``offset - onset > drop - offset`` rule, the 600-frame cap, back-to-back
onsets and a note that reaches the clip's end. Random curves, rounded to
bf16 as the served ones are (so ties are common), hold the whole decode to
the loop's notes: frames, shifts and velocities, exactly.
"""

import numpy as np
import pytest
import torch

import hpt_reference as ref
from amt_tools_tpu_torch.ops import decode

CONFIG = {'onset_threshold': 0.3, 'offset_threshold': 0.3,
          'frame_threshold': 0.1, 'lowest_key': 21}
HEADS = ('frame', 'reg_onset', 'reg_offset', 'velocity')


def _port_rows(curves, capacity=64):
    """(B, T, K) float32 curves -> each clip's rows as the reference gives
    them, from the device stage and the host stage (times in frames)."""

    maps = {key: torch.as_tensor(value).transpose(-1, -2)
            for key, value in curves.items()}
    arrays = [a.numpy() for a in decode.regression_events_on_device(
        maps['frame'], maps['reg_onset'], maps['reg_offset'],
        maps['velocity'], capacity)]
    frames = curves['frame'].shape[1]
    clips = []
    for b in range(curves['frame'].shape[0]):
        pitches, intervals, velocities = decode.regression_notes_from_device(
            *(a[b] for a in arrays), num_frames=frames, frame_seconds=1.0,
            low=CONFIG['lowest_key'])
        rows = []
        for pitch, (on, off), velocity in zip(pitches, intervals, velocities):
            begin, end = int(np.rint(on)), int(np.rint(off))
            rows.append((int(pitch), begin, float(np.float32(on - begin)), end,
                         float(np.float32(off - end)), int(velocity)))
        clips.append(sorted(rows))

    return clips


def _ref_rows(curves):
    return [ref.decode({key: value[b] for key, value in curves.items()},
                       CONFIG) for b in range(curves['frame'].shape[0])]


def _one_key(frame, onset, offset, velocity=None, keys=3, key=1):
    """(1, T, keys) curves with the given (T,) curves on ``key`` and
    nothing on the others."""

    frames = len(frame)
    curves = {name: np.zeros((1, frames, keys), np.float32) for name in HEADS}
    curves['frame'][0, :, key] = frame
    curves['reg_onset'][0, :, key] = onset
    curves['reg_offset'][0, :, key] = offset
    curves['velocity'][0, :, key] = (np.full(frames, 0.5) if velocity is None
                                     else velocity)

    return curves


def _bump(frames, at, height=0.9, width=2):
    """A strict peak of ``height`` at ``at``, falling over ``width`` frames
    a side."""

    x = np.zeros(frames, np.float32)
    for d in range(-width, width + 1):
        if 0 <= at + d < frames:
            x[at + d] = height * (1.0 - abs(d) / (width + 1.0))
    return x


def _case(name, frames=80):
    on, off = np.zeros(frames, np.float32), np.zeros(frames, np.float32)
    frame = np.zeros(frames, np.float32)
    if name == 'plateau':
        on[10:15] = [0.2, 0.5, 0.8, 0.8, 0.5]
        frame[10:40] = 0.9
    elif name == 'near peaks':
        on = _bump(frames, 20) + _bump(frames, 22, 0.7)
        on += _bump(frames, 1) + _bump(frames, frames - 2)
        frame[18:60] = 0.9
    elif name == 'offset before the drop, late':
        on, off = _bump(frames, 10), _bump(frames, 40)
        frame[10:45] = 0.9
    elif name == 'offset before the drop, early':
        on, off = _bump(frames, 10), _bump(frames, 15)
        frame[10:45] = 0.9
    elif name == 'offset at the drop':
        on, off = _bump(frames, 10), _bump(frames, 30)
        frame[10:30] = 0.9
    elif name == 'cap':
        frames = 700
        on, off = _bump(frames, 20), np.zeros(frames, np.float32)
        frame = np.full(frames, 0.9, np.float32)
        off[650:655] = [0.4, 0.6, 0.9, 0.6, 0.4]
    elif name == 'back to back':
        on = _bump(frames, 10) + _bump(frames, 16) + _bump(frames, 30)
        frame[10:60] = 0.9
    elif name == 'clip end':
        on = _bump(frames, frames - 10)
        frame[frames - 12:] = 0.9
    elif name == 'drop threshold':
        on = _bump(frames, 10)
        frame[10:20] = 0.9
        frame[20] = np.float32(0.1)
        frame[21:] = 0.9
    return _one_key(frame, on, off,
                    velocity=np.linspace(0.1, 0.9, frames).astype(np.float32))


CASES = ['plateau', 'near peaks', 'offset before the drop, late',
         'offset before the drop, early', 'offset at the drop', 'cap',
         'back to back', 'clip end', 'drop threshold']


@pytest.mark.parametrize('name', CASES)
def test_hand_built_curves_decode_as_the_loop(name):
    curves = _case(name)
    assert _port_rows(curves) == _ref_rows(curves)


def test_the_hand_built_cases_say_what_they_test():
    """The cases' notes, as the published rules give them."""

    def notes(name):
        return [(r[1], r[3]) for r in _ref_rows(_case(name))[0]]

    assert notes('plateau') == []
    # The smaller peak two frames away is no peak; frames 1 and T-2 never are
    assert notes('near peaks') == [(20, 60)]
    assert notes('offset before the drop, late') == [(10, 40)]
    assert notes('offset before the drop, early') == [(10, 45)]
    assert notes('offset at the drop') == [(10, 30)]
    assert notes('cap') == [(20, 620)]
    assert notes('back to back') == [(10, 15), (16, 29), (30, 60)]
    assert notes('clip end') == [(70, 79)]
    assert notes('drop threshold') == [(10, 20)]


def _random_curves(clips, frames, keys, seed):
    """Curves with bumps at random places, a smooth background and noise,
    rounded to bf16 as the served curves are."""

    g = np.random.RandomState(seed)
    curves = {}
    for name, level in (('reg_onset', 0.03), ('reg_offset', 0.03),
                        ('frame', 0.2), ('velocity', 0.5)):
        x = g.uniform(0.0, 2 * level, (clips, frames, keys))
        bumps = g.rand(clips, frames, keys) < 0.02
        for c, t, k in zip(*np.nonzero(bumps)):
            width = g.randint(1, 4)
            lo, hi = max(0, t - width), min(frames, t + width + 1)
            x[c, lo:hi, k] += g.uniform(0.2, 0.9) * (
                1.0 - np.abs(np.arange(lo, hi) - t) / (width + 1.0))
        x = torch.as_tensor(np.clip(x, 0.0, 1.0), dtype=torch.float32)
        curves[name] = x.bfloat16().float().numpy()

    return curves


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_random_curves_decode_as_the_loop(seed):
    curves = _random_curves(2, 300, 88, seed)
    got, want = _port_rows(curves, capacity=2048), _ref_rows(curves)
    assert sum(len(clip) for clip in want) > 50
    assert got == want


def test_an_overflowing_clip_reports_its_count():
    curves = _random_curves(1, 300, 88, 5)
    arrays = decode.regression_events_on_device(
        *(torch.as_tensor(curves[k]).transpose(-1, -2) for k in HEADS), 4)
    counts = arrays[-1].numpy()[0]
    assert counts[0] > 4 and counts[1] > 4
    assert arrays[0].shape == (1, 4)


def test_peaks_need_strict_rises_and_falls():
    x = torch.tensor([0.0, 0.1, 0.5, 0.6, 0.6, 0.2, 0.1, 0.35, 0.4, 0.5, 0.4,
                      0.3, 0.0])
    assert decode.regression_peaks(x, 0.3).nonzero().flatten().tolist() == [9]
    assert not decode.regression_peaks(x[:4], 0.0).any()


def test_the_pipeline_serves_the_loop_s_notes():
    """A bf16 model's served notes equal the loop's decode of the logits the
    pipeline's forward gave (sigmoid in bf16, widened to float32)."""

    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import RegressCRNN
    from amt_tools_tpu_torch.serving import RegressionPipeline

    torch.manual_seed(0)
    model = RegressCRNN(dtype=torch.bfloat16)
    with torch.no_grad():
        # Sharp regressed curves around a low level, as trained ones are
        for head in (model.reg_onset_fc, model.reg_offset_model.fc):
            head.weight *= 40.0
            head.bias.fill_(-4.0)
    mel = MelSpec(hop_length=160, fmin=30, fmax=8000, absolute_db=True,
                  pad_mode='reflect')
    pipeline = RegressionPipeline(model, mel, capacity=512, device='cpu')
    raw = {}
    pipeline.model.register_forward_hook(lambda m, a, out: raw.update(out))
    audio = 0.1 * torch.randn(2, 8000, generator=torch.Generator()
                              .manual_seed(1))
    served = pipeline(audio)

    curves = {key: torch.sigmoid(value).float().numpy()
              for key, value in raw.items()}
    for clip, want in zip(served, _ref_rows(curves)):
        pitches, intervals, velocities = clip
        hop = 160 / 16000
        got = sorted((int(p), int(np.rint(on / hop)), int(np.rint(off / hop)),
                      int(v)) for p, (on, off), v in zip(pitches, intervals,
                                                        velocities))
        assert got == [(r[0], r[1], r[3], r[5]) for r in want]
    assert pipeline.notes_decoded == sum(len(c[0]) for c in served) > 0
    assert pipeline.clips_decoded == 2
