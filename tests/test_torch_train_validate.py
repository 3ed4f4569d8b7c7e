"""Validation inside ``train()``: the of_2 recipe's estimator and
evaluator at every checkpoint of a narrow O&F2, on the CPU.

Validation runs in eval mode without autograd and draws no random numbers
(dropout comes from generators seeded by (seed, step)), so the training
losses and the final parameters of a run with validation are those of the
same run without it, bit for bit, and so is a run resumed from a validated
checkpoint.
"""

import numpy as np
import torch

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                          MultipitchEvaluator, NoteEvaluator)
from amt_tools_tpu_torch.models import OnsetsFrames2
from amt_tools_tpu_torch.train import latest_checkpoint, train
from amt_tools_tpu_torch.transcribe import (ComboEstimator, NoteTranscriber,
                                            PitchListWrapper)

torch.set_num_threads(1)

DIM_IN, FRAMES = 16, 12
PATTERNS = ['loss', 'pr', 're', 'f1']


def _batch(seed, batch=2):
    rng = np.random.RandomState(seed)
    return {
        tools.KEY_FEATS: rng.rand(batch, 1, DIM_IN, FRAMES).astype(np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(batch, 88, FRAMES) < 0.1).astype(
            np.float32),
    }


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


class _Tracks:
    """Two whole tracks of unequal lengths with notes."""

    def __init__(self):
        profile = tools.PianoProfile()
        self.data = {}
        for seed, frames in enumerate((19, 27)):
            rng = np.random.RandomState(10 + seed)
            times = np.arange(frames) * 0.032
            onsets = np.sort(rng.uniform(0, frames * 0.025, 4))
            intervals = np.stack([onsets, onsets + 0.1], 1)
            pitches = rng.randint(50, 70, 4).astype(float)
            self.data[f'val_{seed}'] = {
                tools.KEY_TRACK: f'val_{seed}',
                tools.KEY_FEATS: rng.rand(1, DIM_IN, frames).astype(
                    np.float32),
                tools.KEY_TIMES: times,
                tools.KEY_MULTIPITCH: tools.notes_to_multi_pitch(
                    pitches, intervals, times, profile),
                tools.KEY_NOTES: tools.notes_to_batched_notes(pitches,
                                                              intervals)}
        self.tracks = list(self.data)

    def get_track_data(self, track_id):
        return dict(self.data[track_id])

    def get_track_frames(self, track_id):
        return self.data[track_id][tools.KEY_FEATS].shape[-1]


class RecordingWriter:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))


def _recipe():
    profile = tools.PianoProfile()
    estimator = ComboEstimator([NoteTranscriber(profile=profile),
                                PitchListWrapper(profile=profile)])
    evaluator = ComboEvaluator([
        LossWrapper(), MultipitchEvaluator(),
        NoteEvaluator(results_key=tools.KEY_NOTE_ON),
        NoteEvaluator(offset_ratio=0.2, results_key=tools.KEY_NOTE_OFF)])
    evaluator.set_patterns(PATTERNS)
    return estimator, evaluator


def _run(iterations, log_dir, validate, checkpoints=2, writer=None):
    model = OnsetsFrames2(dim_in=DIM_IN, profile=tools.PianoProfile(),
                          model_complexity=2,
                          generator=torch.Generator().manual_seed(0))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    estimator, evaluator = _recipe() if validate else (None, None)
    result = train(model, _Loader([_batch(0), _batch(1)]), optimizer,
                   iterations, checkpoints=checkpoints, log_dir=log_dir,
                   val_set=_Tracks() if validate else None,
                   estimator=estimator, evaluator=evaluator, seed=5,
                   writer=writer, device='cpu', val_bucket=16,
                   val_batch_size=2)
    return model, result


def _validation_scalars(writer):
    return [s for s in writer.scalars if s[0].startswith(f'/{tools.VAL}/') or
            s[0].startswith(f'{tools.VAL}/')]


def test_validates_at_each_checkpoint_without_changing_training(tmp_path):
    writer = RecordingWriter()
    model, validated = _run(4, str(tmp_path / 'val'), True, writer=writer)
    plain_model, plain = _run(4, str(tmp_path / 'plain'), False)

    # The training is the same, bit for bit
    assert validated['losses'] == plain['losses']
    for key, value in plain_model.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key

    # One validation pass at each of the two checkpoints, logged by
    # finalize at the checkpoint's iteration under the recipe's patterns
    scalars = _validation_scalars(writer)
    assert sorted({s[2] for s in scalars}) == [2, 4]
    tags = {s[0] for s in scalars}
    for tag in ('loss/loss_total', f'{tools.KEY_MULTIPITCH}/precision',
                f'{tools.KEY_NOTE_ON}/recall', f'{tools.KEY_NOTE_OFF}/f1-score'):
        assert f'{tools.VAL}/{tag}' in tags, tag
    assert all(any(p in tag.split('/')[-1] for p in PATTERNS)
               for tag in tags)
    assert all(np.isfinite(s[1]) for s in scalars)
    # Each pass logs the same keys
    assert len(scalars) == 2 * len(tags)


def test_resume_after_a_validated_checkpoint_is_bit_exact(tmp_path):
    _, straight = _run(4, str(tmp_path / 'straight'), True)

    _, first = _run(2, str(tmp_path / 'resumed'), True, checkpoints=1)
    assert latest_checkpoint(str(tmp_path / 'resumed'))[1] == 2
    writer = RecordingWriter()
    _, second = _run(4, str(tmp_path / 'resumed'), True, writer=writer)

    for key in straight['losses']:
        assert (first['losses'][key] + second['losses'][key] ==
                straight['losses'][key]), key
    assert sorted({s[2] for s in _validation_scalars(writer)}) == [4]
