"""TabCNN on synthetic guitar (no downloads needed).

The port's twin of ``examples/papers/synthetic_tabcnn.py``, the tablature
twin of ``synthetic_demo.py``: trains TabCNN with CQT features on
procedurally generated guitar tracks whose strings carry distinct timbre
(so string disambiguation, TDR, is learnable), then evaluates tablature
metrics on held-out tracks. A miniature of the ``tabcnn.py`` recipe that
runs hermetically in minutes on one card; on the card the features run
kernel C, once a track.

Run: ``python synthetic_tabcnn.py [key=value overrides...]``
     e.g. ``python synthetic_tabcnn.py noise_snr_db=12 reverb_time=0.25``
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..', '..'))

import torch

from amt_tools_tpu_torch.datasets import SyntheticGuitar, DataLoader
from amt_tools_tpu_torch.models import TabCNN
from amt_tools_tpu_torch.features import CQT

from amt_tools_tpu_torch.train import train
from amt_tools_tpu_torch.transcribe import (ComboEstimator, TablatureWrapper,
                                            StackedMultiPitchCollapser)
from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                          MultipitchEvaluator,
                                          TablatureEvaluator, SoftmaxAccuracy,
                                          validate)
from amt_tools_tpu_torch.config import Experiment
from amt_tools_tpu_torch.parallel import get_mesh
import amt_tools_tpu_torch.tools as tools

ex = Experiment('TabCNN_SyntheticGuitar_CQT')


@ex.config
def config():
    # Number of samples per second of audio
    sample_rate = 22050

    # Number of samples between frames
    hop_length = 512

    # Number of consecutive frames within each example fed to the model
    num_frames = 128

    # Number of training iterations (passes over the synthetic set)
    iterations = 250

    # How many equally spaced save/validation checkpoints - 0 to disable
    checkpoints = 2

    # Number of samples to gather for a batch
    batch_size = 8

    # Adadelta learning rate (paper recipe)
    learning_rate = 1.0

    # Synthetic data parameters
    num_train_tracks = 32
    num_test_tracks = 6
    track_duration = 8.0
    notes_per_track = 24

    # Domain difficulty (defaults = clean tones)
    noise_snr_db = None
    reverb_time = 0.0
    velocity_range = None
    timbre_jitter = 0.0

    # Whether to train data-parallel over the ranks torchrun starts (one
    # process per card)
    data_parallel = False

    # Run the model compute in bfloat16 (params/losses stay float32)
    bf16 = False

    # The random seed for this experiment
    seed = 0

    # DataLoader prefetch threads. 0 (the reference recipe's setting) is
    # synchronous; >0 overlaps crop/collate with the device step
    # (deterministic per-item crop seeds, but a DIFFERENT seeded stream
    # than 0)
    num_workers = 0

    # Where the run computes: None -> the card, 'cpu' -> the plain versions
    device = None


@ex.automain
def synthetic_tabcnn(sample_rate, hop_length, num_frames, iterations,
                     checkpoints, batch_size, learning_rate,
                     num_train_tracks, num_test_tracks, track_duration,
                     notes_per_track, noise_snr_db, reverb_time,
                     velocity_range, timbre_jitter, data_parallel, bf16,
                     num_workers, seed, device, root_dir):
    difficulty = dict(noise_snr_db=noise_snr_db, reverb_time=reverb_time,
                      velocity_range=(tuple(velocity_range)
                                      if velocity_range else None),
                      timbre_jitter=timbre_jitter)
    tools.seed_everything(seed)

    profile = tools.GuitarProfile(num_frets=19)

    data_proc = CQT(sample_rate=sample_rate, hop_length=hop_length,
                    n_bins=192, bins_per_octave=24)

    validation_estimator = ComboEstimator([
        TablatureWrapper(profile=profile),
        StackedMultiPitchCollapser(profile=profile)])

    validation_evaluator = ComboEvaluator([LossWrapper(),
                                           MultipitchEvaluator(),
                                           TablatureEvaluator(profile=profile),
                                           SoftmaxAccuracy()])
    validation_evaluator.set_patterns(['loss', 'f1', 'tdr', 'acc'])

    print('Generating synthetic partitions...')

    train_set = SyntheticGuitar(base_dir=os.path.join(root_dir, 'data_train'),
                                data_proc=data_proc, num_frames=num_frames,
                                profile=profile,
                                num_tracks=num_train_tracks,
                                track_duration=track_duration,
                                notes_per_track=notes_per_track,
                                save_data=False, seed=seed, device=device,
                                **difficulty)

    test_set = SyntheticGuitar(base_dir=os.path.join(root_dir, 'data_test'),
                               data_proc=data_proc, num_frames=None,
                               profile=profile,
                               num_tracks=num_test_tracks,
                               track_duration=track_duration,
                               notes_per_track=notes_per_track,
                               save_data=False, seed=seed + 1,
                               splits=['test'], device=device, **difficulty)

    train_loader = DataLoader(train_set, batch_size=batch_size, shuffle=True,
                              drop_last=True, seed=seed,
                              num_workers=num_workers)

    model = TabCNN(dim_in=data_proc.get_feature_size(), profile=profile,
                   in_channels=data_proc.get_num_channels(),
                   dtype=torch.bfloat16 if bf16 else None)

    mesh = get_mesh(device=device) if data_parallel else None

    print('Training...')

    train(model, train_loader,
          torch.optim.Adadelta(model.parameters(), lr=learning_rate),
          iterations=iterations, checkpoints=checkpoints,
          log_dir=os.path.join(root_dir, 'models'),
          val_set=test_set, estimator=validation_estimator,
          evaluator=validation_evaluator,
          seed=seed, mesh=mesh, device=device)

    print('Final evaluation on held-out tracks...')

    validation_evaluator.set_save_dir(os.path.join(root_dir, 'results'))
    validation_evaluator.set_patterns(None)

    results = validate(model, test_set, validation_evaluator,
                       validation_estimator, bucket=128, device=device)

    print(f"held-out tablature accuracy: "
          f"{results[tools.KEY_TABLATURE][tools.KEY_ACCURACY]:.3f}")
    print(f"held-out TDR: {results[tools.KEY_TABLATURE][tools.KEY_TDR]:.3f}")
    print(f"held-out frame F1: "
          f"{results[tools.KEY_MULTIPITCH][tools.KEY_F1]:.3f}")

    ex.log_scalar('Final Results', results, 0)

    return results
