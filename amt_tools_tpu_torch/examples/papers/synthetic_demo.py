"""End-to-end demo experiment on synthetic data (no downloads needed).

The port's twin of ``examples/papers/synthetic_demo.py``: the complete
experiment plumbing (config resolution, run tracking, dataset, training
with checkpoint-interleaved validation, final evaluation) on procedurally
generated piano tracks with exact ground truth. A miniature of the
``of_1.py`` recipe that finishes in minutes on one card; on the card the
training steps run kernels A (features), E and F (the language models).

Run: ``python synthetic_demo.py [key=value overrides...]``
     e.g. ``python synthetic_demo.py iterations=50 device=cpu``
"""

import os
import sys

# Runnable without installation: resolve the repo root
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..', '..'))

import torch

from amt_tools_tpu_torch.datasets import SyntheticPiano, DataLoader
from amt_tools_tpu_torch.models import OnsetsFrames, OnsetsFrames2
from amt_tools_tpu_torch.features import MelSpec

from amt_tools_tpu_torch.train import train, warmup_cosine_schedule
from amt_tools_tpu_torch.transcribe import ComboEstimator, NoteTranscriber
from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                          MultipitchEvaluator, NoteEvaluator,
                                          VelocityEvaluator, validate)
from amt_tools_tpu_torch.config import Experiment
from amt_tools_tpu_torch.parallel import get_mesh
import amt_tools_tpu_torch.tools as tools

ex = Experiment('OnsetsFrames_SyntheticPiano_MelSpec')


@ex.config
def config():
    # Number of samples per second of audio
    sample_rate = 16000

    # Number of samples between frames
    hop_length = 512

    # Number of consecutive frames within each example fed to the model
    num_frames = 312

    # Number of training iterations (passes over the synthetic set)
    iterations = 200

    # How many equally spaced save/validation checkpoints - 0 to disable
    checkpoints = 4

    # Number of samples to gather for a batch
    batch_size = 8

    # The base learning rate
    learning_rate = 6e-4

    # Optimizer steps of linear LR warmup, then cosine decay to zero over
    # the run; 0 disables the schedule (constant LR)
    warmup_steps = 60

    # Synthetic data parameters
    num_train_tracks = 48
    num_test_tracks = 8
    track_duration = 12.0
    notes_per_track = 30

    # Domain difficulty (defaults = clean tones; e.g.
    # ``noise_snr_db=12 reverb_time=0.25 timbre_jitter=0.3
    # velocity_range=[0.4,1.0]`` for the stress domain)
    noise_snr_db = None
    reverb_time = 0.0
    velocity_range = None
    timbre_jitter = 0.0

    # Use OnsetsFrames2 with the velocity head (trains/evaluates per-pitch
    # note velocities); requires velocity_range for non-trivial targets
    estimate_velocity = False

    # Whether to train data-parallel over the ranks torchrun starts (one
    # process per card)
    data_parallel = False

    # Run the model compute in bfloat16 (params/losses stay float32)
    bf16 = False

    # Gradient accumulation: split each batch into this many microbatches
    # (one optimizer update per batch; peak activation memory of one
    # microbatch). Composes with remat.
    accum_steps = 1

    # Rematerialize the acoustic conv stacks in the backward pass:
    # True (whole stack) or 'blocks' (per conv block; lowest memory).
    # false to disable.
    remat = False

    # The JAX package's grouped language models; the port has no fused
    # layouts yet, so true raises
    fused_lms = False

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
def synthetic_demo(sample_rate, hop_length, num_frames, iterations,
                   checkpoints, batch_size, learning_rate, warmup_steps,
                   num_train_tracks, num_test_tracks, track_duration,
                   notes_per_track, noise_snr_db, reverb_time,
                   velocity_range, timbre_jitter, estimate_velocity,
                   data_parallel, bf16, accum_steps, remat, fused_lms,
                   num_workers, seed, device, root_dir):
    if fused_lms:
        raise NotImplementedError('fused_lms: the port has no fused '
                                  'language-model layout yet')
    difficulty = dict(noise_snr_db=noise_snr_db, reverb_time=reverb_time,
                      velocity_range=(tuple(velocity_range)
                                      if velocity_range else None),
                      timbre_jitter=timbre_jitter)
    tools.seed_everything(seed)

    profile = tools.PianoProfile()

    data_proc = MelSpec(sample_rate=sample_rate, hop_length=hop_length,
                        n_mels=229)

    validation_estimator = ComboEstimator([
        NoteTranscriber(profile=profile, minimum_duration=0.05)])

    evaluators = [LossWrapper(),
                  MultipitchEvaluator(),
                  NoteEvaluator(results_key=tools.KEY_NOTE_ON)]
    if estimate_velocity:
        evaluators.append(VelocityEvaluator())
    validation_evaluator = ComboEvaluator(evaluators)
    validation_evaluator.set_patterns(['loss', 'f1', 'mae'])

    print('Generating synthetic partitions...')

    train_set = SyntheticPiano(base_dir=os.path.join(root_dir, 'data_train'),
                               data_proc=data_proc, num_frames=num_frames,
                               num_tracks=num_train_tracks,
                               track_duration=track_duration,
                               notes_per_track=notes_per_track,
                               save_data=False, seed=seed, device=device,
                               **difficulty)

    test_set = SyntheticPiano(base_dir=os.path.join(root_dir, 'data_test'),
                              data_proc=data_proc, num_frames=None,
                              num_tracks=num_test_tracks,
                              track_duration=track_duration,
                              notes_per_track=notes_per_track,
                              save_data=False, seed=seed + 1, splits=['test'],
                              device=device, **difficulty)

    train_loader = DataLoader(train_set, batch_size=batch_size, shuffle=True,
                              drop_last=True, seed=seed,
                              num_workers=num_workers)

    dtype = torch.bfloat16 if bf16 else None
    if estimate_velocity:
        model = OnsetsFrames2(dim_in=data_proc.get_feature_size(),
                              profile=profile, model_complexity=2,
                              estimate_velocity=True, remat=remat,
                              dtype=dtype)
    else:
        model = OnsetsFrames(dim_in=data_proc.get_feature_size(),
                             profile=profile, model_complexity=2,
                             remat=remat, dtype=dtype)

    mesh = get_mesh(device=device) if data_parallel else None

    # LR schedule in optimizer steps (iterations x batches per pass); its
    # step count lives in the checkpoint and survives resume
    scheduler = None
    if warmup_steps > 0:
        scheduler = warmup_cosine_schedule(
            warmup_steps, iterations * len(train_loader))

    print('Training...')

    train(model, train_loader,
          torch.optim.Adam(model.parameters(), lr=learning_rate),
          iterations=iterations, checkpoints=checkpoints,
          log_dir=os.path.join(root_dir, 'models'),
          scheduler=scheduler,
          val_set=test_set, estimator=validation_estimator,
          evaluator=validation_evaluator,
          seed=seed, mesh=mesh, accum_steps=accum_steps, device=device)

    print('Final evaluation on held-out tracks...')

    validation_evaluator.set_save_dir(os.path.join(root_dir, 'results'))
    validation_evaluator.set_patterns(None)

    results = validate(model, test_set, validation_evaluator,
                       validation_estimator, bucket=128, device=device)

    print(f"held-out frame F1: "
          f"{results[tools.KEY_MULTIPITCH][tools.KEY_F1]:.3f}")
    print(f"held-out note-onset F1: "
          f"{results[tools.KEY_NOTE_ON][tools.KEY_F1]:.3f}")
    if estimate_velocity:
        print(f"held-out velocity MAE: "
              f"{results[tools.KEY_VELOCITY]['mae']:.3f}")
        print(f"held-out velocity within 0.1: "
              f"{results[tools.KEY_VELOCITY]['within_tolerance']:.3f}")
        print(f"held-out velocity MAE (rescaled): "
              f"{results[tools.KEY_VELOCITY]['mae_rescaled']:.3f}")
        print(f"held-out velocity within 0.1 (rescaled): "
              f"{results[tools.KEY_VELOCITY]['within_tolerance_rescaled']:.3f}")

    ex.log_scalar('Final Results', results, 0)

    return results
