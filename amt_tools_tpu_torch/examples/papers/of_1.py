"""Onsets & Frames (V1) w/ Mel spectrogram on MAPS.

The port's twin of ``examples/papers/of_1.py`` (the reference recipe
``examples/papers/of_1.py``): 16 kHz audio, 229-band Mel spectrogram,
625-frame crops, batch 8, Adam lr 6e-4, 2000 iterations; train on
synthesized pianos, test on the real (ENSTDk) pianos with overlapping
pieces removed. ``torch.optim.Adam`` takes the place of optax's; the run
is on the card unless ``device=cpu``.

Run: ``python of_1.py [key=value overrides...]``
"""

import os
import sys

# Runnable without installation: resolve the repo root
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..', '..'))

import torch

from amt_tools_tpu_torch.datasets import MAPS, DataLoader
from amt_tools_tpu_torch.models import OnsetsFrames
from amt_tools_tpu_torch.features import MelSpec

from amt_tools_tpu_torch.train import train
from amt_tools_tpu_torch.transcribe import (ComboEstimator, NoteTranscriber,
                                            PitchListWrapper)
from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                          MultipitchEvaluator, NoteEvaluator,
                                          validate)
from amt_tools_tpu_torch.config import Experiment
from amt_tools_tpu_torch.parallel import get_mesh
import amt_tools_tpu_torch.tools as tools

EX_NAME = '_'.join([OnsetsFrames.model_name(),
                    MAPS.dataset_name(),
                    MelSpec.features_name()])

ex = Experiment(EX_NAME)


@ex.config
def config():
    # Number of samples per second of audio
    sample_rate = 16000

    # Number of samples between frames
    hop_length = 512

    # Number of consecutive frames within each example fed to the model
    num_frames = 625

    # Number of training iterations to conduct
    iterations = 2000

    # How many equally spaced save/validation checkpoints - 0 to disable
    checkpoints = 40

    # Number of samples to gather for a batch
    batch_size = 8

    # The fixed learning rate
    learning_rate = 6e-4

    # Whether to train data-parallel over the ranks torchrun starts (one
    # process per card: torchrun --nproc-per-node N of_2.py)
    data_parallel = False

    # Flag to re-acquire ground-truth data and re-calculate features
    reset_data = False

    # Root of the MAPS corpus (None -> default datasets dir)
    maps_base_dir = None

    # Run the model compute in bfloat16 (params/losses stay float32)
    bf16 = False

    # Gradient accumulation: microbatches per step (one optimizer update
    # per batch; peak activation memory of one microbatch)
    accum_steps = 1

    # Rematerialize the acoustic conv stacks: True (whole stack) or
    # 'blocks' (per conv block; lowest memory). false to disable.
    remat = False

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
def onsets_frames_run(sample_rate, hop_length, num_frames, iterations,
                      checkpoints, batch_size, learning_rate, data_parallel,
                      reset_data, maps_base_dir, bf16, accum_steps, remat,
                      num_workers, seed, device, root_dir):
    tools.seed_everything(seed)

    # Initialize the default piano profile
    profile = tools.PianoProfile()

    # Mel spectrogram with length-2048 FFT and 229 bands
    data_proc = MelSpec(sample_rate=sample_rate,
                        hop_length=hop_length,
                        n_mels=229)

    # Estimation pipeline: Multi Pitch / Onsets -> Notes & Pitch List
    validation_estimator = ComboEstimator([NoteTranscriber(profile=profile),
                                           PitchListWrapper(profile=profile)])

    # Evaluation pipeline: Loss | Multi Pitch | Notes (onset-only and w/ offsets)
    validation_evaluator = ComboEvaluator([
        LossWrapper(),
        MultipitchEvaluator(),
        NoteEvaluator(results_key=tools.KEY_NOTE_ON),
        NoteEvaluator(offset_ratio=0.2, results_key=tools.KEY_NOTE_OFF)])

    validation_evaluator.set_patterns(['loss', 'pr', 're', 'f1'])

    # Synthesized pianos train; real (ENSTDk) pianos test
    train_splits, test_splits = MAPS.available_splits(), list()
    for split in train_splits.copy():
        if split.startswith('E'):
            train_splits.remove(split)
            test_splits += [split]

    print('Loading training partition...')

    maps_cache = os.path.join(tools.DEFAULT_FEATURES_GT_DIR)

    maps_train = MAPS(base_dir=maps_base_dir,
                      splits=train_splits,
                      hop_length=hop_length,
                      sample_rate=sample_rate,
                      num_frames=num_frames,
                      data_proc=data_proc,
                      profile=profile,
                      reset_data=reset_data,
                      save_loc=maps_cache,
                      device=device)

    print('Removing overlapping tracks from training partition...')

    maps_train.remove_overlapping(test_splits)

    train_loader = DataLoader(dataset=maps_train,
                              batch_size=batch_size,
                              shuffle=True,
                              drop_last=True,
                              seed=seed,
                              num_workers=num_workers)

    print('Loading testing partition...')

    maps_test = MAPS(base_dir=maps_base_dir,
                     splits=test_splits,
                     hop_length=hop_length,
                     sample_rate=sample_rate,
                     num_frames=None,
                     data_proc=data_proc,
                     profile=profile,
                     store_data=True,
                     save_loc=maps_cache,
                     device=device)

    print('Initializing model...')

    onsetsframes = OnsetsFrames(dim_in=data_proc.get_feature_size(),
                                profile=profile,
                                in_channels=data_proc.get_num_channels(),
                                model_complexity=2,
                                detach_heads=False,
                                remat=remat,
                                dtype=torch.bfloat16 if bf16 else None)

    optimizer = torch.optim.Adam(onsetsframes.parameters(), lr=learning_rate)

    mesh = get_mesh(device=device) if data_parallel else None

    print('Training model...')

    model_dir = os.path.join(root_dir, 'models')

    train(model=onsetsframes,
          train_loader=train_loader,
          optimizer=optimizer,
          iterations=iterations,
          checkpoints=checkpoints,
          log_dir=model_dir,
          val_set=maps_test,
          estimator=validation_estimator,
          evaluator=validation_evaluator,
          seed=seed,
          mesh=mesh,
          accum_steps=accum_steps,
          device=device)

    print('Transcribing and evaluating test partition...')

    validation_evaluator.set_save_dir(os.path.join(root_dir, 'results'))
    validation_evaluator.set_patterns(None)

    final_results = validate(onsetsframes, maps_test,
                             evaluator=validation_evaluator,
                             estimator=validation_estimator, device=device)

    ex.log_scalar('Final Results', final_results, 0)
