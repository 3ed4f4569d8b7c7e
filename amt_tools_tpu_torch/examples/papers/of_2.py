"""Onsets & Frames (V2) w/ HTK-Mel spectrogram on MAESTRO.

The port's twin of ``examples/papers/of_2.py`` (the reference recipe
``examples/papers/of_2.py``): 16 kHz audio, 229 HTK mel bands, model
complexity 3 with detached heads, batch 8, Adam lr 6e-4, 2000 iterations;
validate on the MAESTRO validation split, final evaluation on the MAESTRO
test split and the real-piano MAPS (ENSTDk) splits. ``torch.optim.Adam``
takes the place of optax's; the run is on the card unless ``device=cpu``.

Run: ``python of_2.py [key=value overrides...]``
"""

import os
import sys

# Runnable without installation: resolve the repo root
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..', '..'))

import torch

from amt_tools_tpu_torch.datasets import MAESTRO_V3, MAPS, DataLoader
from amt_tools_tpu_torch.models import OnsetsFrames2
from amt_tools_tpu_torch.features import MelSpec

from amt_tools_tpu_torch.train import train, warmup_cosine_schedule
from amt_tools_tpu_torch.transcribe import (ComboEstimator, NoteTranscriber,
                                            PitchListWrapper)
from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                          MultipitchEvaluator, NoteEvaluator,
                                          validate)
from amt_tools_tpu_torch.config import Experiment
from amt_tools_tpu_torch.parallel import get_mesh
import amt_tools_tpu_torch.tools as tools

EX_NAME = '_'.join([OnsetsFrames2.model_name(),
                    MAESTRO_V3.dataset_name(),
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

    # Optimizer steps of linear LR warmup followed by cosine decay to zero
    # over the run; 0 keeps the reference's constant learning rate. One
    # iteration = one pass over the loader (len(train_loader) optimizer
    # steps), the same accounting as the reference (its train.py:118-122).
    warmup_steps = 0

    # Train the O&F2 velocity head (per-pitch note velocities from the
    # MIDI ground truth; masked MSE at onset locations)
    estimate_velocity = False

    # Whether to train data-parallel over the ranks torchrun starts (one
    # process per card: torchrun --nproc-per-node N of_2.py)
    data_parallel = False

    # Flag to re-acquire ground-truth data and re-calculate features
    reset_data = False

    # Roots of the MAESTRO / MAPS corpora (None -> default datasets dir)
    maestro_base_dir = None
    maps_base_dir = None

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

    # Run the independent language models (onset/offset/velocity) as one
    # grouped BiLSTM: the same math, one grouped launch of kernels E and F
    # a step for all their directions. Serve/export such checkpoints as
    # they are, or convert with models.unfuse_lm_variables.
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
def onsets_frames_2_run(sample_rate, hop_length, num_frames, iterations,
                        checkpoints, batch_size, learning_rate, warmup_steps,
                        estimate_velocity, data_parallel, reset_data,
                        maestro_base_dir, maps_base_dir, bf16,
                        accum_steps, remat, fused_lms, num_workers, seed,
                        device, root_dir):
    tools.seed_everything(seed)

    profile = tools.PianoProfile()

    # Mel spectrogram with HTK frequency mapping (O&F2 / Magenta convention)
    data_proc = MelSpec(sample_rate=sample_rate,
                        hop_length=hop_length,
                        n_mels=229,
                        htk=True)

    validation_estimator = ComboEstimator([NoteTranscriber(profile=profile),
                                           PitchListWrapper(profile=profile)])

    validation_evaluator = ComboEvaluator([
        LossWrapper(),
        MultipitchEvaluator(),
        NoteEvaluator(results_key=tools.KEY_NOTE_ON),
        NoteEvaluator(offset_ratio=0.2, results_key=tools.KEY_NOTE_OFF)])

    validation_evaluator.set_patterns(['loss', 'pr', 're', 'f1'])

    data_cache = os.path.join(tools.DEFAULT_FEATURES_GT_DIR)

    print('Loading training partition...')

    mstro_train = MAESTRO_V3(base_dir=maestro_base_dir,
                             splits=['train'],
                             hop_length=hop_length,
                             sample_rate=sample_rate,
                             num_frames=num_frames,
                             data_proc=data_proc,
                             profile=profile,
                             reset_data=reset_data,
                             store_data=False,
                             save_loc=data_cache,
                             device=device)

    train_loader = DataLoader(dataset=mstro_train,
                              batch_size=batch_size,
                              shuffle=True,
                              drop_last=True,
                              seed=seed,
                              num_workers=num_workers)

    print('Loading validation partition...')

    mstro_val = MAESTRO_V3(base_dir=maestro_base_dir,
                           splits=['validation'],
                           hop_length=hop_length,
                           sample_rate=sample_rate,
                           num_frames=None,
                           data_proc=data_proc,
                           profile=profile,
                           store_data=False,
                           save_loc=data_cache,
                           device=device)

    print('Loading testing partitions...')

    mstro_test = MAESTRO_V3(base_dir=maestro_base_dir,
                            splits=['test'],
                            hop_length=hop_length,
                            sample_rate=sample_rate,
                            num_frames=None,
                            data_proc=data_proc,
                            profile=profile,
                            store_data=False,
                            save_loc=data_cache,
                            device=device)

    # Real-piano MAPS splits as the out-of-domain test set
    maps_test = MAPS(base_dir=maps_base_dir,
                     splits=['ENSTDkAm', 'ENSTDkCl'],
                     hop_length=hop_length,
                     sample_rate=sample_rate,
                     num_frames=None,
                     data_proc=data_proc,
                     profile=profile,
                     store_data=False,
                     save_loc=data_cache,
                     device=device)

    print('Initializing model...')

    onsetsframes = OnsetsFrames2(dim_in=data_proc.get_feature_size(),
                                 profile=profile,
                                 in_channels=data_proc.get_num_channels(),
                                 model_complexity=3,
                                 detach_heads=True,
                                 estimate_velocity=estimate_velocity,
                                 remat=remat,
                                 fused_lms=fused_lms,
                                 dtype=torch.bfloat16 if bf16 else None)

    optimizer = torch.optim.Adam(onsetsframes.parameters(), lr=learning_rate)

    # Optional warmup + cosine decay, expressed in optimizer steps: the
    # schedule's count lives in the checkpoint and survives resume.
    scheduler = None
    if warmup_steps > 0:
        total_steps = iterations * len(train_loader)
        scheduler = warmup_cosine_schedule(warmup_steps, total_steps)

    mesh = get_mesh(device=device) if data_parallel else None

    print('Training model...')

    model_dir = os.path.join(root_dir, 'models')

    train(model=onsetsframes,
          train_loader=train_loader,
          optimizer=optimizer,
          iterations=iterations,
          checkpoints=checkpoints,
          log_dir=model_dir,
          scheduler=scheduler,
          val_set=mstro_val,
          estimator=validation_estimator,
          evaluator=validation_evaluator,
          seed=seed,
          mesh=mesh,
          accum_steps=accum_steps,
          device=device)

    print('Transcribing and evaluating test partitions...')

    validation_evaluator.set_save_dir(os.path.join(root_dir, 'results',
                                                   'maestro'))
    validation_evaluator.set_patterns(None)

    maestro_results = validate(onsetsframes, mstro_test,
                               evaluator=validation_evaluator,
                               estimator=validation_estimator, device=device)
    ex.log_scalar('MAESTRO Results', maestro_results, 0)
    validation_evaluator.reset_results()

    validation_evaluator.set_save_dir(os.path.join(root_dir, 'results', 'maps'))

    maps_results = validate(onsetsframes, maps_test,
                            evaluator=validation_evaluator,
                            estimator=validation_estimator, device=device)
    ex.log_scalar('MAPS Results', maps_results, 0)
