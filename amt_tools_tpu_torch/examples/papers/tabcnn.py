"""TabCNN w/ CQT on GuitarSet (6-fold cross-validation).

The port's twin of ``examples/papers/tabcnn.py`` (the reference recipe
``examples/papers/tabcnn.py``): 22.05 kHz audio, a CQT of 192 bins at 24
per octave, 200-frame crops, batch 30, Adadelta lr 1.0, 2500 iterations,
each player held out in turn. ``torch.optim.Adadelta`` takes the place of
optax's; the run is on the card unless ``device=cpu``.

Run: ``python tabcnn.py [key=value overrides...]``
"""

import os
import sys

# Runnable without installation: resolve the repo root
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..', '..'))

import torch

from amt_tools_tpu_torch.datasets import GuitarSet, DataLoader
from amt_tools_tpu_torch.models import TabCNN
from amt_tools_tpu_torch.features import CQT

from amt_tools_tpu_torch.train import train
from amt_tools_tpu_torch.transcribe import (ComboEstimator, TablatureWrapper,
                                            StackedMultiPitchCollapser)
from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                          MultipitchEvaluator,
                                          TablatureEvaluator, SoftmaxAccuracy,
                                          validate, append_results,
                                          average_results)
from amt_tools_tpu_torch.config import Experiment
from amt_tools_tpu_torch.parallel import get_mesh
import amt_tools_tpu_torch.tools as tools

EX_NAME = '_'.join([TabCNN.model_name(),
                    GuitarSet.dataset_name(),
                    CQT.features_name()])

ex = Experiment(EX_NAME)


@ex.config
def config():
    # Number of samples per second of audio
    sample_rate = 22050

    # Number of samples between frames
    hop_length = 512

    # Number of consecutive frames within each example fed to the model
    num_frames = 200

    # Number of training iterations to conduct
    iterations = 2500

    # How many equally spaced save/validation checkpoints - 0 to disable
    checkpoints = 50

    # Number of samples to gather for a batch
    batch_size = 30

    # Whether to train data-parallel over the ranks torchrun starts (one
    # process per card)
    data_parallel = False

    # Flag to re-acquire ground-truth data and re-calculate features
    reset_data = False

    # Root of the GuitarSet corpus (None -> default datasets dir)
    gset_base_dir = None

    # Number of cross-validation folds to run (paper recipe: all 6)
    folds = 6

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
def tabcnn_cross_val(sample_rate, hop_length, num_frames, iterations,
                     checkpoints, batch_size, data_parallel, reset_data,
                     gset_base_dir, folds, bf16, num_workers, seed, device,
                     root_dir):
    # Initialize the default guitar profile
    profile = tools.GuitarProfile(num_frets=19)

    # CQT spanning 8 octaves w/ 2 bins per semitone
    data_proc = CQT(sample_rate=sample_rate,
                    hop_length=hop_length,
                    n_bins=192,
                    bins_per_octave=24)

    # Estimation pipeline: Tablature -> Stacked Multi Pitch -> Multi Pitch
    validation_estimator = ComboEstimator([
        TablatureWrapper(profile=profile),
        StackedMultiPitchCollapser(profile=profile)])

    # Evaluation pipeline: Loss | Multi Pitch | Tablature | Accuracy
    validation_evaluator = ComboEvaluator([LossWrapper(),
                                           MultipitchEvaluator(),
                                           TablatureEvaluator(profile=profile),
                                           SoftmaxAccuracy()])

    gset_cache = os.path.join(tools.DEFAULT_FEATURES_GT_DIR)

    mesh = get_mesh(device=device) if data_parallel else None

    results = dict()

    # Perform each fold of cross-validation
    for k in range(folds):
        tools.seed_everything(seed)

        validation_evaluator.set_patterns(['loss', 'pr', 're', 'f1', 'tdr',
                                           'acc'])

        train_splits = GuitarSet.available_splits()
        test_splits = [train_splits.pop(k)]

        print('Loading training partition...')

        gset_train = GuitarSet(base_dir=gset_base_dir,
                               splits=train_splits,
                               hop_length=hop_length,
                               sample_rate=sample_rate,
                               num_frames=num_frames,
                               data_proc=data_proc,
                               profile=profile,
                               reset_data=(reset_data and k == 0),
                               save_loc=gset_cache,
                               device=device)

        train_loader = DataLoader(dataset=gset_train,
                                  batch_size=batch_size,
                                  shuffle=True,
                                  drop_last=True,
                                  seed=seed,
                                  num_workers=num_workers)

        print(f'Loading testing partition (player {test_splits[0]})...')

        gset_test = GuitarSet(base_dir=gset_base_dir,
                              splits=test_splits,
                              hop_length=hop_length,
                              sample_rate=sample_rate,
                              num_frames=None,
                              data_proc=data_proc,
                              profile=profile,
                              store_data=True,
                              save_loc=gset_cache,
                              device=device)

        print('Initializing model...')

        tabcnn = TabCNN(dim_in=data_proc.get_feature_size(),
                        profile=profile,
                        in_channels=data_proc.get_num_channels(),
                        dtype=torch.bfloat16 if bf16 else None)

        # Adadelta optimizer with lr 1.0 (paper recipe)
        optimizer = torch.optim.Adadelta(tabcnn.parameters(), lr=1.0)

        print('Training model...')

        model_dir = os.path.join(root_dir, 'models', f'fold-{k}')

        train(model=tabcnn,
              train_loader=train_loader,
              optimizer=optimizer,
              iterations=iterations,
              checkpoints=checkpoints,
              log_dir=model_dir,
              val_set=gset_test,
              estimator=validation_estimator,
              evaluator=validation_evaluator,
              seed=seed,
              mesh=mesh,
              device=device)

        print(f'Transcribing and evaluating test partition (player '
              f'{test_splits[0]})...')

        validation_evaluator.set_save_dir(os.path.join(root_dir, 'results'))
        validation_evaluator.set_patterns(None)

        fold_results = validate(tabcnn, gset_test,
                                evaluator=validation_evaluator,
                                estimator=validation_estimator, device=device)

        results = append_results(results, fold_results)

        validation_evaluator.reset_results()

        ex.log_scalar('Fold Results', fold_results, k)

    ex.log_scalar('Overall Results', average_results(results), 0)
