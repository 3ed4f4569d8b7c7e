"""Training loop: the train step, checkpoints and resume.

Counterpart of ``amt_tools_tpu/train.py`` (``:92-534``). The JAX package's
functional ``TrainState`` becomes the model (parameters and BatchNorm
buffers) and the optimizer themselves, plus the step count, the run's seed
and the scheduler's count, which a checkpoint holds beside them:

- :func:`make_train_step`: one optimizer update from a batch, with
  in-step gradient accumulation over ``accum_steps`` microbatches;
- :func:`train`: one pass over the loader per iteration, checkpoints,
  resume from the newest ``model-<iter>.ckpt``, a per-step LR multiplier
  ``scheduler``; ``log_dir=None`` runs without writing anything;
- dropout draws from a generator seeded from (run seed, step), the
  counterpart of ``fold_in(state.rng, state.step)`` (``:139``), so a
  resumed run continues exactly without saving generator state.

On the card the language models' recurrences run kernels E and F (through
``ops.lstm_kernel.lstm_scan_grad``). With ``val_set``, ``evaluator`` (and
an ``estimator``) each checkpoint runs ``evaluate.validate`` on the same
device, bucketed (``val_bucket``, kernel B with lengths) and
``val_batch_size`` tracks a forward, then ``evaluator.finalize(writer,
step)``, as JAX ``train.py:402-406``. Validation runs in eval mode without
autograd and draws no random numbers, so the training steps' losses are
those of a run without it, bit for bit.

With a ``mesh`` (``parallel.get_mesh``; one process per device, every
process calling :func:`train` with the same loader) the step is data
parallel over the mesh's ``data`` dimension, as JAX's ``train(mesh=...)``:

- each rank takes its rows of every global batch (``shard_batch``);
- the parameters, buffers and optimizer state start as rank 0's
  (``replicate``);
- the train-mode BatchNorms take the global batch's statistics and the
  dropout masks are the global batch's (``ops.layers``);
- after the backward (after the last microbatch with ``accum_steps``) one
  flat all-reduce per dtype averages the gradients, and the losses are
  the global means;
- the mesh's first rank alone writes checkpoints, logs, validates and
  calls ``vis_fnc``;
  every rank resumes.

So the steps equal the one-process steps on the global batch, to float
sums in another order (bit for bit on one rank).
"""

import contextlib
import math
import os
import re

import numpy as np
import torch
import torch.distributed as dist

from . import tools
from .evaluate import validate
from .models.common import run_on_batch
from .ops.layers import BatchNorm, BatchShardGenerator
from .parallel.collectives import all_reduce, average_gradients
from .parallel.mesh import _axis, replicate, shard_batch

__all__ = [
    'make_train_step',
    'train',
    'step_generator',
    'trainable_batch',
    'warmup_cosine_schedule',
    'save_checkpoint',
    'load_checkpoint',
    'latest_checkpoint',
]


def step_generator(seed, step, device):
    """The dropout generator of one step: seeded from (run seed, step), on
    ``device``."""

    words = np.random.SeedSequence((seed, step)).generate_state(2, np.uint32)
    generator = torch.Generator(device=device)
    generator.manual_seed((int(words[0]) << 31) | (int(words[1]) >> 1))

    return generator


def _split(batch, accum_steps):
    """A batch dict -> ``accum_steps`` microbatch dicts along dim 0."""

    for key, value in batch.items():
        if value.shape[0] % accum_steps:
            raise ValueError(f'batch size {value.shape[0]} ({key}) is not '
                             f'divisible by accum_steps={accum_steps}')

    chunks = {key: value.chunk(accum_steps) for key, value in batch.items()}

    return [{key: chunks[key][k] for key in batch}
            for k in range(accum_steps)]


@contextlib.contextmanager
def _global_statistics(model, group):
    """The model's BatchNorms take statistics over ``group`` inside."""

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for norm in norms:
        norm.process_group = group
    try:
        yield
    finally:
        for norm in norms:
            norm.process_group = None


def _global_mean(loss, group, size):
    """A loss dict's values averaged over ``group``: one all-reduce."""

    keys = sorted(loss)
    values = torch.stack([loss[key].float() for key in keys])
    values = all_reduce(values, group) / size

    return {key: values[k] for k, key in enumerate(keys)}


def make_train_step(model, optimizer, accum_steps=1, mesh=None):
    """Build the training step for a model + optimizer pair.

    ``step(batch, generator)`` runs ``run_on_batch(train=True)``, back-
    propagates the total loss and applies one optimizer update; it returns
    the loss dict as detached tensors. ``accum_steps`` > 1 splits the batch
    into that many microbatches, sums their gradients, divides by
    ``accum_steps`` and applies one update: the per-microbatch average,
    with the BatchNorm statistics threading through the microbatches in
    turn and each microbatch drawing its own dropout noise.

    With a ``mesh`` that has a ``data`` dimension, ``batch`` is this rank's
    rows of the global batch (microbatch k of the rank's batch its rows of
    global microbatch k) and ``generator`` the step's generator, the same
    on every rank: BatchNorm statistics and dropout masks are the global
    batch's, the gradients are averaged over ``data`` once after the last
    microbatch, and the returned losses are the global means.
    """

    data = None
    if mesh is not None and 'data' in mesh.mesh_dim_names:
        data = _axis(mesh, 'data')

    def step(batch, generator=None):
        optimizer.zero_grad(set_to_none=True)
        micro = [batch] if accum_steps == 1 else _split(batch, accum_steps)

        group = None
        if data is not None:
            group, size, index = data
            if generator is not None:
                generator = BatchShardGenerator(generator, index, size)

        total = None
        with _global_statistics(model, group):
            for microbatch in micro:
                loss = run_on_batch(model, microbatch, train=True,
                                    generator=generator)[tools.KEY_LOSS]
                loss[tools.KEY_LOSS_TOTAL].backward()

                loss = {key: value.detach() for key, value in loss.items()}
                total = loss if total is None else {
                    key: total[key] + loss[key] for key in total}

        if data is not None:
            average_gradients(model.parameters(), group)
            total = _global_mean(total, group, size)

        if accum_steps > 1:
            for param in model.parameters():
                if param.grad is not None:
                    param.grad.div_(accum_steps)
            total = {key: value / accum_steps for key, value in total.items()}

        optimizer.step()

        return total

    return step


##################################################
# CHECKPOINTING                                  #
##################################################


def _checkpoint_path(log_dir, iteration):
    return os.path.join(os.path.abspath(log_dir),
                        f'{tools.MODEL_STATE}-{iteration}.{tools.CKPT_EXT}')


def save_checkpoint(log_dir, iteration, model, optimizer, step, seed,
                    scheduler=None):
    """Save the training state under ``log_dir/model-<iteration>.ckpt``:
    the model (parameters and buffers), the optimizer, the scheduler's
    state, the step count and the run's seed."""

    path = _checkpoint_path(log_dir, iteration)
    state = {'model': model.state_dict(), 'optimizer': optimizer.state_dict(),
             'scheduler': scheduler, 'step': step, 'seed': seed}

    # Written under another name and renamed, so a crash never leaves a
    # partial file under the checkpoint's name
    partial = f'{path}.partial'
    torch.save(state, partial)
    os.replace(partial, path)

    return path


def load_checkpoint(path, model, optimizer):
    """Restore a checkpoint of :func:`save_checkpoint` into ``model`` and
    ``optimizer``; returns ``{'step', 'seed', 'scheduler'}``."""

    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state['model'])
    optimizer.load_state_dict(state['optimizer'])

    return {key: state[key] for key in ('step', 'seed', 'scheduler')}


def latest_checkpoint(log_dir, max_iteration=None):
    """The newest checkpoint (optionally at most ``max_iteration``):
    ``(path, iteration)``, or ``(None, 0)``."""

    if not os.path.isdir(log_dir):
        return None, 0

    pattern = re.compile(rf'^{tools.MODEL_STATE}-(\d+)\.{tools.CKPT_EXT}$')

    candidates = []
    for name in os.listdir(log_dir):
        match = pattern.match(name)
        if match:
            iteration = int(match.group(1))
            if max_iteration is None or iteration <= max_iteration:
                candidates.append((iteration, name))

    if not candidates:
        return None, 0

    iteration, name = max(candidates)

    return os.path.join(os.path.abspath(log_dir), name), iteration


##################################################
# TRAIN LOOP                                     #
##################################################


def warmup_cosine_schedule(warmup_steps, decay_steps):
    """An LR multiplier for ``train(scheduler=...)``: linear from 0 to 1
    over ``warmup_steps`` optimizer steps, then a cosine to 0 at
    ``decay_steps``, as ``optax.warmup_cosine_decay_schedule(0.0, 1.0,
    warmup_steps, decay_steps)`` gives it."""

    def schedule(step):
        if step < warmup_steps:
            return step / warmup_steps
        span = max(1, decay_steps - warmup_steps)
        done = min(step - warmup_steps, span) / span

        return 0.5 * (1.0 + math.cos(math.pi * done))

    return schedule


class _Schedule:
    """An LR multiplier per optimizer step, as ``optax.scale_by_schedule``
    chained after the optimizer: step n's update is scaled by
    ``fn(n)``, here by setting each group's lr to its base lr times it."""

    def __init__(self, fn, optimizer, state=None):
        self.fn = fn
        self.optimizer = optimizer
        if state is None:
            state = {'count': 0,
                     'base_lrs': [g['lr'] for g in optimizer.param_groups]}
        self.count = state['count']
        self.base_lrs = list(state['base_lrs'])

    def apply(self):
        multiplier = float(self.fn(self.count))
        for group, base_lr in zip(self.optimizer.param_groups, self.base_lrs):
            group['lr'] = base_lr * multiplier
        self.count += 1

    def state(self):
        return {'count': self.count, 'base_lrs': self.base_lrs}


def train(model, train_loader, optimizer, iterations, checkpoints=0,
          log_dir='.', scheduler=None, resume=True, single_batch=False,
          val_set=None, estimator=None, evaluator=None, seed=0, writer=None,
          accum_steps=1, device=None, val_bucket=128, val_batch_size=1,
          mesh=None, vis_fnc=None):
    """Training loop, one pass over ``train_loader`` per iteration.

    ``optimizer`` is a ``torch.optim`` optimizer over ``model``'s
    parameters; the model moves to ``device`` (the card unless the caller
    names one). ``scheduler`` maps the optimizer step count to a multiplier
    on each base learning rate (its count lives in the checkpoint).
    ``seed`` seeds the per-step dropout generators. ``checkpoints`` equally
    spaced saves go to ``log_dir`` (and one at the end); with ``resume`` the
    newest checkpoint at most ``iterations`` is loaded first. ``log_dir=None``
    runs ephemerally: no saves, no resume scan. ``writer`` is any object
    with ``add_scalar`` (default: a no-op); each pass's mean losses go to
    ``train/loss/<key>``. With ``val_set`` and ``evaluator`` every
    checkpoint (not the final save alone, as in JAX) validates the model:
    ``evaluate.validate(..., bucket=val_bucket, batch_size=val_batch_size)``
    with ``estimator``, then ``evaluator.finalize(writer, iteration)``.
    ``vis_fnc(model, optimizer, iteration)`` is called at every checkpoint
    and after the last iteration, as JAX calls ``vis_fnc(model, state,
    iteration)`` (the optimizer takes the place of the ``TrainState``).
    ``mesh`` (``parallel.get_mesh``) trains data-parallel over its ``data``
    dimension (the module docstring); every rank calls this with the same
    loader and arguments, and ``device`` is the rank's own.

    Returns ``{'step': steps taken in all, 'losses': {key: [one float per
    step of this call]}}``.
    """

    if scheduler is not None and not callable(scheduler):
        raise ValueError('scheduler must be a callable mapping the step '
                         'count to an LR multiplier')

    device = tools.resolve_device(device)
    model.to(device)
    if mesh is not None:
        replicate(model, mesh)
        replicate(optimizer, mesh)
    # With a mesh, its first rank alone writes, logs and validates
    leader = mesh is None or not any(mesh.get_coordinate())

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    if writer is None or not leader:
        writer = _NullWriter()

    step = 0
    schedule_state = None
    start_iter = 0
    if resume and log_dir is not None:
        path, ckpt_iter = latest_checkpoint(log_dir, max_iteration=iterations)
        if path is not None:
            state = load_checkpoint(path, model, optimizer)
            step, seed = state['step'], state['seed']
            schedule_state = state['scheduler']
            start_iter = ckpt_iter

    schedule = None if scheduler is None else _Schedule(scheduler, optimizer,
                                                        schedule_state)
    train_step = make_train_step(model, optimizer, accum_steps=accum_steps,
                                 mesh=mesh)

    history = {}
    for global_iter in range(start_iter, iterations):
        pass_losses = []
        for batch in train_loader:
            if schedule is not None:
                schedule.apply()
            loss = train_step(_place_batch(batch, device, mesh, accum_steps),
                              step_generator(seed, step, device))
            pass_losses.append(loss)
            step += 1

            if single_batch:
                break

        if pass_losses:
            # One transfer for the pass's losses
            keys = sorted(pass_losses[0])
            values = torch.stack([torch.stack([loss[k].float() for k in keys])
                                  for loss in pass_losses]).cpu().numpy()
            for k, key in enumerate(keys):
                history.setdefault(key, []).extend(values[:, k].tolist())
                writer.add_scalar(f'{tools.TRAIN}/{tools.KEY_LOSS}/{key}',
                                  float(values[:, k].mean()),
                                  global_step=global_iter + 1)

        local_iter = global_iter - start_iter
        checkpoint = checkpoints > 0 and (
            (local_iter + 1) % max(1, iterations // checkpoints) == 0)
        if log_dir is not None and (checkpoint or global_iter + 1 == iterations):
            if leader:
                save_checkpoint(log_dir, global_iter + 1, model, optimizer,
                                step, seed,
                                None if schedule is None else schedule.state())
            if mesh is not None:
                # No rank returns (and may resume) before the file is there:
                # each barrier, from the last dimension, releases the ranks
                # that meet one released before
                for axis in reversed(mesh.mesh_dim_names):
                    dist.barrier(group=mesh.get_group(axis))

        if (leader and vis_fnc is not None and
                (checkpoint or global_iter + 1 == iterations)):
            vis_fnc(model, optimizer, global_iter + 1)

        if (leader and checkpoint and val_set is not None and
                evaluator is not None):
            validate(model, val_set, evaluator, estimator, bucket=val_bucket,
                     batch_size=val_batch_size, device=device)
            evaluator.finalize(writer, global_iter + 1)

    return {'step': step, 'losses': history}


def trainable_batch(batch):
    """Strip unbatchable entries (track ids, notes, pitch lists) from a
    batch."""

    return {key: value for key, value in batch.items()
            if tools.utils._is_array(value) and key not in
            (tools.KEY_NOTES, tools.KEY_PITCHLIST, tools.KEY_TRACK)}


def _place_batch(batch, device, mesh=None, accum_steps=1):
    """A host batch -> tensors on ``device``; with a ``mesh`` this rank's
    rows, microbatch by microbatch (its rows of each of the
    ``accum_steps`` microbatches, in turn). Raw audio and frame times stay
    behind when there are features: the step trains on features and
    frame-aligned labels."""

    batch = trainable_batch(batch)

    if tools.KEY_FEATS in batch:
        for key in (tools.KEY_AUDIO, tools.KEY_TIMES):
            batch.pop(key, None)

    batch = {key: torch.as_tensor(np.asarray(value))
             for key, value in batch.items()}
    if mesh is None:
        return {key: value.to(device) for key, value in batch.items()}

    parts = [shard_batch(micro, mesh) for micro in _split(batch, accum_steps)]

    return {key: torch.cat([part[key] for part in parts]) for key in batch}


class _NullWriter:
    """The default scalar writer: writes nothing."""

    def add_scalar(self, *args, **kwargs):
        pass

    def close(self):
        pass
