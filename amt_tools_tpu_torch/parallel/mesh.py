"""Device meshes and data-parallel placement over ``torch.distributed``.

Counterpart of ``amt_tools_tpu/parallel/mesh.py``. JAX runs one controller
over a ``jax.sharding.Mesh`` of devices; PyTorch runs one process per
device, so the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of
process ranks with named dimensions (``data``, ``model``, ``pipe``), each
dimension a process group.

A sharded value is the rank's plain local tensor: ``shard_batch`` returns
this rank's rows of the global batch, ``shard_time`` its block of frames,
``shard_params_tp`` its columns of a kernel, ``shard_params_pp`` its
stage. DTensors are not used: the Hopper kernels read their operands
through raw pointers, and their wrappers refuse a DTensor.
:func:`data_parallel_shardings` names the layout of each as DTensor
placements.
"""

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .. import tools
from .collectives import broadcast_tensors

__all__ = [
    'get_mesh',
    'shard_batch',
    'pad_shard_batch',
    'replicate',
    'data_parallel_shardings',
    'local_batch_to_global',
]


def _init_from_env(backend, device):
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)."""

    missing = [key for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                               'MASTER_PORT') if key not in os.environ]
    if missing:
        raise RuntimeError(
            f'no process group and no torchrun environment ({", ".join(missing)} '
            f'unset): start with torchrun --nproc-per-node N, or call '
            f'torch.distributed.init_process_group first')
    if device.type == 'cuda':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    dist.init_process_group(backend, init_method='env://')


def get_mesh(devices=None, axis_names=('data',), shape=None, backend=None,
             device=None):
    """A ``DeviceMesh`` over process ranks; 1-D over all of them by default.

    ``devices`` lists the ranks (default: every rank of the default group);
    ``shape`` reshapes them for a multi-dimensional mesh, e.g.
    ``get_mesh(axis_names=('data', 'model'), shape=(4, 2))``. Every rank
    calls this, also those outside ``devices``.

    Without a process group one is first joined from the environment that
    ``torchrun`` sets (the counterpart of ``jax.distributed.initialize``),
    with ``backend`` (default NCCL on CUDA, gloo on the CPU). ``device``
    picks the mesh's device type: CUDA unless the caller names one.
    """

    device = tools.resolve_device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if not dist.is_initialized():
        _init_from_env(backend, device)

    if devices is None:
        devices = range(dist.get_world_size())
    ranks = torch.as_tensor(np.asarray(list(devices), dtype=np.int64))

    if shape is not None:
        ranks = ranks.reshape(shape)
    elif len(axis_names) != 1:
        raise ValueError('shape is required for multi-axis meshes.')
    if ranks.dim() != len(axis_names):
        raise ValueError(f'a mesh of shape {tuple(ranks.shape)} needs '
                         f'{ranks.dim()} axis names, got {axis_names}')

    return DeviceMesh(device.type, ranks, mesh_dim_names=tuple(axis_names))


def _axis(mesh, axis):
    """(group, size, this rank's index) of a mesh dimension."""

    group = mesh.get_group(axis)

    return group, dist.get_world_size(group), dist.get_rank(group)


def _device(mesh):
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())

    return torch.device(mesh.device_type)


def _map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists and tuples."""

    if isinstance(tree, dict):
        return type(tree)((key, _map(fn, value)) for key, value in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, value) for value in tree)

    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in _leaves(value)]
    if isinstance(tree, (list, tuple)):
        return [leaf for value in tree for leaf in _leaves(value)]

    return [tree]


def _to_device(leaf, device):
    """A numpy array, tensor or number -> a tensor on ``device``."""

    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(np.asarray(leaf))

    return leaf.to(device)


def data_parallel_shardings(mesh, axis='data'):
    """(batch placements, replicated placements) of a data-parallel step,
    as DTensor placements over the mesh's dimensions: ``Shard(0)`` on
    ``axis``, ``Replicate()`` elsewhere."""

    names = mesh.mesh_dim_names
    batch = tuple(Shard(0) if name == axis else Replicate() for name in names)
    replicated = tuple(Replicate() for _ in names)

    return batch, replicated


def shard_batch(batch, mesh, axis='data'):
    """This rank's rows of a host batch (nested dicts, lists, tuples of
    arrays), as tensors on the mesh's device.

    Leaves whose leading dimension is not divisible by the ``axis`` size
    (or scalars) are kept whole instead. Keeping a batched leaf whole means
    every rank runs the FULL batch (axis-size times the work), so a
    warning is raised when that happens; use a divisible batch size (drop
    the remainder in the loader) or :func:`pad_shard_batch`.
    """

    _, size, index = _axis(mesh, axis)
    device = _device(mesh)

    def place(leaf):
        shape = np.shape(leaf)
        if len(shape) >= 1 and shape[0] % size == 0:
            rows = shape[0] // size
            return _to_device(leaf[index * rows:(index + 1) * rows], device)
        if len(shape) >= 1 and shape[0] > 1:
            warnings.warn(
                f'shard_batch: leaf with leading dim {shape[0]} is not '
                f'divisible by mesh axis "{axis}" ({size}); replicating '
                f'it — every device computes the full batch. Use a divisible '
                f'batch size or pad_shard_batch().', stacklevel=3)
        return _to_device(leaf, device)

    return _map(place, batch)


def pad_shard_batch(batch, mesh, axis='data'):
    """Zero-pad batched leaves to a mesh-divisible size, then shard.

    Returns ``(local_batch, valid)``: this rank's rows of the padded batch
    and of a bool vector over the padded leading axis marking real
    examples. Callers use it to mask per-example losses and metrics;
    padding rows are zeros. Leaves whose leading dimension differs from the
    (majority) batch size are kept whole.
    """

    _, size, index = _axis(mesh, axis)
    device = _device(mesh)

    sizes = [np.shape(leaf)[0] for leaf in _leaves(batch)
             if len(np.shape(leaf)) >= 1]
    if not sizes:
        raise ValueError('pad_shard_batch: no batched leaves to shard.')
    batch_size = max(set(sizes), key=sizes.count)
    padded_size = -(-batch_size // size) * size
    rows = padded_size // size
    start = index * rows

    def place(leaf):
        shape = np.shape(leaf)
        if len(shape) < 1 or shape[0] != batch_size:
            return _to_device(leaf, device)
        # Only the real rows of this rank's block are read
        real = leaf[start:min(start + rows, batch_size)]
        real = _to_device(real, device)
        pad = torch.zeros((rows - real.shape[0],) + tuple(real.shape[1:]),
                          dtype=real.dtype, device=device)
        return torch.cat([real, pad])

    valid = torch.arange(start, start + rows, device=device) < batch_size

    return _map(place, batch), valid


def _tensors(tree):
    """The tensors a ``replicate`` call overwrites: a module's parameters
    and buffers, an optimizer's state, or a tree's tensor leaves."""

    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.optim.Optimizer):
        return [value for state in tree.state.values()
                for value in state.values() if isinstance(value, torch.Tensor)]

    return [leaf for leaf in _leaves(tree) if isinstance(leaf, torch.Tensor)]


def replicate(tree, mesh):
    """Make a module (parameters and buffers), an optimizer's state or a
    tree of tensors equal on every rank of the mesh: each is overwritten in
    place with the values of the mesh's first rank, one broadcast per mesh
    dimension and dtype. Returns ``tree``."""

    tensors = _tensors(tree)
    for axis in mesh.mesh_dim_names:
        group, size, _ = _axis(mesh, axis)
        if size > 1:
            broadcast_tensors(tensors, group)

    return tree


def local_batch_to_global(local_batches, mesh, axis='data'):
    """Take each rank's own batch as its shard of the global batch.

    The multi-host entry point: each process loads its own rows (JAX's
    ``jax.make_array_from_process_local_data``), which in the port is the
    rank's local tensor as it is, placed on the mesh's device. The ranks
    must hold equal leading sizes (checked over ``axis``); the global batch
    is the ranks' rows in rank order.
    """

    group, size, _ = _axis(mesh, axis)
    device = _device(mesh)
    local = _map(lambda leaf: _to_device(leaf, device), local_batches)

    shapes = [tuple(leaf.shape) for leaf in _leaves(local)]
    gathered = [None] * size
    dist.all_gather_object(gathered, shapes, group=group)
    if any(other != shapes for other in gathered):
        raise ValueError(f'local batches differ in shape over mesh axis '
                         f'"{axis}": {gathered}')

    return local
