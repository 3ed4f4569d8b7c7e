"""Tensor-parallel parameter sharding rules.

Counterpart of ``amt_tools_tpu/parallel/tp.py``: a ``model`` mesh
dimension shards the wide projection kernels column-wise across ranks (the
acoustic models' and TabCNN's dense layers, the hoisted LSTM input
projections, the recurrent kernels); everything else stays replicated.
XLA inserts the gathers a sharding implies; here each rank keeps its
columns as its plain local parameter, and the layers gather:

- a sharded ``nn.Linear`` (weight rows and bias) computes its output
  columns in ``ops.layers.linear``, which gathers them over the group (and
  sums the input's gradient over it);
- a sharded ``recurrent_kernel`` is gathered whole before kernels B, E and
  F read it through their raw pointer (``ops.lstm``), as XLA gathers an
  operand around a Pallas call it cannot partition.

- the grouped acoustic stack's ``head_kernels`` (H, K, D) keep their D
  columns, and ``models.onsetsframes.GroupedAcousticModel`` gathers the
  per-head projections' output columns;
- a grouped BiLSTM's stacked (S, H, 4H) recurrent kernels keep their 4H
  columns, gathered whole before the grouped launch.

The port calls its layers through functions (``linear(x, layer)``), so
``torch.distributed.tensor.parallel.parallelize_module``'s hooks would
never run; the layers read the ``tp_group`` these rules leave on them.

Usage (shard before building the optimizer: the parameters are new)::

    mesh = get_mesh(axis_names=('data', 'model'), shape=(4, 2))
    shard_params_tp(model, mesh)
    optimizer = torch.optim.SGD(model.parameters(), lr=1e-2)
    step = make_train_step(model, optimizer, mesh=mesh)
"""

import re

import torch
import torch.nn as nn
from torch.distributed.tensor import Shard

from .mesh import _axis

__all__ = ['tp_rules_default', 'shard_params_tp']


def tp_rules_default(axis='model'):
    """Default parameter-name -> placement rules for the built-in models.

    Column-parallel sharding of every wide kernel: the output features of
    the hoisted LSTM input projections, of the dense projections
    (``Dense_<n>``, ``dense1``; the output heads included), the 4H columns
    of the recurrent kernels (stacked ones too) and the D columns of the
    grouped acoustic stack's per-head kernels (``head_kernels``, (H, K,
    D)). Biases follow their weight; small parameters stay replicated.
    Names are the port's (``nn.Linear`` weights are (out, in), so Flax's
    ``P(None, axis)`` is ``Shard(0)`` here; JAX left-pads a rule for a
    stacked leaf, which ``Shard(-1)`` says for the last axis).
    """

    return [
        (r'(.*\.)?input_proj(_fwd|_bwd)?\.weight$', Shard(0)),
        (r'(.*\.)?recurrent_kernel(_fwd|_bwd)?$', Shard(-1)),
        (r'(.*\.)?(Dense_\d+|dense1)\.weight$', Shard(0)),
        (r'(.*\.)?head_kernels$', Shard(-1)),
    ]


def _placement(name, rules):
    for pattern, placement in rules:
        if re.match(pattern, name):
            return placement

    return None


def _local(param, dim, size, index):
    block = param.shape[dim] // size

    return nn.Parameter(param.detach().narrow(dim, index * block, block)
                        .clone(), requires_grad=param.requires_grad)


def shard_params_tp(model, mesh, rules=None, axis='model'):
    """Keep this rank's columns of every parameter of ``model`` that a rule
    shards, in place, and mark the layer with the ``axis`` group
    (``tp_group``). Returns the names of the sharded parameters.

    Kernels whose sharded dimension is not divisible by the axis size stay
    replicated (correctness first), as do int8 layers. Every rank must hold
    the same weights first (``replicate``).
    """

    if rules is None:
        rules = tp_rules_default(axis)

    group, size, index = _axis(mesh, axis)

    sharded = []
    for module_name, module in model.named_modules():
        if getattr(module, 'quantized', False):
            continue
        for name, param in list(module.named_parameters(recurse=False)):
            full = f'{module_name}.{name}' if module_name else name
            placement = _placement(full, rules)
            if placement is None:
                continue
            dim = placement.dim
            if param.dim() <= dim or param.shape[dim] % size:
                continue

            setattr(module, name, _local(param, dim, size, index))
            if isinstance(module, nn.Linear) and name == 'weight':
                module.bias = _local(module.bias, 0, size, index)
            module.tp_group = group
            sharded.append(full)

    return sharded
