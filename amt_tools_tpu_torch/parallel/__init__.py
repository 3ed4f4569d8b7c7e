"""Parallelism over ``torch.distributed``: device meshes, data, tensor,
context and pipeline parallelism.

Counterpart of ``amt_tools_tpu/parallel/``. PyTorch runs one process per
device; a mesh is a ``DeviceMesh`` of process ranks with named dimensions
(``data``, ``model``, ``pipe``), and a sharded value is the rank's plain
local tensor (``mesh.py``). ``train(mesh=...)`` and the serving
pipelines' ``mesh`` are data parallel over ``data``; ``collectives.py``
holds the differentiable collectives the layers use. The O&F pipeline
stages are in ``pp_flagship``.
"""

from .mesh import (get_mesh, shard_batch, pad_shard_batch, replicate,
                   data_parallel_shardings, local_batch_to_global)
from .tp import tp_rules_default, shard_params_tp
from .cp import framify_time_sharded, shard_time
from .pp import pipeline_apply, shard_params_pp, stack_stage_params

__all__ = ['get_mesh', 'shard_batch', 'pad_shard_batch', 'replicate',
           'data_parallel_shardings',
           'local_batch_to_global', 'tp_rules_default', 'shard_params_tp',
           'framify_time_sharded', 'shard_time',
           'pipeline_apply', 'shard_params_pp', 'stack_stage_params']
