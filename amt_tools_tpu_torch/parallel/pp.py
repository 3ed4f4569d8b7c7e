"""Pipeline parallelism: a GPipe microbatch schedule over a ``pipe`` axis.

Counterpart of ``amt_tools_tpu/parallel/pp.py``. A stack of S sequential
stages is laid out one stage per rank along a ``pipe`` mesh dimension, and
M microbatches flow through the GPipe schedule: at tick t, rank s runs
stage s on microbatch ``t - s`` while its predecessor's output for the
next microbatch is in flight (``torch.distributed`` point-to-point sends,
JAX's ``ppermute``). The schedule takes ``M + S - 1`` ticks; the first and
last ``S - 1`` are partly idle, so the steady-state efficiency is
``M / (M + S - 1)``.

The schedule is one ``torch.autograd.Function``: its forward runs the
ticks, keeping each microbatch's stage graph; its backward runs them in
reverse, receiving each output's gradient from the next stage and sending
the input's gradient to the previous one. It composes with a ``data``
dimension (dp x pp): each data replica's pipe ranks run the schedule on
that replica's rows.
"""

import torch
import torch.distributed as dist

from .mesh import _axis

__all__ = ['pipeline_apply', 'shard_params_pp', 'stack_stage_params']


def _flatten(tree):
    """(leaves, rebuild) of nested dicts, lists and tuples of tensors."""

    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[key]) for key in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(value) for value in tree]
    else:
        return [tree], lambda leaves: leaves[0]

    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves):
        values, offset = [], 0
        for (_, fn), count in zip(parts, sizes):
            values.append(fn(leaves[offset:offset + count]))
            offset += count
        if keys is not None:
            return type(tree)(zip(keys, values))
        return type(tree)(values)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def stack_stage_params(per_stage_params):
    """Stack a list of S identical-structure stage trees on a new axis 0."""

    leaves = [_flatten(stage)[0] for stage in per_stage_params]
    _, rebuild = _flatten(per_stage_params[0])

    return rebuild([torch.stack(same) for same in zip(*leaves)])


def shard_params_pp(stage_params, mesh, axis='pipe'):
    """This rank's stage of stage-stacked parameters (leading axis S): one
    stage per rank of ``axis``; any other stage count raises."""

    _, size, index = _axis(mesh, axis)
    leaves, rebuild = _flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != size:
            raise ValueError(
                f'stage-stacked leaf has leading dim {leaf.shape[0]}, but '
                f'mesh axis "{axis}" has {size} devices — one stage per '
                f'device is required.')

    return rebuild([leaf[index].clone() for leaf in leaves])


class _Schedule:
    """The ranks and the tick range of one rank's pipe schedule."""

    def __init__(self, mesh, axis, num_micro):
        self.group, self.size, self.stage = _axis(mesh, axis)
        self.num_micro = num_micro
        self.prev = (None if self.stage == 0 else
                     dist.get_global_rank(self.group, self.stage - 1))
        self.next = (None if self.stage == self.size - 1 else
                     dist.get_global_rank(self.group, self.stage + 1))
        self.first = dist.get_global_rank(self.group, 0)
        self.last = dist.get_global_rank(self.group, self.size - 1)

    def busy(self):
        """The microbatch this stage runs at each of the ``M + S - 1``
        ticks it is busy in (tick t runs microbatch ``t - stage``)."""

        for tick in range(self.num_micro + self.size - 1):
            micro = tick - self.stage
            if 0 <= micro < self.num_micro:
                yield micro


def _run_forward(schedule, x, run):
    """The forward ticks: ``run(micro, inp) -> y`` for each microbatch of
    this stage; returns the outputs (M, ...) on every pipe rank."""

    sends = []
    out = torch.empty_like(x)
    for micro in schedule.busy():
        if schedule.prev is None:
            inp = x[micro]
        else:
            inp = torch.empty_like(x[micro])
            dist.recv(inp, schedule.prev, group=schedule.group)
        y = run(micro, inp)
        if schedule.next is None:
            out[micro] = y
        else:
            sends.append(dist.isend(y.contiguous(), schedule.next,
                                    group=schedule.group))
    for work in sends:
        work.wait()

    # Only the last stage holds the outputs; JAX psums masked copies
    dist.broadcast(out, schedule.last, group=schedule.group)

    return out


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stage_fn, rebuild, schedule, x, *leaves):
        params = [leaf.detach().requires_grad_(leaf.requires_grad)
                  for leaf in leaves]
        tree = rebuild(params)
        saved = {}

        def run(micro, inp):
            inp = inp.detach().requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(tree, inp)
            saved[micro] = (inp, y)
            return y.detach()

        out = _run_forward(schedule, x, run)
        ctx.schedule, ctx.saved, ctx.params = schedule, saved, params
        ctx.x_shape, ctx.x_grad = x.shape, x.requires_grad

        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        schedule, params = ctx.schedule, ctx.params
        wanted = [p for p in params if p.requires_grad]
        grads = [torch.zeros_like(p) for p in wanted]
        grad_x = torch.zeros(ctx.x_shape, dtype=grad_out.dtype,
                             device=grad_out.device)

        sends = []
        for micro in reversed(list(schedule.busy())):
            inp, y = ctx.saved.pop(micro)
            if schedule.next is None:
                grad_y = grad_out[micro]
            else:
                grad_y = torch.empty_like(y)
                dist.recv(grad_y, schedule.next, group=schedule.group)
            found = torch.autograd.grad(y, [inp] + wanted, grad_y,
                                        allow_unused=True)
            for total, grad in zip(grads, found[1:]):
                if grad is not None:
                    total += grad
            grad_inp = found[0]
            if grad_inp is None:
                grad_inp = torch.zeros_like(inp)
            if schedule.prev is None:
                grad_x[micro] = grad_inp
            else:
                sends.append(dist.isend(grad_inp.contiguous(), schedule.prev,
                                        group=schedule.group))
        for work in sends:
            work.wait()

        if ctx.x_grad:
            # x is replicated over the pipe ranks: each gets the whole
            # gradient, which stage 0 computed
            dist.broadcast(grad_x, schedule.first, group=schedule.group)
        grads = iter(grads)
        leaf_grads = [next(grads) if p.requires_grad else None
                      for p in params]

        return (None, None, None, grad_x if ctx.x_grad else None,
                *leaf_grads)


def pipeline_apply(stage_params, x, stage_fn, mesh, axis='pipe',
                   batch_axis=None):
    """Run microbatches through S pipelined stages: one stage per rank.

    Parameters
    ----------
    stage_params : tree of tensors
        This rank's stage parameters (:func:`shard_params_pp` of a
        stage-stacked tree, or any tree ``stage_fn`` takes).
    x : tensor (M, mb, ...)
        M microbatches, the same on every pipe rank (stage 0 reads them).
        Every stage must map an (mb, ...) activation to one of the same
        shape and dtype (the uniform payload sent between stages).
    stage_fn : callable
        ``stage_fn(params, y) -> y`` for this rank's stage.
    mesh : DeviceMesh
        Mesh carrying the ``axis`` dimension (optionally others, e.g. a
        ``data`` dimension for dp x pp).
    batch_axis : str, optional
        The mesh dimension the microbatch rows (axis 1 of ``x``) are
        sharded over: ``x`` then holds this rank's rows (``shard_batch``
        of each microbatch), and so do the outputs.

    Returns
    -------
    (M, mb, ...) outputs on every rank of the ``axis`` dimension.
    Differentiable in ``x`` and in the stage parameters: a rank's
    parameter gradients are those of its own stage, and each pipe rank
    gets the whole gradient of ``x``.
    """

    if batch_axis is not None and batch_axis not in mesh.mesh_dim_names:
        raise ValueError(f'batch_axis "{batch_axis}" is not a dimension of '
                         f'the mesh {mesh.mesh_dim_names}')

    schedule = _Schedule(mesh, axis, x.shape[0])
    leaves, rebuild = _flatten(stage_params)

    if not (torch.is_grad_enabled() and
            (x.requires_grad or any(leaf.requires_grad for leaf in leaves))):
        return _run_forward(schedule, x,
                            lambda micro, inp: stage_fn(stage_params, inp))

    return _Pipeline.apply(stage_fn, rebuild, schedule, x, *leaves)
