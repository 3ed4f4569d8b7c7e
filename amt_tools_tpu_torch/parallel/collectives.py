"""Differentiable collectives over one dimension of a device mesh.

XLA derives every collective of a sharded JAX program from the shardings;
``torch.distributed`` runs one process per device, so the port writes them
out. Each takes the ``ProcessGroup`` of a mesh dimension
(``mesh.get_group('data')``) and a plain local tensor:

- :func:`all_reduce`: the sum over the group; its backward sums the
  gradient over the group too. Use it where every rank's loss is its part
  of a global loss (the global BatchNorm statistics of a data-parallel
  step: each rank's statistics feed every rank's loss);
- :func:`reduce_grad`: the identity; its backward sums the gradient over
  the group (the input of a column-parallel product, whose ranks each see
  a part of the input's gradient);
- :func:`gather_columns`: the concatenation of every rank's tensor along
  ``dim``; its backward keeps the rank's own slice (what follows runs
  replicated over the group, so every rank holds the whole gradient);
- :func:`average_gradients`: the data-parallel mean of the gradients, one
  collective per dtype over a flat buffer;
- :func:`broadcast_tensors`: rank 0's values on every rank, one collective
  per dtype (no gradient).

``torch.distributed.nn.functional`` has differentiable collectives, but
its ``all_reduce`` is deprecated and its backward is not the one the
BatchNorm statistics need.
"""

import torch
import torch.distributed as dist

__all__ = ['all_reduce', 'reduce_grad', 'gather_columns',
           'average_gradients', 'broadcast_tensors']


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)

        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)

        return grad, None


class _ReduceGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group

        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)

        return grad, None


class _GatherColumns(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        size = dist.get_world_size(group)
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)

        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.rank * ctx.width

        return grad.narrow(ctx.dim, start, ctx.width), None, None


def all_reduce(x, group):
    """The sum of ``x`` over ``group``; the gradient is summed over it."""

    return _AllReduce.apply(x, group)


def reduce_grad(x, group):
    """``x`` itself; its gradient is summed over ``group``."""

    return _ReduceGrad.apply(x, group)


def gather_columns(x, group, dim=-1):
    """Every rank's ``x`` joined along ``dim`` in rank order; the gradient
    keeps the rank's own slice. Ranks must hold equal shapes."""

    return _GatherColumns.apply(x, group, dim % x.dim())


def _by_dtype(tensors):
    groups = {}
    for tensor in tensors:
        groups.setdefault(tensor.dtype, []).append(tensor)

    return groups.values()


def average_gradients(parameters, group):
    """Replace each gradient by its mean over ``group``: one flat
    ``all_reduce`` per dtype, divided by the group's size. Parameters
    without a gradient are skipped; every rank has the same set, since
    every rank runs the same graph."""

    size = dist.get_world_size(group)
    grads = [p.grad for p in parameters if p.grad is not None]
    for same in _by_dtype(grads):
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        offset = 0
        for grad in same:
            grad.copy_(flat[offset:offset + grad.numel()].view_as(grad))
            offset += grad.numel()


@torch.no_grad()
def broadcast_tensors(tensors, group):
    """Overwrite ``tensors`` in place with those of the group's first
    rank: one flat ``broadcast`` per dtype."""

    src = dist.get_global_rank(group, 0)
    for same in _by_dtype([t for t in tensors if t.numel()]):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for tensor in same:
            tensor.copy_(flat[offset:offset + tensor.numel()].view_as(tensor))
            offset += tensor.numel()
