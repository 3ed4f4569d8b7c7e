"""Context parallelism: time-axis sharding with halo exchange.

Counterpart of ``amt_tools_tpu/parallel/cp.py``. Per-frame models with
bounded receptive fields (TabCNN's 9-frame windows) can shard the TIME
axis of a whole track over a mesh dimension: each rank holds a contiguous
block of frames (:func:`shard_time`, the rank's plain local tensor) and
fetches the ``win_length // 2``-frame halos from its neighbours
(``torch.distributed.batch_isend_irecv``, JAX's ``ppermute``). The edge
ranks receive zeros, the zero padding an unsharded run applies at the
track boundaries, so the windows are IDENTICAL to the unsharded ones. The
exchange is differentiable: its backward sends each halo's gradient back
to the rank that owns those frames.
"""

import torch
import torch.distributed as dist

from ..ops import frames as frame_ops
from .mesh import _axis, _device, _to_device

__all__ = ['framify_time_sharded', 'shard_time']


def shard_time(feats, mesh, axis='data'):
    """This rank's block of (..., T) features sharded on the time axis, on
    the mesh's device.

    T must divide evenly by the mesh axis (pad the track first otherwise).
    """

    _, size, index = _axis(mesh, axis)
    frames = feats.shape[-1]
    if frames % size:
        raise ValueError(f'time axis ({frames} frames) must be '
                         f'divisible by the mesh axis ({size}); pad first.')

    block = frames // size

    return _to_device(feats[..., index * block:(index + 1) * block],
                      _device(mesh))


def _swap(to_prev, to_next, group, index, size):
    """Send ``to_prev`` to the previous rank and ``to_next`` to the next;
    returns what the previous and the next rank sent (zeros at an edge)."""

    from_prev = torch.zeros_like(to_next)
    from_next = torch.zeros_like(to_prev)
    ops = []
    if index > 0:
        prev = dist.get_global_rank(group, index - 1)
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), prev, group),
                dist.P2POp(dist.irecv, from_prev, prev, group)]
    if index < size - 1:
        nxt = dist.get_global_rank(group, index + 1)
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, from_next, nxt, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    return from_prev, from_next


class _Halos(torch.autograd.Function):
    """(left, right) halos of a local time block: the previous rank's last
    and the next rank's first ``halo`` frames."""

    @staticmethod
    def forward(ctx, local, halo, group, index, size):
        ctx.halo, ctx.group, ctx.index, ctx.size = halo, group, index, size
        ctx.block = local.shape[-1]

        return _swap(local[..., :halo], local[..., -halo:], group, index,
                     size)

    @staticmethod
    def backward(ctx, grad_left, grad_right):
        halo = ctx.halo
        # My left halo was the previous rank's right edge, and so on
        from_prev, from_next = _swap(grad_left, grad_right, ctx.group,
                                     ctx.index, ctx.size)
        grad = torch.zeros(grad_left.shape[:-1] + (ctx.block,),
                           dtype=grad_left.dtype, device=grad_left.device)
        grad[..., :halo] += from_prev
        grad[..., -halo:] += from_next

        return grad, None, None, None, None


def framify_time_sharded(feats, win_length, mesh, axis='data'):
    """This rank's (..., T_local) block of time-sharded activations ->
    its (..., T_local, W) context windows.

    The ranks' windows, in rank order, are exactly
    ``ops.frames.framify(track, win_length, pad=True)`` of the whole track,
    which is never gathered: interior window overlap comes from neighbour
    halos; track edges see zeros. Every rank holds a block of the same
    length (:func:`shard_time`), and ``win_length // 2`` must not exceed
    it.
    """

    group, size, index = _axis(mesh, axis)
    halo = win_length // 2
    block = feats.shape[-1]

    lengths = torch.tensor([block, -block], device=feats.device)
    dist.all_reduce(lengths, op=dist.ReduceOp.MAX, group=group)
    if int(lengths[0]) != -int(lengths[1]):
        raise ValueError('the time blocks differ in length over the mesh '
                         'axis: the time axis must divide the mesh axis; '
                         'pad first and shard with shard_time.')
    if halo > block:
        raise ValueError(f'halo ({halo}) exceeds the per-device block '
                         f'({block} frames); use fewer devices or longer '
                         f'tracks.')

    if halo == 0:
        # Single-frame windows need no neighbour context (and [-0:] would
        # slice the whole block)
        return frame_ops.framify(feats, win_length, pad=True)

    left, right = _Halos.apply(feats, halo, group, index, size)
    ext = torch.cat([left, feats, right], dim=-1)

    return frame_ops.framify(ext, win_length, pad=False)
