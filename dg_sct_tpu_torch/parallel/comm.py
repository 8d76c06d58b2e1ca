"""Collectives over a process group, shaped for the model's code.

`all_reduce_sum` and `gather_rows` are differentiable: the batch norm of a
data-parallel step reduces its statistics with the first, mixup exchanges
the flipped rows of the global batch with the second. `average_` averages a
step's gradients; `gather_frames` (sequence-parallel eval) is eval-only.
Every call names its group; nothing here starts a process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BUCKET_ELEMENTS = 1 << 26   # elements a flat all-reduce of gradients carries at most


def rank_and_size(group) -> tuple[int, int]:
    """(this process's rank in `group`, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads the sum: its gradient is the sum of theirs
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, group):
    """The sum of `x` over `group`, differentiable. The backward pass
    all-reduces again, so every rank must run it in the same order (a
    checkpointed block recomputes its forward, collective included)."""
    return _AllReduceSum.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank, size = rank_and_size(group)
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        # a reduce-scatter as an all-reduce and this rank's rows (gloo has no
        # reduce-scatter)
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(0, ctx.rank * ctx.n, ctx.n), None


def gather_rows(x, group):
    """The global batch from each rank's rows of the leading axis, in rank
    order, differentiable."""
    return _GatherRows.apply(x, group)


@torch.no_grad()
def average_(tensors, group) -> None:
    """Each tensor replaced in place by its mean over `group`: flat
    all-reduces of at most BUCKET_ELEMENTS elements per dtype. Every rank
    gets the same bits back, so a replicated optimizer keeps the ranks'
    parameters identical."""
    size = dist.get_world_size(group)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        start = 0
        while start < len(same):
            stop, n = start + 1, same[start].numel()
            while stop < len(same) and n + same[stop].numel() <= BUCKET_ELEMENTS:
                n += same[stop].numel()
                stop += 1
            bucket = same[start:stop]
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            flat /= size
            for b, v in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(v.view_as(b))
            start = stop


def mean_over(x, group):
    """A detached scalar's mean over `group` (the metrics of a step), in
    float32 or wider."""
    x = x.detach().to(torch.promote_types(x.dtype, torch.float32), copy=True)
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


@torch.no_grad()
def gather_frames(x, group):
    """(B, T_loc, ...) -> (B, T, ...): the frames of every rank of `group`
    (rank s holds frames [s * T_loc, (s + 1) * T_loc) of each clip) put
    back in clip order. `all_gather` stacks the ranks on the leading axis,
    which would order the rows (rank, clip, frame)."""
    _, size = rank_and_size(group)
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)
