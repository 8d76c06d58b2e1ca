"""GPipe over a list of uniform stages (`dg_sct_tpu/parallel/pipeline.py`).

Rank p of a `pipe` group of P ranks holds stages [p * S / P, (p + 1) * S / P)
of S. Microbatch m enters rank 0 at tick m and leaves rank P - 1 at tick
m + P - 1, so a run takes n_micro + P - 1 ticks, each a receive from the
rank before and a send to the rank after; the last rank's outputs are then
broadcast to every rank. Written on `send`/`recv` (the stages are functions
over trees, not the `nn.Module`s `torch.distributed.pipelining` wants).
Gloo sends and receives host tensors only, so under gloo a card's tensor
goes through pinned host buffers on its way between ranks. Forward only:
the JAX package differentiates through its schedule, no entry point of
either package trains through it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_map, tree_unflatten


def stack_stages(stage_params_list):
    """Identically shaped per-stage trees stacked along a new leading axis
    (the layout `gpipe` also takes)."""
    return tree_map(lambda *xs: torch.stack(xs), *stage_params_list)


class _Link:
    """Sends and receives one microbatch's leaves between two ranks of a
    group, through pinned host buffers where gloo meets a card's tensors."""

    def __init__(self, like, group):
        self.group = group
        self.staged = dist.get_backend(group) == "gloo" and like[0].is_cuda
        self.like = like
        self.host = ([torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in like]
                     if self.staged else None)

    def send(self, leaves, dst):
        for i, t in enumerate(leaves):
            if self.staged:
                t = self.host[i].copy_(t)
            dist.send(t.contiguous(), dst=dst, group=self.group)

    def recv(self, src):
        out = []
        for i, t in enumerate(self.like):
            buf = self.host[i] if self.staged else torch.empty_like(t)
            dist.recv(buf, src=src, group=self.group)
            out.append(buf.to(t.device, copy=True) if self.staged else buf)
        return out


def gpipe(body, stages, microbatches, group):
    """`y_m = stages[S-1](...stages[0](x_m))` for every microbatch m,
    pipelined over `group`.

    body(stage, x) -> x     one stage; x a tree of tensors, returned with the
                            same structure, shapes and types.
    stages                  a list of S per-stage trees, or one tree stacked
                            along a leading axis of S (`stack_stages`).
    microbatches            a tree of tensors with leading axis n_micro.

    Returns the outputs stacked along the same leading n_micro axis, the
    same on every rank. S % P != 0 raises. `group` None: the world."""
    group = group or dist.group.WORLD
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if isinstance(stages, list):
        n_stages, stage = len(stages), stages.__getitem__
    else:
        n_stages = tree_leaves(stages)[0].shape[0]
        stage = lambda i: tree_map(lambda a: a[i], stages)
    if n_stages % size:
        raise ValueError(f"n_stages={n_stages} not divisible by pipe={size}")
    per = n_stages // size
    mine = [stage(i) for i in range(rank * per, (rank + 1) * per)]
    leaves = tree_leaves(microbatches)
    n_micro = leaves[0].shape[0]
    link = _Link([t[0] for t in leaves], group)
    prev = dist.get_global_rank(group, rank - 1) if rank > 0 else None
    nxt = dist.get_global_rank(group, rank + 1) if rank < size - 1 else None
    outs = []
    for m in range(n_micro):       # microbatch m passes this rank at tick m + rank
        x = [t[m] for t in leaves] if prev is None else link.recv(prev)
        for st in mine:
            x = tree_leaves(body(st, tree_unflatten(microbatches, x)))
        if nxt is not None:
            link.send(x, nxt)
        else:
            outs.append(x)
    last = dist.get_global_rank(group, size - 1)
    stacked = ([torch.stack([o[i] for o in outs]) for i in range(len(leaves))]
               if nxt is None else [torch.empty_like(t) for t in leaves])
    for t in stacked:
        dist.broadcast(t, src=last, group=group)
    return tree_unflatten(microbatches, stacked)
