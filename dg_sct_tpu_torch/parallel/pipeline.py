"""GPipe over a list of uniform stages (`dg_sct_tpu/parallel/pipeline.py`).

Rank p of a `pipe` group of P ranks holds stages [p * S / P, (p + 1) * S / P)
of S. Microbatch m enters rank 0 at tick m and leaves rank P - 1 at tick
m + P - 1, so a run takes n_micro + P - 1 ticks, each a receive from the
rank before and a send to the rank after; the last rank's outputs are then
broadcast to every rank. Written on `send`/`recv` (the stages are functions
over trees, not the `nn.Module`s `torch.distributed.pipelining` wants).
Gloo sends and receives host tensors only, so under gloo a card's tensor
goes through pinned host buffers on its way between ranks.

Differentiable, as the JAX package's schedule is under `jax.grad`: when
grad mode is on and a stage leaf or a microbatch leaf requires grad, the run
is one autograd `Function` (`_GPipe`) whose backward walks the microbatches
in a fixed order on every rank, each output gradient coming from the next
rank and each input gradient going to the previous one (gloo's blocking
send and recv would deadlock if two ranks ordered them differently). Every
rank computes the same loss from the replicated outputs; a rank's stages
get their gradient from the last rank's output gradient, and the
microbatches get theirs, the sequential loop's, on every rank.
"""
from __future__ import annotations

import contextlib

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


class _Plan:
    """One `gpipe` call's placement: this rank's stages, its neighbours'
    global ranks (None at either end) and the last rank's."""

    def __init__(self, body, stages, microbatches, group):
        self.body, self.microbatches = body, microbatches
        self.group = group = group or dist.group.WORLD
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if isinstance(stages, list):
            n_stages, stage = len(stages), stages.__getitem__
        else:
            n_stages = tree_leaves(stages)[0].shape[0]
            stage = lambda i: tree_map(lambda a: a[i], stages)
        if n_stages % size:
            raise ValueError(f"n_stages={n_stages} not divisible by pipe={size}")
        per = n_stages // size
        self.mine = [stage(i) for i in range(rank * per, (rank + 1) * per)]
        self.prev = dist.get_global_rank(group, rank - 1) if rank > 0 else None
        self.nxt = dist.get_global_rank(group, rank + 1) if rank < size - 1 else None
        self.first = dist.get_global_rank(group, 0)
        self.last = dist.get_global_rank(group, size - 1)

    def run(self, leaves, mine, record=None):
        """The forward schedule over microbatch leaves `leaves` with this
        rank's stage trees `mine` -> the outputs' leaves stacked, the same
        on every rank. `record` (a list): each microbatch's (input leaves,
        output leaves) of this rank, its graph recorded for the backward."""
        n_micro = leaves[0].shape[0]
        link = _Link([t[0] for t in leaves], self.group)
        outs = []
        for m in range(n_micro):       # microbatch m passes this rank at tick m + rank
            x = [t[m] for t in leaves] if self.prev is None else link.recv(self.prev)
            if record is not None:
                # rank 0 differentiates its input only where the microbatches need it
                x = [t.detach().requires_grad_(t.is_floating_point() and (
                    self.prev is not None or leaf.requires_grad)) for t, leaf in zip(x, leaves)]
                x_in = x
            with torch.enable_grad() if record is not None else contextlib.nullcontext():
                for st in mine:
                    x = tree_leaves(self.body(st, tree_unflatten(self.microbatches, x)))
            if record is not None:
                record.append((x_in, x))
                x = [t.detach() for t in x]
            if self.nxt is not None:
                link.send(x, self.nxt)
            else:
                outs.append(x)
        stacked = ([torch.stack([o[i] for o in outs]) for i in range(len(leaves))]
                   if self.nxt is None else [torch.empty_like(t) for t in leaves])
        for t in stacked:
            dist.broadcast(t, src=self.last, group=self.group)
        return stacked


class _GPipe(torch.autograd.Function):
    """`_Plan.run` with a backward: the inputs are an empty anchor that
    requires grad (so that every rank's node joins the backward, also where
    none of its own stages or microbatches requires grad), the microbatch
    leaves, then the leaves of this rank's stages; the outputs the stacked
    output leaves. The forward keeps every microbatch's local graph; the
    backward walks the microbatches last to first on every rank."""

    @staticmethod
    def forward(ctx, plan, n_leaves, anchor, *inputs):
        leaves, params = list(inputs[:n_leaves]), inputs[n_leaves:]
        local = [p.detach().requires_grad_(p.requires_grad) for p in params]
        mine = tree_unflatten(plan.mine, local)
        ctx.plan, ctx.local, ctx.record = plan, local, []
        ctx.leaf_like = [(t.shape[1:], t.dtype, t.device) for t in leaves]
        return tuple(plan.run(leaves, mine, ctx.record))

    @staticmethod
    def backward(ctx, *grad_outs):
        plan, local, record = ctx.plan, ctx.local, ctx.record
        n_leaves = len(ctx.leaf_like)
        want_x = ctx.needs_input_grad[3:3 + n_leaves]
        zeros = lambda: [torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.leaf_like]
        link = _Link(zeros(), plan.group)
        wrt_p = [p for p in local if p.requires_grad]
        g_params = [None] * len(wrt_p)
        g_micro = [None] * len(record)
        for m in reversed(range(len(record))):
            if plan.nxt is None:        # the last rank's output gradient, the loss's own
                g_out = [z if g is None else g[m] for g, z in zip(grad_outs, zeros())]
            else:
                g_out = link.recv(plan.nxt)
            x_in, y = record[m]
            record[m] = None            # the graph goes with its backward
            wrt_x = [t for t in x_in if t.requires_grad]
            pairs = [(o, g) for o, g in zip(y, g_out) if o.requires_grad]
            if pairs and (wrt_x or wrt_p):
                got = torch.autograd.grad([o for o, _ in pairs], wrt_x + wrt_p,
                                          [g for _, g in pairs], allow_unused=True)
            else:
                got = [None] * (len(wrt_x) + len(wrt_p))
            g_x, it = [], iter(got[:len(wrt_x)])
            for t, z in zip(x_in, zeros()):
                g = next(it) if t.requires_grad else None
                g_x.append(z if g is None else g)
            for i, g in enumerate(got[len(wrt_x):]):
                if g is not None:
                    g_params[i] = g if g_params[i] is None else g_params[i] + g
            if plan.prev is not None:
                link.send(g_x, plan.prev)
            else:
                g_micro[m] = g_x
        ctx.record = None
        g_leaves = [None] * n_leaves
        for i in range(n_leaves):
            if want_x[i]:
                t = (torch.stack([g[i] for g in g_micro]) if plan.prev is None
                     else torch.empty((len(g_micro),) + tuple(ctx.leaf_like[i][0]),
                                      dtype=ctx.leaf_like[i][1], device=ctx.leaf_like[i][2]))
                dist.broadcast(t, src=plan.first, group=plan.group)
                g_leaves[i] = t
        it = iter(g_params)
        g_stage = [next(it) if p.requires_grad else None for p in local]
        return (None, None, None, *g_leaves, *g_stage)


def gpipe(body, stages, microbatches, group):
    """`y_m = stages[S-1](...stages[0](x_m))` for every microbatch m,
    pipelined over `group`.

    body(stage, x) -> x     one stage; x a tree of tensors, returned with the
                            same structure, shapes and types.
    stages                  a list of S per-stage trees, or one tree stacked
                            along a leading axis of S (`stack_stages`); the
                            same trees on every rank.
    microbatches            a tree of tensors with leading axis n_micro, the
                            same on every rank.

    Returns the outputs stacked along the same leading n_micro axis, the
    same on every rank. S % P != 0 raises. `group` None: the world.

    Under grad mode, with a leaf of `stages` or `microbatches` that requires
    grad, the outputs carry a backward (the module's docstring): each rank's
    own stages and the microbatches get the sequential loop's gradients. Its
    memory is GPipe's: every microbatch's activations of this rank's stages
    stay until the backward. Otherwise nothing is recorded. `body`
    differentiates only through its two arguments: a tensor it closes over
    gets no gradient."""
    plan = _Plan(body, stages, microbatches, group)
    leaves = tree_leaves(microbatches)
    params = tree_leaves(plan.mine)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tree_leaves(stages) + leaves)):
        return tree_unflatten(microbatches, plan.run(leaves, plan.mine))
    anchor = torch.empty(0, requires_grad=True)
    return tree_unflatten(microbatches,
                          _GPipe.apply(plan, len(leaves), anchor, *leaves, *params))
