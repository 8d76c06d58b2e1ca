"""Tensor (Megatron) parallelism of an eval forward over a `model` group.

A rank holds the shards `mesh.tp_shard_params` cuts: the qkv of every
attention whose heads divide the model axis split by columns and its proj
by rows, the fc1 of every MLP whose hidden width divides it split by
columns (with its bias) and its fc2 by rows, and the adapters' grouped
bottleneck kernels by groups where their group count divides it
(`splits`). Whatever does not divide stays whole on every rank, and its
block runs there as in one process (`for_split`: no collective, and K2 or
K3 where one process would take them), so its output is one process's.
Given a `TensorParallel`, the split blocks run:
  * attention: qkv on this rank's heads, the attention core on them (K1 on
    the card: a half-block under tensor parallelism never takes K2, whose
    fused residual would come before the all-reduce of proj's partial
    sums), proj's partial sums all-reduced, then proj's bias, once;
  * MLP: fc1's columns, GELU, fc2's rows, the all-reduce, then fc2's bias;
  * adapter bottleneck: LN_before on the replicated input, this rank's
    groups' down and up products (and their BN channels), the channels
    all-gathered before LN_post (the split path, never K3).
The per-head leaves the sharding leaves replicated (Swin-V2's q_bias,
v_bias, logit_scale and log-CPB output columns, HTS-AT's relative bias
table, HTS-AT's qkv bias) are sliced to this rank's heads where they are
used. Partial sums are all-reduced in float32.

The qkv layout is Megatron's: q, k and v each split by heads, so a rank's
columns are [q of its heads | k of its heads | v of its heads]. The JAX
package's spec `P(None, "model")` on the (C, 3C) kernel splits the columns
contiguously instead (rank 0 of two would hold all of q and half of k),
which GSPMD reshards and a rank's local attention cannot use; the numbers
are the same.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.basic import linear
from .comm import rank_and_size


class TensorParallel:
    """This process's place on a `model` process group."""

    def __init__(self, group):
        self.group = group
        self.rank, self.size = rank_and_size(group)

    def splits(self, n: int) -> bool:
        """Whether a dimension of n is split over the model ranks: the rule
        of `mesh.tp_param_spec`, which splits only what divides the axis."""
        return n % self.size == 0

    def share(self, n: int) -> slice:
        """This rank's contiguous share of n items (n divisible by size)."""
        if n % self.size:
            raise ValueError(f"{n} items do not split over {self.size} model ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def reduce(self, partial):
        """The sum of `partial` over the group, in float32, as partial's type."""
        y = partial.to(torch.float32, copy=True)
        dist.all_reduce(y, group=self.group)
        return y.to(partial.dtype)

    def row_parallel(self, params, x, *, kernels=True):
        """x (this rank's input columns) @ this rank's kernel rows, summed
        over the group, then the (replicated) bias once."""
        y = self.reduce(linear({"kernel": params["kernel"]}, x, kernels=kernels))
        return y + params["bias"] if "bias" in params else y

    def gather_channels(self, x):
        """(..., C / size) shards -> (..., C), in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)


def for_split(tp, n: int):
    """`tp` for a block of n heads (attention) or n hidden columns (MLP)
    that the model axis splits; None, the block whole as in one process,
    without tensor parallelism or where n does not divide the axis."""
    return tp if tp is not None and tp.splits(n) else None


def qkv_columns(kernel, heads: int, size: int, rank: int):
    """Rank `rank`'s columns of a (C, 3C) qkv kernel (or (3C,) bias) split
    by heads over `size` ranks: its heads' q, k and v columns."""
    C = kernel.shape[-1] // 3
    if heads % size:
        raise ValueError(f"{heads} heads do not split over {size} model ranks")
    k = C // size
    cols = [kernel[..., j * C + rank * k: j * C + (rank + 1) * k] for j in range(3)]
    return torch.cat(cols, dim=-1)


def split_heads(tp, params, heads: int, C: int):
    """(this rank's view of an attention's params, its heads) under tensor
    parallelism (`tp` from `for_split`); (params, heads) when `tp` is None."""
    if tp is None:
        return params, heads
    hs = tp.share(heads)
    hd = C // heads
    cs = slice(hs.start * hd, hs.stop * hd)
    view = dict(params)
    if "rpb_table" in params:                               # V1 (HTS-AT)
        view["rpb_table"] = params["rpb_table"][:, hs]
        if "bias" in params["qkv"]:
            view["qkv"] = dict(params["qkv"], bias=qkv_columns(params["qkv"]["bias"], heads,
                                                               tp.size, tp.rank))
    else:                                                   # V2 (Swin-V2)
        view["q_bias"], view["v_bias"] = params["q_bias"][cs], params["v_bias"][cs]
        view["logit_scale"] = params["logit_scale"][hs]
        view["cpb_fc2"] = {"kernel": params["cpb_fc2"]["kernel"][:, hs]}
    return view, hs.stop - hs.start


def project(tp, params, out, *, kernels=True):
    """The attention's (C, C) proj of `out`: row-parallel under tensor
    parallelism, else whole."""
    if tp is None:
        return linear(params, out, kernels=kernels)
    return tp.row_parallel(params, out, kernels=kernels)
