"""The world, meshes of process groups and sharding (`dg_sct_tpu/parallel/mesh.py`).

JAX lays its devices out in a `Mesh` and lets GSPMD insert collectives
where a sharded array meets a replicated one. Here every process is one
rank, a mesh is the process groups along each named axis (`data`, `model`,
`seq`, `pipe`), and the sharding is explicit: a rank holds its rows of a
batch (`shard_batch`, `shard_batch_seq`) or its shards of a tree
(`tp_shard_params`), and the model's code runs the collectives
(`parallel.comm`, `parallel.tp`). JAX's `constrain_batch` (a sharding
constraint inside jit) has no counterpart: nothing here is resharded
behind the code's back.
"""
from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops.draws import RowShard
from ..utils.tree import tree_map, tree_paths
from .tp import qkv_columns

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
# every group's timeout: a hung collective fails, it does not wait
TIMEOUT = datetime.timedelta(seconds=120)


def init_world(backend: str, init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None):
    """Start this process's default group -> (rank, world size). Arguments
    left None come from torchrun's environment (RANK, WORLD_SIZE and
    "env://", which reads MASTER_ADDR and MASTER_PORT); `backend` is
    "nccl" or "gloo", always given."""
    if rank is None or world_size is None:
        try:
            rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        except KeyError as e:
            raise ValueError(f"no {e.args[0]} in the environment: run under torchrun or pass "
                             "rank, world_size and init_method") from None
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return rank, world_size


def local_rank() -> int | None:
    """torchrun's LOCAL_RANK (this rank's card on its host), or None."""
    v = os.environ.get("LOCAL_RANK")
    return None if v is None else int(v)


class Mesh:
    """Ranks 0..n-1 of the world laid out row-major over named axes (as
    `np.arange(n).reshape(sizes)`) and, for each axis, the process group of
    the ranks that differ along it alone. Every rank of the world must
    build the same meshes in the same order (`new_group` is collective);
    ranks from n on are not `member`s and hold no group."""

    def __init__(self, axes: dict):
        names, sizes = tuple(axes), tuple(int(v) for v in axes.values())
        n = math.prod(sizes)
        if n > dist.get_world_size():
            raise ValueError(f"a mesh of {dict(axes)} needs {n} ranks, the world has "
                             f"{dist.get_world_size()}")
        me = dist.get_rank()
        grid = np.arange(n).reshape(sizes)
        self.shape = dict(zip(names, sizes))
        self.member = me < n
        self.coords = (dict(zip(names, (int(i) for i in np.unravel_index(me, sizes))))
                       if self.member else {})
        self.groups = {}
        for i, name in enumerate(names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]).tolist():
                group = dist.new_group(line, timeout=TIMEOUT)
                if me in line:
                    self.groups[name] = group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(num_ranks: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh over the first `num_ranks` ranks (None: the world)."""
    return Mesh({axis: num_ranks or dist.get_world_size()})


def make_data_mesh_for(batch_size: int) -> Mesh:
    """A 1-D data mesh over the largest rank count that divides `batch_size`
    (JAX rejects an uneven batch sharding; the ranks above it idle)."""
    n = dist.get_world_size()
    while n > 1 and batch_size % n:
        n -= 1
    return make_mesh(n)


def make_mesh_2d(data: int, model: int) -> Mesh:
    return Mesh({DATA_AXIS: data, MODEL_AXIS: model})


def make_mesh_2d_seq(data: int, seq: int) -> Mesh:
    return Mesh({DATA_AXIS: data, SEQ_AXIS: seq})


def _part(x, axis: int, parts: int, index: int):
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"an axis of {n} does not split over {parts} ranks")
    k = n // parts
    return x[(slice(None),) * axis + (slice(index * k, (index + 1) * k),)]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of the leading axis of every leaf (numpy arrays or
    tensors), a contiguous 1/size of them over the data axis."""
    return tree_map(lambda x: _part(x, 0, mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)), batch)


def shard_batch_seq(batch, mesh: Mesh):
    """(B, T, ...) leaves split as P(data, seq): this rank's clips and, of
    each, its T / seq frames; 1-D leaves (a label per clip) as P(data)."""
    def part(x):
        x = _part(x, 0, mesh.size(DATA_AXIS), mesh.index(DATA_AXIS))
        return x if x.ndim < 2 else _part(x, 1, mesh.size(SEQ_AXIS), mesh.index(SEQ_AXIS))
    return tree_map(part, batch)


@torch.no_grad()
def replicate(tree, group=None):
    """Every tensor of `tree` set to the first rank of `group`'s by a
    broadcast, in place; returns the tree."""
    root = 0 if group is None else dist.get_global_rank(group, 0)
    for _, t in tree_paths(tree):
        dist.broadcast(t, src=root, group=group)
    return tree


def shard_generator(gen, group):
    """`gen` drawing this rank's rows of the global batch's draws under data
    parallelism over `group` (`ops.draws.RowShard`); `gen` itself without a
    group or a generator."""
    if group is None or gen is None:
        return gen
    return RowShard(gen, dist.get_rank(group), dist.get_world_size(group))


# ---------------------------------------------------------------------------
# tensor parallelism over the model axis
# ---------------------------------------------------------------------------

def tp_param_spec(path, leaf, model_size: int) -> tuple:
    """The JAX package's Megatron rule (`dg_sct_tpu/parallel/mesh.py:106`)
    for a leaf at `path` (its dict keys and list indices), as the entries of
    a PartitionSpec; () is replicated. A rule applies only where its
    dimension divides the model axis:
      * MLP: fc1 column-split with its bias, fc2 row-split;
      * window attention: qkv column-split, proj row-split;
      * adapter bottleneck (grouped kernels (g, in/g, out/g)): split over g."""
    keys = [p for p in path if isinstance(p, str)]
    if leaf.ndim == 2 and "mlp" in keys and "kernel" in keys:
        if "fc1" in keys and leaf.shape[1] % model_size == 0:
            return (None, MODEL_AXIS)
        if "fc2" in keys and leaf.shape[0] % model_size == 0:
            return (MODEL_AXIS, None)
    if (leaf.ndim == 1 and "mlp" in keys and "fc1" in keys and "bias" in keys
            and leaf.shape[0] % model_size == 0):
        return (MODEL_AXIS,)
    if leaf.ndim == 2 and "kernel" in keys:
        if "qkv" in keys and leaf.shape[1] % model_size == 0:
            return (None, MODEL_AXIS)
        if "proj" in keys and "attn" in keys and leaf.shape[0] % model_size == 0:
            return (MODEL_AXIS, None)
    if (leaf.ndim == 3 and "kernel" in keys and ("down" in keys or "up" in keys)
            and leaf.shape[0] % model_size == 0):
        return (MODEL_AXIS, None, None)
    return ()


def _attn_heads(attn) -> int:
    """An attention's head count from its per-head leaves."""
    if "logit_scale" in attn:
        return attn["logit_scale"].shape[0]
    return attn["rpb_table"].shape[1]


def tp_shard_params(params, mesh: Mesh):
    """This rank's tree under tensor parallelism over the mesh's model axis:
    each leaf `tp_param_spec` shards replaced by a copy of this rank's
    shard, the others kept (replicated). The qkv kernels are split by heads
    (`parallel.tp.qkv_columns`, Megatron's layout, not the contiguous
    columns of the JAX spec). An attention whose heads the model axis does
    not divide keeps its qkv and proj whole, where JAX's rule splits the
    qkv columns wherever 3C divides and GSPMD keeps the result exact: the
    block then runs whole on every rank (`parallel.tp.for_split`), with the
    same outputs and no collective. An MLP whose hidden width does not
    divide stays whole under both rules."""
    size, rank = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)

    def node(path):
        t = params
        for p in path:
            t = t[p]
        return t

    shards = {}
    for path, leaf in tree_paths(params):
        spec = tp_param_spec(path, leaf, size)
        if not spec:
            continue
        if "qkv" in path or ("attn" in path and "proj" in path):
            attn = node(path[:path.index("qkv" if "qkv" in path else "proj")])
            heads = _attn_heads(attn)
            if heads % size:
                continue
            if "qkv" in path:
                shards[path] = qkv_columns(leaf, heads, size, rank).clone()
                continue
        shards[path] = _part(leaf, spec.index(MODEL_AXIS), size, rank).clone()

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [build(v, prefix + (i,)) for i, v in enumerate(tree)]
        return shards.get(prefix, tree)

    return build(params)
