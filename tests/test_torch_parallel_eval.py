"""Tensor- and sequence-parallel eval of the port's AVE model
(dg_sct_tpu_torch: parallel.mesh.tp_param_spec and tp_shard_params,
parallel.tp, the `tp` and `seq` of models.ave.forward) in gloo worlds of
spawned CPU ranks (tests/torch_parallel_worker.py) against the JAX
package's eval forward on the same numpy weights and inputs, float32, JAX
at matmul precision "highest", kernels off (their plain versions).

`event_scores` and the other outputs within 1e-4, the tolerance of the JAX
package's own sharded-eval tests (tests/test_sharding.py). `tp_param_spec`
takes JAX's sharded-or-replicated decision on every leaf of the tiny tree;
the head-aligned qkv layout is checked on its own, and a TP rank's sharded
leaves are half their full size.
"""
import numpy as np
import jax
import pytest
import torch

from dg_sct_tpu.models import ave as JA
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.parallel import mesh as JM
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.parallel import mesh as PM
from dg_sct_tpu_torch.parallel.tp import qkv_columns
import torch_parallel_worker as W
from test_ave_model import tiny_cfg
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
OUTPUTS = ("is_event_scores", "event_scores", "av_gate", "av_score")


@pytest.fixture(scope="module")
def model():
    """Seeded tiny weights (scrambled adapters), inputs of B=4 clips and
    JAX's eval outputs on them, computed once."""
    torch.set_num_threads(2)
    jcfg = tiny_cfg()
    pcfg = port_cfg(jcfg)
    jp, js = scramble_adapters(*(to_numpy(t) for t in PA.init_ave_model(pcfg, device="cpu")))
    rs = np.random.RandomState(3)
    B, T = 4, jcfg.num_frames
    wave = rs.randn(B, T, jcfg.htsat.frontend.clip_samples).astype(np.float32)
    images = rs.rand(B, T, 64, 64, 3).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = to_numpy(jax.jit(lambda p, s, w, i: JA.forward(p, s, w, i, jcfg)[0])(
            jp, js, wave, images))
    return jcfg, pcfg, jp, js, wave, images, ref


def _check(results, ref):
    """Each rank's outputs against its clips' rows of JAX's."""
    for r in results:
        d, nd = r["data"]
        k = ref["event_scores"].shape[0] // nd
        for name in OUTPUTS:
            np.testing.assert_allclose(r["out"][name], ref[name][d * k:(d + 1) * k],
                                       err_msg=name, **TOL)


def test_tp_param_spec_matches_jax(model):
    """Sharded or replicated, leaf by leaf, as JAX's rule decides at model
    sizes 2 and 4; at 2 the leaves tests/test_sharding.py requires sharded
    are."""
    _, _, jp, _, _, _, _ = model
    for size in (2, 4):
        decided = []
        def both(path, leaf):
            keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            j = "model" in str(JM.tp_param_spec(path, leaf, size))
            p = PM.MODEL_AXIS in PM.tp_param_spec(keys, leaf, size)
            assert j == p, (keys, j, p)
            decided.append((keys, p))
        jax.tree_util.tree_map_with_path(both, jp)
        if size == 2:
            for name in ("qkv", "proj", "down", "up", "fc1", "fc2"):
                assert any(name in keys and p for keys, p in decided), name


def test_qkv_columns_are_head_aligned():
    """A rank's qkv columns are its heads' q, k and v columns (Megatron's
    layout), not a contiguous third of the kernel as JAX's spec lays them."""
    C, heads = 8, 4
    kernel = torch.arange(3 * C, dtype=torch.float32)[None].repeat(2, 1)
    for rank, want in ((0, [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19]),
                       (1, [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23])):
        assert qkv_columns(kernel, heads, 2, rank)[0].tolist() == want
    with pytest.raises(ValueError, match="heads"):
        qkv_columns(kernel, 3, 2, 0)


class _ModelAxis:
    """The model axis of a mesh, as `tp_shard_params` reads it."""

    def __init__(self, size, index):
        self._size, self._index = size, index

    def size(self, axis):
        return self._size

    def index(self, axis):
        return self._index


def test_tp_shard_params_splits_every_block_or_raises(model):
    """Every attention's and MLP's kernels are split, the adapters'
    bottlenecks where their groups divide the axis; at a model axis of 3,
    which divides none of the tiny model's heads (2) or hidden widths, an
    attention or MLP is split where its heads or hidden width divide 3 and
    whole where they do not."""
    _, pcfg, jp, js, _, _, _ = model
    from dg_sct_tpu_torch.utils.tree import tree_paths
    from dg_sct_tpu_torch.weights import from_jax
    pp, _ = from_jax(jp, js, pcfg, device="cpu")
    full = dict(tree_paths(pp))
    shard = dict(tree_paths(PM.tp_shard_params(pp, _ModelAxis(2, 1))))
    for path, t in full.items():
        keys = [k for k in path if isinstance(k, str)]
        if t.ndim == 2 and "kernel" in keys and ("qkv" in keys or "fc1" in keys):
            assert shard[path].shape[1] * 2 == t.shape[1], path
        if t.ndim == 2 and "kernel" in keys and ("proj" in keys or "fc2" in keys):
            assert shard[path].shape[0] * 2 == t.shape[0], path
        if t.ndim == 3 and "kernel" in keys and ("down" in keys or "up" in keys):
            assert shard[path].shape[0] * (2 if t.shape[0] % 2 == 0 else 1) == t.shape[0], path
    shard3 = dict(tree_paths(PM.tp_shard_params(pp, _ModelAxis(3, 0))))
    whole = 0
    for path, t in full.items():
        keys = [k for k in path if isinstance(k, str)]
        if t.ndim != 2 or "kernel" not in keys or path[1:2] != ("layers",):
            continue
        heads = getattr(pcfg, path[0]).num_heads[path[2]]
        if "qkv" in keys or "proj" in keys:
            n, axis = heads, 1 if "qkv" in keys else 0
        elif "fc1" in keys or "fc2" in keys:
            n, axis = t.shape[1 if "fc1" in keys else 0], 1 if "fc1" in keys else 0
        else:
            continue
        split = 3 if n % 3 == 0 else 1
        whole += split == 1
        assert shard3[path].shape[axis] * split == t.shape[axis], path
    assert whole > 0


def test_tp_eval_matches_jax(model, tmp_path):
    """data 2 x model 2: each rank's clips through the rank's shards; the
    sharded leaves are half their full size, the others whole."""
    _, pcfg, jp, js, wave, images, ref = model
    results = W.run_world(W.ave_eval, 4, tmp_path, "tp", (2, 2), pcfg, jp, js, wave, images)
    _check(results, ref)
    full = {"/".join(map(str, p)): list(np.shape(t))
            for p, t in jax.tree_util.tree_flatten_with_path(jp)[0]
            for p in [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)]}
    halved = 0
    for key, shape in results[0]["shapes"].items():
        keys = tuple(int(k) if k.isdigit() else k for k in key.split("/"))
        spec = PM.tp_param_spec(keys, np.empty(full[key], np.float32), 2)
        want = list(full[key])
        if spec:
            want[spec.index(PM.MODEL_AXIS)] //= 2
            halved += 1
        assert shape == want, key
    assert halved > 0


def test_sp_eval_matches_jax(model, tmp_path):
    """data 1 x seq 2: each rank runs half of every clip's frames, the
    heads' inputs gathered back in frame order."""
    _, pcfg, jp, js, wave, images, ref = model
    results = W.run_world(W.ave_eval, 2, tmp_path, "sp", (1, 2), pcfg, jp, js, wave, images)
    _check(results, ref)
