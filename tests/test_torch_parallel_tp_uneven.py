"""Tensor-parallel eval of the port's AVE model at 4 model ranks on a model
whose heads do not all divide the axis (dg_sct_tpu_torch: parallel.tp's
`for_split`, mesh.tp_shard_params), in one gloo world of 4 spawned CPU
ranks (tests/torch_parallel_worker.py) against the JAX package's own TP eval
on a (data 1 x model 4) CPU mesh and its one-device forward, float32, JAX
at matmul precision "highest", kernels off.

The tiny config has a 6-head Swin stage (embed 24), as Swin-V2-L's stage 0
has at full width, and a 2-head HTS-AT stage: those attentions stay whole on
every rank, the 4-head ones are split by heads. Outputs within 1e-4, the
tolerance of `test_tp_eval_matches_jax`.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from dg_sct_tpu.models import ave as JA
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.parallel import mesh as JM
from dg_sct_tpu_torch.models import ave as PA
import torch_parallel_worker as W
from test_ave_model import tiny_cfg
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
OUTPUTS = ("is_event_scores", "event_scores", "av_gate", "av_score")
MODEL = 4


def uneven_cfg():
    """tiny_cfg with Swin heads (6, 4, 4, 4) at embed 24 and HTS-AT heads
    (2, 4, 4, 4): stage 0 of each tower does not split over 4 ranks."""
    cfg = tiny_cfg()
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, embed_dim=24, num_heads=(6, 4, 4, 4)),
        htsat=dataclasses.replace(cfg.htsat, num_heads=(2, 4, 4, 4)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's one-device and (1 x 4) TP outputs and the port's 4 TP ranks'
    results on the same seeded weights and B=2 clips, computed once."""
    torch.set_num_threads(2)
    jcfg = uneven_cfg()
    pcfg = port_cfg(jcfg)
    jp, js = scramble_adapters(*(to_numpy(t) for t in PA.init_ave_model(pcfg, device="cpu")))
    rs = np.random.RandomState(5)
    B, T = 2, jcfg.num_frames
    wave = rs.randn(B, T, jcfg.htsat.frontend.clip_samples).astype(np.float32)
    images = rs.rand(B, T, 64, 64, 3).astype(np.float32)
    fwd = jax.jit(lambda p, s, w, i: JA.forward(p, s, w, i, jcfg)[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        one = to_numpy(fwd(jp, js, wave, images))
        m = JM.make_mesh_2d(1, MODEL)
        tp = to_numpy(fwd(JM.tp_shard_params(jp, m), JM.replicate(js, m),
                          JM.shard_batch(wave, m), JM.shard_batch(images, m)))
    ranks = W.run_world(W.ave_eval, MODEL, tmp_path_factory.mktemp("tp4"), "tp", (1, MODEL),
                        pcfg, jp, js, wave, images)
    return pcfg, jp, one, tp, ranks


@pytest.mark.parametrize("ref", ["jax_tp", "one_device"])
def test_tp4_matches_jax(run, ref):
    """Every rank's outputs against JAX's (1 x 4) TP eval and against its
    one-device forward."""
    _, _, one, tp, ranks = run
    want = tp if ref == "jax_tp" else one
    assert len(ranks) == MODEL
    for r in ranks:
        assert tuple(r["data"]) == (0, 1)
        for name in OUTPUTS:
            np.testing.assert_allclose(r["out"][name], want[name], err_msg=name, **TOL)


def test_tp4_splits_what_divides(run):
    """A rank holds a quarter of each attention whose heads divide 4 (qkv by
    columns, proj by rows) and of each MLP whose hidden width does, and the
    whole of every other leaf: the 6- and 2-head stages' qkv and proj, the
    2-group adapters' bottlenecks, every per-head leaf."""
    pcfg, jp, _, _, ranks = run
    full = {"/".join(map(str, p)): list(np.shape(t))
            for p, t in jax.tree_util.tree_flatten_with_path(jp)[0]
            for p in [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)]}
    counts = {"split attention": 0, "whole attention": 0, "split mlp": 0}
    for r in ranks:
        assert set(r["shapes"]) == set(full)
        for key, shape in r["shapes"].items():
            keys = key.split("/")
            want = list(full[key])
            if keys[1:2] == ["layers"] and keys[-1] == "kernel" and len(want) == 2:
                heads = getattr(pcfg, keys[0]).num_heads[int(keys[2])]
                if "qkv" in keys or "proj" in keys:
                    split = heads % MODEL == 0
                    want[1 if "qkv" in keys else 0] //= MODEL if split else 1
                    counts["split attention" if split else "whole attention"] += 1
                elif "fc1" in keys or "fc2" in keys:
                    axis = 1 if "fc1" in keys else 0
                    assert want[axis] % MODEL == 0
                    want[axis] //= MODEL
                    counts["split mlp"] += 1
            elif keys[1:2] == ["layers"] and keys[-2:] == ["fc1", "bias"]:
                want[0] //= MODEL
            assert shape == want, key
    assert all(counts.values()), counts
