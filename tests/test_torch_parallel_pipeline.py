"""GPipe (dg_sct_tpu_torch.parallel.pipeline) and the pipelined stage 2 of
the interleave (`pipeline` of models.ave.forward) in gloo worlds of spawned
CPU ranks (tests/torch_parallel_worker.py), float32.

`gpipe` against the sequential stage loop at 1e-6, on the synthetic MLP at
tests/test_pipeline.py's (pipe, n_stages, n_micro) = (4, 8, 3) and, at a
world the CPU holds, (2, 8, 5) for its (8, 8, 5); a tree carry; the stages
as a list and stacked; indivisible stages raise. The interleave with stage
2 pipelined over 2 ranks in 2 microbatches against the JAX package's
unpipelined eval forward within 1e-4, on a configuration whose stage 2
forms 2 pairs (Swin depth 12, HTS-AT depth 4): tests/test_pipeline.py's
stage 2 (depths 6 and 2) forms one, which JAX's `_detect_scan_pairs` does
not pipeline.
"""
import numpy as np
import jax
import pytest
import torch

from dg_sct_tpu import configs as JC
from dg_sct_tpu.models import ave as JA
from dg_sct_tpu.models import htsat as JH
from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.models import swinv2 as JS
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu_torch.models import ave as PA
import torch_parallel_worker as W
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy

PIPE_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(atol=1e-4, rtol=1e-4)
OUTPUTS = ("is_event_scores", "event_scores", "av_gate", "av_score")


def _check_cases(results, cases):
    for r in results:
        for (kind, n_stages, n_micro, _), got in zip(cases, r):
            if n_stages % len(results):
                assert "not divisible" in got["error"]
                continue
            g, ref = got["got"], got["ref"]
            if kind == "mlp":
                g, ref = [g], [ref]
            for a, b in zip(g, ref):
                np.testing.assert_allclose(a, b, **PIPE_TOL)


def test_gpipe_matches_sequential_over_4_ranks(tmp_path):
    cases = [("mlp", 8, 3, False), ("mlp", 8, 3, True), ("pair", 4, 3, True),
             ("mlp", 6, 2, False)]
    _check_cases(W.run_world(W.gpipe_cases, 4, tmp_path, cases), cases)


def test_gpipe_matches_sequential_over_2_ranks(tmp_path):
    cases = [("mlp", 8, 5, False), ("pair", 4, 3, False)]
    _check_cases(W.run_world(W.gpipe_cases, 2, tmp_path, cases), cases)


def pipe_cfg():
    """Stage 2 of Swin depth 12 and HTS-AT depth 4: four groups of
    [None, None, paired], two repeated pairs."""
    frontend = JC.AudioFrontendConfig(sample_rate=3200, clip_seconds=1, n_fft=256,
                                      hop_size=320, mel_bins=16, fmax=1500.0,
                                      spec_size=32, time_drop_width=8)
    swin = JC.SwinV2Config(img_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 12, 1),
                           num_heads=(2, 2, 2, 2), window_size=4, drop_path_rate=0.0)
    htsat = JC.HTSATConfig(spec_size=32, patch_size=4, embed_dim=8, depths=(1, 1, 4, 1),
                           num_heads=(2, 2, 2, 2), window_size=4, drop_path_rate=0.0,
                           frontend=frontend)
    return JC.AVEModelConfig(swin=swin, htsat=htsat,
                             adapter=JC.AdapterConfig(reduction_factor=2, num_tokens=4),
                             num_frames=2)


def test_interleave_pipelined_stage2_matches_jax(tmp_path):
    torch.set_num_threads(2)
    jcfg = pipe_cfg()
    layout = JC.ave_paired_layout(jcfg.swin, jcfg.htsat)
    pairs = JI._detect_scan_pairs(layout[2], JS.block_plan(jcfg.swin)[2],
                                  JH.block_plan(jcfg.htsat)[2])
    assert pairs is not None and len(pairs) == 2
    pcfg = port_cfg(jcfg)
    jp, js = scramble_adapters(*(to_numpy(t) for t in PA.init_ave_model(pcfg, device="cpu")))
    rs = np.random.RandomState(4)
    wave = rs.randn(2, 2, jcfg.htsat.frontend.clip_samples).astype(np.float32)
    images = rs.rand(2, 2, 64, 64, 3).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = to_numpy(jax.jit(lambda p, s, w, i: JA.forward(p, s, w, i, jcfg)[0])(
            jp, js, wave, images))
    results = W.run_world(W.ave_eval, 2, tmp_path, "pipe", None, pcfg, jp, js, wave, images, 2)
    for r in results:
        assert r["pipelined"] == [2], r["pipelined"]
        for name in OUTPUTS:
            np.testing.assert_allclose(r["out"][name], ref[name], err_msg=name, **TOL)
