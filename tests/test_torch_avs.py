"""The port's AVS model (dg_sct_tpu_torch: configs, ops.basic.conv2d, the AVS
adapter variant, the interleave's stage taps and per-tower adapter options,
models.tpavi, models.heads.avs, models.avs, ops.quant.calibrate_avs,
train.metrics' mask metrics) against the JAX package on the same numpy
inputs and weights, float32 with JAX at matmul precision "highest", kernels
off (their plain versions; AVS adapters never take K3). Tolerance: atol 2e-4,
rtol 2e-3 per module and for the whole tiny forward (as
tests/test_torch_ave.py); the AVS adapters against DG-SCT's own
`VisualAdapter` copy through the goldens at tests/test_reference_golden.py's
tolerances; the int8 forward within half of JAX's int8-against-float drift
(as tests/test_torch_quant.py)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu import configs as JC
from dg_sct_tpu.models import adapter as JAd
from dg_sct_tpu.models import avs as JAvs
from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.models import tpavi as JTP
from dg_sct_tpu.models.heads import avs as JH
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.ops import quant as JQ
from dg_sct_tpu.train import metrics as JM
import dg_sct_tpu_torch.configs as PC
from dg_sct_tpu_torch.models import adapter as PAd
from dg_sct_tpu_torch.models import avs as PAvs
from dg_sct_tpu_torch.models import interleave as PI
from dg_sct_tpu_torch.models import tpavi as PTP
from dg_sct_tpu_torch.models.heads import avs as PH
from dg_sct_tpu_torch.ops import basic as PB
from dg_sct_tpu_torch.ops import quant as PQ
from dg_sct_tpu_torch.ops.basic import Init
from dg_sct_tpu_torch.train import metrics as PM
from dg_sct_tpu_torch.utils import torch_convert as PTC
from dg_sct_tpu_torch.weights import from_jax
from gen_reference_goldens import ADAPTER_SPECS
from refgold_common import load_census, outputs_path, rebuild_sd, synth
from test_avs_model import tiny_avs_cfg
from torch_port_helpers import to_numpy, to_torch

ATOL, RTOL = 2e-4, 2e-3
MIN_DIM = 16        # int8 at tiny widths, as tests/test_torch_quant.py
DRIFT_SHARE = 0.5   # int8: port against JAX, as a share of JAX's int8-against-float drift
AVS_FIELDS = ("num_frames", "channel", "mask_size", "tpavi_stages", "tpavi_vv_flag",
              "tpavi_va_flag", "scale_sizes")


def close(port, ref, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=msg)


def _fields(dc, **override):
    d = {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}
    d.update(override)
    return d


def _shapes(tree):
    """{leaf path: shape} of a nested dict / list tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda v: isinstance(v, torch.Tensor))[0]
    return {jax.tree_util.keystr(k): tuple(np.shape(v)) for k, v in leaves}


def tiny_avs_variant_cfg():
    """`tiny_avs_cfg` with AVS-variant adapters, as AVSModelConfig() has."""
    j = tiny_avs_cfg()
    avs_variant = lambda a: dataclasses.replace(a, avs_variant=True)
    return dataclasses.replace(j, adapter=avs_variant(j.adapter),
                               adapter_vis=avs_variant(j.adapter_vis))


def port_avs_cfg(jcfg):
    """The port's AVSModelConfig with every field of the JAX one."""
    h = jcfg.htsat
    frontend = PC.AudioFrontendConfig(**_fields(h.frontend, stft_compute=None))
    return PC.AVSModelConfig(
        swin=PC.SwinV2Config(**_fields(jcfg.swin)),
        htsat=PC.HTSATConfig(**_fields(h, frontend=frontend)),
        adapter=PC.AdapterConfig(**_fields(jcfg.adapter)),
        adapter_vis=PC.AdapterConfig(**_fields(jcfg.adapter_vis)),
        **{k: getattr(jcfg, k) for k in AVS_FIELDS})


def scramble_avs(params, state, seed=0):
    """Seeded nonzero adapter gates and TPAVI BN affines and statistics in a
    numpy AVS tree: all are zero at init, where they would hide their
    branch."""
    rs = np.random.RandomState(seed)
    for k in ("a_p1", "v_p1", "a_p2", "v_p2"):
        for ap in params["adapters"][k]:
            ap["gate_av"] = np.asarray([0.3 + 0.3 * rs.rand()], np.float32)
            if "gate" in ap:
                ap["gate"] = np.asarray([0.5 + 0.3 * rs.rand()], np.float32)
    for name, tp in params["tpavi"].items():
        n = tp["bn"]["scale"].shape[0]
        tp["bn"] = {"scale": (1.0 + 0.2 * rs.randn(n)).astype(np.float32),
                    "bias": (0.1 * rs.randn(n)).astype(np.float32)}
        st = state["tpavi"][name]["bn"]
        state["tpavi"][name]["bn"] = {"mean": (0.1 * rs.randn(n)).astype(np.float32),
                                      "var": (0.5 + rs.rand(n)).astype(np.float32),
                                      "count": st["count"]}
    return params, state


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine and slows these tiny
    forwards by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """Seeded tiny AVS weights (the port's initialiser) with nonzero gates and
    TPAVI BN, as numpy for JAX and carried across by from_jax; seeded
    inputs; JAX's interleave (taps) and whole forward, run once."""
    jcfg = tiny_avs_variant_cfg()
    pcfg = port_avs_cfg(jcfg)
    jp, js = scramble_avs(*(to_numpy(t) for t in PAvs.init_avs_model(pcfg, device="cpu")))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    rs = np.random.RandomState(1)
    T = jcfg.num_frames
    imgs = rs.rand(2, T, jcfg.mask_size, jcfg.mask_size, 3).astype(np.float32)
    wave = (0.3 * rs.randn(2, T, jcfg.htsat.frontend.clip_samples)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        fwd = jax.jit(lambda p, s, i, w: JAvs.forward(p, s, i, w, jcfg)[0])
        ref = jax.tree_util.tree_map(np.asarray, fwd(jp, js, imgs, wave))
        small = rs.rand(2 * T, jcfg.swin.img_size, jcfg.swin.img_size, 3).astype(np.float32)
        flat_wave = wave.reshape(2 * T, -1)
        taps = jax.jit(lambda p, s, w, i: JI.forward(p, s, w, i, jcfg,
                                                     return_stage_taps=True)[0])
        ref_taps = jax.tree_util.tree_map(np.asarray, taps(jp, js, flat_wave, small))
        yield dict(jcfg=jcfg, pcfg=pcfg, jp=jp, js=js, pp=pp, ps=ps, imgs=imgs, wave=wave,
                   ref=ref, fwd=fwd, small=small, flat_wave=flat_wave, ref_taps=ref_taps)


def _port_forward(t, params=None, **kw):
    with torch.inference_mode():
        return PAvs.forward(t["pp"] if params is None else params, t["ps"], t["imgs"],
                            t["wave"], t["pcfg"], device="cpu", kernels=False, **kw)


def test_config_matches_jax():
    j, p = JC.AVSModelConfig(), PC.AVSModelConfig()
    skip = ("compute_dtype", "swin", "htsat", "adapter", "adapter_vis")
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(p)]
    assert {k: v for k, v in _fields(j).items() if k not in skip} == {
        k: v for k, v in _fields(p).items() if k not in skip}
    for name in ("swin", "htsat", "adapter", "adapter_vis"):
        jf, pf = _fields(getattr(j, name)), _fields(getattr(p, name))
        jf.pop("frontend", None), pf.pop("frontend", None)
        assert jf == pf, name
    assert p.compute_dtype == torch.float32
    assert PC.vis_adapter_cfg(p) is p.adapter_vis
    assert PC.vis_adapter_cfg(PC.AVEModelConfig()) == PC.AdapterConfig()


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,cin,cout,bias", [(3, 6, 5, True), (1, 7, 3, True), (3, 4, 4, False)])
def test_conv2d_matches_jax(k, cin, cout, bias):
    jp = to_numpy(JB.conv2d_init(jax.random.PRNGKey(k + cin), k, k, cin, cout, bias=bias))
    x = np.random.RandomState(cin).randn(2, 9, 7, cin).astype(np.float32)
    ref = JB.conv2d(jp, jnp.asarray(x))
    got = PB.conv2d(to_torch(jp), torch.from_numpy(x))
    assert got.shape == (2, 9, 7, cout)
    close(got, ref)
    pp = PB.conv2d_init(Init(torch.Generator().manual_seed(0), "cpu"), k, k, cin, cout, bias)
    assert {n: tuple(v.shape) for n, v in pp.items()} == {n: v.shape for n, v in jp.items()}


@pytest.mark.parametrize("with_audio", [True, False], ids=["audio", "video"])
def test_tpavi_matches_jax(with_audio):
    rs = np.random.RandomState(2)
    p, s = JTP.init_tpavi(jax.random.PRNGKey(0), 16)
    p, s = to_numpy(p), to_numpy(s)
    p["bn"] = {"scale": (1.0 + 0.2 * rs.randn(16)).astype(np.float32),
               "bias": (0.1 * rs.randn(16)).astype(np.float32)}
    s["bn"] = {"mean": (0.1 * rs.randn(16)).astype(np.float32),
               "var": (0.5 + rs.rand(16)).astype(np.float32), "count": s["bn"]["count"]}
    x = rs.randn(2, 3, 4, 5, 16).astype(np.float32)
    audio = rs.randn(2, 3, 8).astype(np.float32) if with_audio else None
    z, a, _ = JTP.tpavi(p, s, jnp.asarray(x), None if audio is None else jnp.asarray(audio))
    pz, pa, _ = PTP.tpavi(to_torch(p), to_torch(s), torch.from_numpy(x),
                          None if audio is None else torch.from_numpy(audio))
    close(pz, z)
    if with_audio:
        close(pa, a)
    else:
        assert pa is None and a is None
    pp, ps = PTP.init_tpavi(Init(None, "meta"), 16)
    assert _shapes(pp) == _shapes(p) and _shapes(ps) == _shapes(s)


def test_avs_temporal_attention_matches_jax(tiny):
    pcfg = tiny["pcfg"]
    params = to_numpy(PH.init_avs_temporal_attention(
        Init(torch.Generator().manual_seed(3), "cpu"), pcfg.channel))
    rs = np.random.RandomState(3)
    B, T, C = 2, pcfg.num_frames, pcfg.channel
    maps = [rs.randn(B * T, s, s, C).astype(np.float32) for s in pcfg.scale_sizes]
    audio = rs.randn(B, T, C // 2).astype(np.float32)
    ref_maps, ref_audio = JH.avs_temporal_attention(params, [jnp.asarray(m) for m in maps],
                                                    jnp.asarray(audio), num_frames=T)
    got_maps, got_audio = PH.avs_temporal_attention(to_torch(params),
                                                    [torch.from_numpy(m) for m in maps],
                                                    torch.from_numpy(audio), num_frames=T)
    for g, r in zip(got_maps, ref_maps):
        close(g, r)
    close(got_audio, ref_audio)
    assert not np.allclose(got_maps[0].numpy(), maps[0])  # the gates act


@pytest.mark.parametrize("with_skip", [False, True])
def test_feature_fusion_block_matches_jax(with_skip):
    p = to_numpy(JAvs.init_feature_fusion_block(jax.random.PRNGKey(1), 8))
    rs = np.random.RandomState(4)
    x = rs.randn(2, 7, 7, 8).astype(np.float32)
    skip = rs.randn(2, 7, 7, 8).astype(np.float32) if with_skip else None
    ref = JAvs.feature_fusion_block(p, jnp.asarray(x), None if skip is None else jnp.asarray(skip))
    got = PAvs.feature_fusion_block(to_torch(p), torch.from_numpy(x),
                                    None if skip is None else torch.from_numpy(skip))
    assert got.shape == (2, 14, 14, 8)
    close(got, ref)


# (dim, other_dim, tokens_self, tokens_other): square token grids both ways
AVS_GEOMETRIES = [(32, 16, 64, 16), (16, 32, 16, 64)]


@pytest.mark.parametrize("use_gate", [False, True], ids=["audio", "visual"])
@pytest.mark.parametrize("geom", AVS_GEOMETRIES)
def test_avs_adapter_matches_jax(geom, use_gate, monkeypatch):
    """The AVS variant (align, then bicubic token resize; no ln_before; gate
    before ln_post), folded as the engine folds it, with kernels on: it must
    never reach K3 (the JAX package routes it off its fused bottleneck)."""
    dim, other_dim, n_self, n_other = geom
    jcfg = JC.AdapterConfig(reduction_factor=2, num_tokens=4, use_bn=False,
                            use_gate=use_gate, avs_variant=True)
    pcfg = PC.AdapterConfig(**_fields(jcfg))
    p, s = JAd.init_adapter(jax.random.PRNGKey(5), dim=dim, other_dim=other_dim,
                            num_tokens_self=n_self, num_tokens_other=n_other, cfg=jcfg)
    p, s = to_numpy(p), to_numpy(s)
    rs = np.random.RandomState(5)
    p["gate_av"] = np.asarray([0.4], np.float32)
    if use_gate:
        p["gate"] = np.asarray([0.7], np.float32)
    x = rs.randn(2, n_self, dim).astype(np.float32)
    other = rs.randn(2, n_other, other_dim).astype(np.float32)
    ref, ref_maps, _ = JAd.adapter(p, s, jnp.asarray(x), jnp.asarray(other), jcfg)
    fp, fs = PAd.fold_eval(to_torch(p), to_torch(s), pcfg)
    assert sorted(fp) == sorted(p) and ("gate" in fp) == use_gate  # the fold leaves it alone

    def no_k3(*args, **kw):
        raise AssertionError("an AVS adapter reached K3")

    monkeypatch.setattr(PAd, "fused_bottleneck", no_k3)
    got, maps, _ = PAd.adapter(fp, fs, torch.from_numpy(x), torch.from_numpy(other), pcfg,
                               kernels=True)
    close(got, ref)
    close(maps, ref_maps)


@pytest.mark.parametrize("comp", ["avs_adapter_audio", "avs_adapter_visual"])
def test_avs_adapter_matches_dgsct_golden(comp):
    """The port's converter and AVS adapter against DG-SCT's own AVS
    `VisualAdapter` (tests/golden/refgold_*), at the tolerances of
    tests/test_reference_golden.py."""
    dim, N, odim, M, groups, tokens, use_bn, use_gate, B = ADAPTER_SPECS[comp]
    sd = rebuild_sd(load_census(comp))
    gold = np.load(outputs_path(comp))
    params, state = PTC.convert_adapter(sd, "m", groups=groups)
    cfg = PC.AdapterConfig(reduction_factor=8, num_tokens=tokens, num_conv_group=groups,
                           use_bn=use_bn, use_gate=use_gate, avs_variant=True)
    x = synth(f"__in__/{comp}/x", (B, dim, N, 1), is_input=True)
    vt = synth(f"__in__/{comp}/vt", (B, odim, M, 1), is_input=True)
    out, maps, _ = PAd.adapter(to_torch(params), to_torch(state),
                               torch.from_numpy(x[:, :, :, 0].transpose(0, 2, 1).copy()),
                               torch.from_numpy(vt[:, :, :, 0].transpose(0, 2, 1).copy()),
                               cfg, kernels=False)
    close(out, gold["out"][:, :, :, 0].transpose(0, 2, 1), atol=2e-5, rtol=2e-4)
    close(maps, gold["maps"], atol=2e-6, rtol=2e-4)


def test_stage_taps_match_jax(tiny):
    """interleave.forward(return_stage_taps=True) against JAX's; the other
    outputs are bit-identical to a call without taps (the AVE path)."""
    t = tiny
    wave, small = torch.from_numpy(t["flat_wave"]), torch.from_numpy(t["small"])
    with torch.inference_mode():
        got, _ = PI.forward(t["pp"], t["ps"], wave, small, t["pcfg"], kernels=False,
                            return_stage_taps=True)
        plain, _ = PI.forward(t["pp"], t["ps"], wave, small, t["pcfg"], kernels=False)
    ref = t["ref_taps"]
    assert len(got["stage_taps"]) == 4 and "stage_taps" not in plain
    for i, (g, r) in enumerate(zip(got["stage_taps"], ref["stage_taps"])):
        close(g, r, msg=f"tap {i}")
    for k in ("f_v", "f_a", "vis_tokens"):
        close(got[k], ref[k], msg=k)
        assert torch.equal(got[k], plain[k]), k
    close(got["stage_taps"][-1], got["vis_tokens"])  # the last tap is swin.norm'd


def test_per_tower_adapter_configs(tiny):
    """The visual adapters take adapter_vis (their gate), the audio ones
    adapter (none), in init, in the fold and in the forward."""
    t = tiny
    p, s = PI.init_adapters(Init(None, "meta"), t["pcfg"])
    assert all("gate" in ap for k in ("v_p1", "v_p2") for ap in p[k])
    assert not any("gate" in ap for k in ("a_p1", "a_p2") for ap in p[k])
    assert not any("ln_before" not in ap or "bn1" in ap for k in p for ap in p[k])
    fp, _ = PI.fold_adapters_eval(t["pp"], t["ps"], t["pcfg"])
    assert all("gate" in ap for k in ("v_p1", "v_p2") for ap in fp["adapters"][k])


def test_tiny_avs_forward_matches_jax(tiny):
    got, ref = _port_forward(tiny), tiny["ref"]
    cfg = tiny["pcfg"]
    assert got["pred"].shape == (2 * cfg.num_frames, cfg.mask_size, cfg.mask_size, 1)
    close(got["pred"], ref["pred"], msg="pred")
    for i, (g, r) in enumerate(zip(got["feature_map_list"], ref["feature_map_list"])):
        close(g, r, msg=f"feature map {i}")
    for i, (g, r) in enumerate(zip(got["a_fea_list"], ref["a_fea_list"])):
        assert (g is None) == (r is None) == (i not in cfg.tpavi_stages), i
        if g is not None:
            close(g, r, msg=f"a_fea {i}")


def test_tiny_avs_forward_kernels_and_vv(tiny):
    """kernels=True on CPU tensors takes the plain versions (same output);
    with video self-attention on too, the forward still matches JAX's."""
    t = tiny
    with torch.inference_mode():
        on = PAvs.forward(t["pp"], t["ps"], t["imgs"], t["wave"], t["pcfg"], device="cpu")
    close(on["pred"], t["ref"]["pred"])
    jcfg = dataclasses.replace(t["jcfg"], tpavi_vv_flag=True)
    pcfg = dataclasses.replace(t["pcfg"], tpavi_vv_flag=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        fwd = jax.jit(lambda p, s, i, w: JAvs.forward(p, s, i, w, jcfg)[0]["pred"])
        ref = fwd(t["jp"], t["js"], t["imgs"], t["wave"])
    with torch.inference_mode():
        got = PAvs.forward(t["pp"], t["ps"], t["imgs"], t["wave"], pcfg, device="cpu")["pred"]
    close(got, ref)


def test_entry_points_need_the_card_unless_asked(tiny, monkeypatch):
    t = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PAvs.init_avs_model(t["pcfg"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PAvs.forward(t["pp"], t["ps"], t["imgs"], t["wave"], t["pcfg"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax(t["jp"], t["js"], t["pcfg"])


# ---------------------------------------------------------------------------
# int8: calibrate_avs and the int8 forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(tiny):
    t = tiny
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        j = JQ.calibrate_avs(t["jp"], t["js"], t["jcfg"], jnp.asarray(t["wave"]),
                             jnp.asarray(t["imgs"]), min_dim=MIN_DIM)
    p = PQ.calibrate_avs(t["pp"], t["ps"], t["pcfg"], t["wave"], t["imgs"], min_dim=MIN_DIM,
                         device="cpu")
    return j, p


def test_calibrate_avs_matches_jax(calibrated):
    j, p = calibrated
    assert sorted(p) == sorted(j) and len(p) > 10
    for q in j:
        np.testing.assert_allclose(p[q], j[q], rtol=1e-4, err_msg=f"qid {q}")


def _spread_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)


def test_int8_forward_matches_jax(tiny, calibrated):
    """The tiny int8 forward (towers, JAX's static scales on both sides)
    within half of JAX's int8-against-float drift of the mask logits."""
    t = tiny
    scales = calibrated[0]
    jq = JQ.quantize_eval_params(t["jp"], min_dim=MIN_DIM, act_scales=scales)
    pq = PQ.quantize_eval_params(t["pp"], min_dim=MIN_DIM, act_scales=scales)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = np.asarray(t["fwd"](jq, t["js"], t["imgs"], t["wave"])["pred"])
    got = _port_forward(t, pq)["pred"].numpy()
    err, drift = _spread_err(got, ref), _spread_err(ref, t["ref"]["pred"])
    assert drift > 1e-4  # the towers ran in int8
    assert err < DRIFT_SHARE * drift, (err, drift)


# ---------------------------------------------------------------------------
# mask metrics
# ---------------------------------------------------------------------------

def _masks(seed, n=6, size=24):
    rs = np.random.RandomState(seed)
    probs = rs.rand(n, size, size).astype(np.float32)
    gt = (rs.rand(n, size, size) > 0.6).astype(np.float32)
    gt[1] = 0.0  # an all-background mask takes the no-object rule
    return probs, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_metrics_match_jax(seed):
    probs, gt = _masks(seed)
    assert PM.mask_iou(probs, gt) == pytest.approx(JM.mask_iou(probs, gt), rel=1e-6)
    assert PM.f_measure(probs, gt) == pytest.approx(JM.f_measure(probs, gt), rel=1e-6)
    assert PM.mask_iou(gt, gt) == pytest.approx(1.0)
    assert PM.f_measure(np.zeros_like(gt[1:2]), gt[1:2]) == 0.0


def test_save_masks_matches_jax(tmp_path):
    from PIL import Image

    probs, _ = _masks(2, n=4)
    cats, vids = ["a", "b"], ["v0", "v1"]
    PM.save_masks(probs, str(tmp_path / "port"), cats, vids, num_frames=2)
    JM.save_masks(probs, str(tmp_path / "jax"), cats, vids, num_frames=2)
    for cat, vid in zip(cats, vids):
        for t in range(2):
            rel = f"{cat}/{vid}/{vid}_{t}.png"
            got = np.asarray(Image.open(tmp_path / "port" / rel))
            np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "jax" / rel)))
