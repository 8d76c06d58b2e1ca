"""The port's int8 serving (dg_sct_tpu_torch/ops/quant.py, K4's plain version,
the int8 attention core, the engine's int8 options) against the JAX package's
`dg_sct_tpu/ops/quant.py` on the CPU, at tiny widths with min_dim=16 as
tests/test_quant.py uses, inputs from seeded numpy and weights carried by
`weights.from_jax`; and the walk at full width (on the "meta" device) against
the committed calibration file perf/bench_ascales_adapters.json.

Tolerances: one int8 linear in float32 rtol 1e-6 (the same arithmetic step
for step); in bfloat16 one bf16 step. Whole int8 forwards in float32: every
quantized linear's output against JAX's `linear_int8` on the same input and
JAX's quantized leaf of the same qid (rtol 1e-6), and event_scores and
is_event_scores within half of the int8-against-float drift of the same
case (max |delta| over the logit spread), so a forward that quantized too
little or not at all fails; the two packages round the same values and
differ only where float32 noise moves a value across a rounding boundary."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.models import ave as JA
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.ops import quant as JQ
from dg_sct_tpu.ops import windows as JW
from dg_sct_tpu_torch.configs import AVEModelConfig
from dg_sct_tpu_torch.models import adapter as PAd
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.models import htsat as PH
from dg_sct_tpu_torch.models import swinv2 as PS
from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
from dg_sct_tpu_torch.ops import basic as PB
from dg_sct_tpu_torch.ops import quant as PQ
from dg_sct_tpu_torch.ops import windows as PW
from dg_sct_tpu_torch.ops.kernels import int8_linear as K4
from dg_sct_tpu_torch.serve import AVEInferenceEngine
from dg_sct_tpu_torch.utils.tree import tree_paths
from dg_sct_tpu_torch.weights import from_jax
from test_ave_model import tiny_cfg
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy, to_torch

REPO = Path(__file__).resolve().parents[1]
SCALES = REPO / "perf" / "bench_ascales_adapters.json"
TOWERS = ("swin", "htsat")
ALL = ("swin", "htsat", "adapters")
MIN_DIM = 16
DRIFT_SHARE = 0.5  # port against JAX, as a share of JAX's int8-against-float drift


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """Seeded tiny weights (the port's initialiser; JAX's is slow on the CPU)
    with nonzero adapter gates, as numpy trees key-sorted as JAX's are, and
    carried back by `from_jax`; seeded inputs; JAX's parity GELU."""
    jcfg = tiny_cfg()
    pcfg = port_cfg(jcfg)
    jp, js = scramble_adapters(*(to_numpy(t) for t in PA.init_ave_model(pcfg, device="cpu")))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    rs = np.random.RandomState(2)
    wave = (0.1 * rs.randn(2, jcfg.num_frames, jcfg.htsat.frontend.clip_samples)).astype(
        np.float32)
    imgs = rs.rand(2, jcfg.num_frames, 64, 64, 3).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        yield jcfg, pcfg, jp, js, pp, ps, wave, imgs


def _jax_forward(jcfg, params, state, wave, imgs):
    fwd = jax.jit(lambda p, s, w, i: JA.forward(p, s, w, i, jcfg, train=False)[0])
    return {k: np.asarray(v) for k, v in fwd(params, state, wave, imgs).items()}


def _port_forward(pcfg, params, state, wave, imgs, **kw):
    with torch.inference_mode():
        out = PA.forward(params, state, torch.from_numpy(wave), torch.from_numpy(imgs), pcfg,
                         device="cpu", **kw)
    return {k: v.numpy() for k, v in out.items()}


def _spread_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)


# ---------------------------------------------------------------------------
# one linear
# ---------------------------------------------------------------------------

def test_quantize_linear_matches_jax():
    rs = np.random.RandomState(0)
    p = {"kernel": (0.05 * rs.randn(96, 40)).astype(np.float32),
         "bias": (0.1 * rs.randn(40)).astype(np.float32)}
    p["kernel"][:, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    jq = JQ.quantize_linear({k: jnp.asarray(v) for k, v in p.items()})
    pq = PQ.quantize_linear(to_torch(p))
    assert pq["kernel_q"].dtype == torch.int8 and pq["kernel_q"].shape == (96, 40)
    assert pq["kernel_q"].t().is_contiguous()  # K4's (out, in) rows
    np.testing.assert_array_equal(pq["kernel_q"].numpy(), np.asarray(jq["kernel_q"]))
    assert pq["kscale"].dtype == torch.float32
    np.testing.assert_array_max_ulp(pq["kscale"].numpy(), np.asarray(jq["kscale"]), maxulp=1)
    np.testing.assert_array_equal(pq["bias"].numpy(), p["bias"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_linear_int8_matches_jax(mode, dtype):
    rs = np.random.RandomState(1)
    p = {"kernel": (0.05 * rs.randn(128, 48)).astype(np.float32),
         "bias": (0.1 * rs.randn(48)).astype(np.float32)}
    x = (rs.randn(3, 17, 128) * np.linspace(0.1, 3.0, 17)[None, :, None]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = JQ.quantize_linear({k: jnp.asarray(v, jdt) for k, v in p.items()})
    pp = PQ.quantize_linear({k: torch.from_numpy(v).to(tdt) for k, v in p.items()})
    if mode == "static":
        absmax = float(np.abs(x).max()) * 0.7  # some values clip
        jp["ascale"] = jnp.float32(absmax / 127.0)
        pp["ascale"] = torch.tensor(absmax / 127.0, dtype=torch.float32)
    ref = np.asarray(JQ.linear_int8(jp, jnp.asarray(x, jdt)).astype(jnp.float32))
    got = PQ.linear_int8(pp, torch.from_numpy(x).to(tdt)).float().numpy()
    assert got.shape == (3, 17, 48)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    else:  # one bf16 step: 2^-7 of the larger magnitude
        step = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(ref))
        assert (np.abs(got - ref) <= step).all(), np.abs(got - ref).max()


def test_plain_product_is_exact():
    """The plain version's float64 product of integer-valued operands equals
    an int32 product bit for bit, at the deepest K of the main path."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (24, 6144), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (6144, 16), generator=g, dtype=torch.int8)
    a[0] = 127
    b[:, 0] = 127  # the largest sum, 127^2 * 6144
    exact = a.to(torch.int32) @ b.to(torch.int32)
    f64 = a.to(torch.float64) @ b.to(torch.float64)
    assert torch.equal(f64.to(torch.int64), exact.to(torch.int64))
    assert exact[0, 0] == 127 * 127 * 6144
    # and through the plain version: unit scales, no bias, float32 out
    y = K4.linear_int8_plain(a.float(), b, torch.ones(16), torch.tensor(1.0))
    assert torch.equal(y, exact.float())


def test_int8_linear_wrapper_never_falls_back():
    """On a device other than the CPU the wrapper launches K4 or raises; on
    "meta" (no kernel) it raises."""
    x = torch.empty(64, 128, device="meta")
    wq = torch.empty(128, 64, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K4.int8_linear(x, wq, torch.empty(64, device="meta"))


# ---------------------------------------------------------------------------
# the walk and the scale files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("towers", [TOWERS, ALL])
def test_qid_shape_map_matches_jax(tiny, towers):
    _, _, jp, _, pp, _, _, _ = tiny
    want = JQ.qid_shape_map(JQ._ordered_towers(jp, towers), min_dim=MIN_DIM)
    got = PQ.qid_shape_map(PQ._ordered_towers(pp, towers), min_dim=MIN_DIM)
    assert len(got) > 10 and got == want


@pytest.fixture(scope="module")
def full_meta():
    cfg = AVEModelConfig()
    return (cfg,) + tuple(PA.init_ave_model(cfg, device="meta"))


@pytest.mark.parametrize("folded", [False, True])
def test_full_width_walk_matches_scale_file(full_meta, folded):
    """The full-width walk reproduces the fingerprint JAX wrote: 431 eligible
    linears (qid 99, HTS-AT's head, is never called: 430 scales), 143 in the
    towers alone."""
    cfg, params, state = full_meta
    if folded:
        params, state = fold_adapters_eval(params, state, cfg)
    expect = PQ.qid_shape_map(PQ._ordered_towers(params, ALL))
    raw = json.loads(SCALES.read_text())
    assert expect == {int(k): tuple(v) for k, v in raw["shapes"].items()}
    assert len(expect) == 431 and expect[0] == (192, 192) and expect[99] == (527, 527)
    scales = PQ.load_scales(str(SCALES), expect)
    assert scales is not None and len(scales) == 430 and 99 not in scales
    assert len(PQ.qid_shape_map(PQ._ordered_towers(params, TOWERS))) == 143


@pytest.mark.parametrize("towers,calls", [(ALL, 430), (TOWERS, 142)])
def test_full_width_int8_calls_per_forward(full_meta, towers, calls):
    """One B=2 forward calls 430 quantized linears (142 for the towers alone),
    each once per forward but the HTS-AT head, which no forward calls."""
    cfg, params, state = full_meta
    wave = torch.empty(2, cfg.num_frames, cfg.htsat.frontend.clip_samples, device="meta")
    imgs = torch.empty(2, cfg.num_frames, 192, 192, 3, device="meta")
    rec = PQ.Recorder()
    tagged = dict(params)
    tagged.update(PQ.attach_qtags(PQ._ordered_towers(params, towers), recorder=rec))
    with torch.inference_mode():
        PA.forward(tagged, state, wave, imgs, cfg, kernels=False, device="meta")
    qids = [q for q, _ in rec.calls]
    assert len(qids) == calls and len(set(qids)) == calls
    assert 99 not in qids


def test_scale_file_roundtrip(tmp_path):
    p = str(tmp_path / "s.json")
    scales, shapes = {0: 1.5, 1: 0.25}, {0: (256, 512), 1: (512, 256)}
    PQ.save_scales(p, scales, shapes)
    assert PQ.load_scales(p, shapes) == scales
    assert PQ.load_scales(p) == scales
    assert JQ.load_scales(p, shapes) == scales  # JAX reads the port's file
    assert PQ.load_scales(p, {0: (256, 512), 1: (512, 999)}) is None  # stale
    assert PQ.load_scales(p, {0: (256, 512)}) is None
    with open(p, "w") as f:  # legacy flat format: checked by count only
        json.dump({"0": 1.5, "1": 0.25}, f)
    assert PQ.load_scales(p, shapes) == scales
    assert PQ.load_scales(p, {0: (256, 512)}) is None


def test_legacy_towers_scale_file_is_stale(full_meta):
    """perf/bench_ascales.json holds 142 flat entries against 143 towers-only
    qids, so both packages read it as stale."""
    _, params, _ = full_meta
    shapes = PQ.qid_shape_map(PQ._ordered_towers(params, TOWERS))
    path = str(REPO / "perf" / "bench_ascales.json")
    assert PQ.load_scales(path, shapes) is None
    assert JQ.load_scales(path, shapes) is None
    assert len(PQ.load_scales(path)) == 142


# ---------------------------------------------------------------------------
# calibration and the int8 forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(tiny):
    """{towers: (JAX's scales, the port's scales)}."""
    jcfg, pcfg, jp, js, pp, ps, wave, imgs = tiny
    mods = (PB, PW, PH, PS, PAd)
    before = [m.linear for m in mods]
    out = {}
    for towers in (TOWERS, ALL):
        j = JQ.calibrate_ave(jp, js, jcfg, jnp.asarray(wave), jnp.asarray(imgs), towers=towers,
                             min_dim=MIN_DIM)
        p = PQ.calibrate_ave(pp, ps, pcfg, wave, imgs, towers=towers, min_dim=MIN_DIM,
                             device="cpu")
        out[towers] = (j, p)
    assert [m.linear for m in mods] == before  # nothing patched
    return out


@pytest.mark.parametrize("towers", [TOWERS, ALL])
def test_calibrate_ave_matches_jax(calibrated, towers):
    j, p = calibrated[towers]
    assert sorted(p) == sorted(j) and len(p) > 10
    for q in j:
        np.testing.assert_allclose(p[q], j[q], rtol=1e-4, err_msg=f"qid {q}")
    if towers == ALL:  # the towers' qids stay a prefix
        t = calibrated[TOWERS][1]
        assert all(p[q] == t[q] for q in t)


@pytest.fixture(scope="module")
def jax_float(tiny):
    """JAX's float forward of the tiny model."""
    jcfg, _, jp, js, _, _, wave, imgs = tiny
    return _jax_forward(jcfg, jp, js, wave, imgs)


_jax_linear_int8 = jax.jit(JQ.linear_int8)  # one compile a shape, not one an op


class JaxLinearCheck(PQ.Recorder):
    """Each tagged linear's input through the port's `linear_int8` and JAX's
    on the leaves of the same qid: (qid, error / tolerance) of every call."""

    def __init__(self, pnodes, jnodes):
        super().__init__()
        self.pnodes, self.jnodes = pnodes, jnodes

    def record(self, qid, x):
        ref = np.asarray(_jax_linear_int8(self.jnodes[qid], jnp.asarray(x.numpy())))
        got = PQ.linear_int8(self.pnodes[qid], x, kernels=False).numpy()
        tol = 1e-6 * (np.abs(ref) + np.abs(ref).max())
        self.calls.append((qid, float((np.abs(got - ref) / tol).max())))


def _jax_nodes(tree, min_dim):
    nodes = {}

    def visit(node, qid):
        nodes[qid] = node
        return node

    JQ._walk_eligible(tree, visit, min_dim=min_dim)
    return nodes


@pytest.mark.parametrize("scales", ["static", "dynamic"])
@pytest.mark.parametrize("towers", [TOWERS, ALL], ids=["towers", "towers+adapters"])
def test_int8_forward_matches_jax(tiny, calibrated, jax_float, towers, scales):
    """Static scales: JAX's calibration on both sides (the port's own is held
    to it above), so the forward alone is compared. Every quantized linear
    of the port's forward gives JAX's output on its input; the outputs stay
    within half of the int8-against-float drift. Observed: port against
    JAX 7e-7 to 1.7e-2 of the spread, where a value crosses a rounding
    boundary, against a drift of 1.1e-2 to 7.9e-2."""
    jcfg, pcfg, jp, js, pp, ps, wave, imgs = tiny
    act_scales = calibrated[towers][0] if scales == "static" else None
    jq = JQ.quantize_eval_params(jp, towers=towers, min_dim=MIN_DIM, act_scales=act_scales)
    pq = PQ.quantize_eval_params(pp, towers=towers, min_dim=MIN_DIM, act_scales=act_scales)
    ref = _jax_forward(jcfg, jq, js, wave, imgs)
    got = _port_forward(pcfg, pq, ps, wave, imgs)
    for k in ("event_scores", "is_event_scores"):
        err, drift = _spread_err(got[k], ref[k]), _spread_err(ref[k], jax_float[k])
        assert err < DRIFT_SHARE * drift, (k, err, drift)
    ptow = PQ._ordered_towers(pq, towers)
    check = JaxLinearCheck(PQ.eligible_linears(ptow, min_dim=MIN_DIM),
                           _jax_nodes(JQ._ordered_towers(jq, towers), MIN_DIM))
    tagged = dict(pq)
    tagged.update(PQ.attach_qtags(ptow, recorder=check, min_dim=MIN_DIM))
    _port_forward(pcfg, tagged, ps, wave, imgs)
    assert sorted(q for q, _ in check.calls) == sorted(calibrated[towers][0])
    worst = max(check.calls, key=lambda c: c[1])
    assert worst[1] <= 1.0, worst


def test_window_attention_v2_int8_attn_matches_jax():
    rs = np.random.RandomState(3)
    dim, heads, ws, nW = 64, 4, 4, 3
    jp = to_numpy(JW.attention_v2_init(jax.random.PRNGKey(0), dim, heads))
    jp["logit_scale"] = (np.log(10.0) + 0.3 * rs.randn(heads, 1, 1)).astype(np.float32)
    jp["q_bias"] = (0.1 * rs.randn(dim)).astype(np.float32)
    jq = dict(jp, qkv=JQ.quantize_linear(jp["qkv"]), proj=JQ.quantize_linear(jp["proj"]))
    x = (0.5 * rs.randn(2 * nW, ws * ws, dim)).astype(np.float32)
    mask = np.where(rs.rand(nW, ws * ws, ws * ws) < 0.3, -100.0, 0.0).astype(np.float32)
    JW.set_int8_attn(True)
    try:
        ref = np.asarray(JW.window_attention_v2(jq, jnp.asarray(x), num_heads=heads, ws=ws,
                                                mask=jnp.asarray(mask), nW=nW))
    finally:
        JW.set_int8_attn(False)
    pq = to_torch(to_numpy(jq))
    got = PW.window_attention_v2(pq, torch.from_numpy(x), num_heads=heads, ws=ws,
                                 mask=torch.from_numpy(mask), nW=nW, int8_attn=True).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    fp_core = PW.window_attention_v2(pq, torch.from_numpy(x), num_heads=heads, ws=ws,
                                     mask=torch.from_numpy(mask), nW=nW).numpy()
    assert np.abs(fp_core - got).max() > 1e-4  # the int8 core ran


def test_fused_block_eligible_refuses_quantized():
    rs = np.random.RandomState(4)
    attn = {"qkv": {"kernel": torch.from_numpy(rs.randn(192, 576).astype(np.float32))},
            "proj": {"kernel": torch.from_numpy(rs.randn(192, 192).astype(np.float32))}}
    assert PW.fused_block_eligible(192, 6, False, True, attn)
    for key in ("qkv", "proj"):
        q = dict(attn, **{key: PQ.quantize_linear(attn[key])})
        assert not PW.fused_block_eligible(192, 6, False, True, q)


def test_int8_options_hold_per_call(tiny):
    """A quantized tree with int8_attn and the float tree without it, in
    alternation: each forward gives what it gives alone."""
    _, pcfg, _, _, pp, ps, wave, imgs = tiny
    pq = PQ.quantize_eval_params(pp, towers=ALL, min_dim=MIN_DIM)
    runs = {"int8": lambda: _port_forward(pcfg, pq, ps, wave, imgs, int8_attn=True),
            "float": lambda: _port_forward(pcfg, pp, ps, wave, imgs)}
    alone = {k: f() for k, f in runs.items()}
    int8_plain_attn = _port_forward(pcfg, pq, ps, wave, imgs)
    assert np.abs(int8_plain_attn["event_scores"] - alone["int8"]["event_scores"]).max() > 0
    for name in ("float", "int8", "float", "int8"):
        out = runs[name]()
        for k in out:
            np.testing.assert_array_equal(out[k], alone[name][k], err_msg=f"{name} {k}")


def test_engine_int8_tree():
    """The engine quantizes after the fold and the cast: its tree is the one
    `quantize_eval_params` makes from the folded, cast parameters. Widths
    are chosen so that some linears reach the engine's min_dim of 192 (the
    JAX engine has no min_dim), and the engine serves that tree."""
    base = port_cfg(tiny_cfg())
    cfg = dataclasses.replace(base, swin=dataclasses.replace(base.swin, embed_dim=48))
    params, state = PA.init_ave_model(cfg, seed=0, device="cpu")
    shapes = PQ.qid_shape_map(PQ._ordered_towers(params, ALL))
    assert len(shapes) == 35  # Swin stages 2-3, their merges and adapters at C >= 192
    scales = {q: 1.0 + 0.25 * q for q in shapes}
    eng = AVEInferenceEngine(cfg, params, state, batch_size=2, device="cpu",
                             compute_dtype=torch.bfloat16, int8_towers=True,
                             int8_adapters=True, act_scales=scales)
    fp, fs = fold_adapters_eval(params, state, cfg)
    cast = PA.cast_for_compute(fp, torch.bfloat16)
    want = PQ.quantize_eval_params(cast, towers=ALL, act_scales=scales)
    got_leaves, want_leaves = tree_paths(eng.params), tree_paths(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    n_q = 0
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and torch.equal(g, w), path
        n_q += path[-1] == "kernel_q"
        if path[-1] in ("kscale", "ascale"):
            assert g.dtype == torch.float32, path
    assert n_q == len(shapes)
    rs = np.random.RandomState(6)
    wave = (0.1 * rs.randn(2, cfg.num_frames, cfg.htsat.frontend.clip_samples)).astype(
        np.float32)
    frames = rs.randint(0, 256, (2, cfg.num_frames, 64, 64, 3), dtype=np.uint8)
    out = eng.predict(wave, frames)
    assert np.isfinite(out["event_scores"]).all() and out["segment_preds"].shape == (2, 2)


# ---------------------------------------------------------------------------
# chip_smoke.py's K4 cases and yardstick
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py as a module; it imports only torch and numpy at top level."""
    spec = importlib.util.spec_from_file_location("chip_smoke_module", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_int8_shapes_cover_one_forward():
    """The (rows, K, N) cases chip_smoke.py checks K4 at are one B=2 forward's
    430 calls, every K one the kernel takes."""
    shapes = _chip_smoke().int8_call_shapes(AVEModelConfig())
    assert sum(shapes.values()) == 430 and len(shapes) == 56
    assert {k for _, k, _ in shapes} == {192, 384, 576, 768, 1024, 1536, 2304, 3072, 4096, 6144}
    assert all(k % K4.K_STEP == 0 and n % 8 == 0 for _, k, n in shapes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_int8_yardstick_matches_plain(dtype):
    """The composition chip_smoke.py times beside K4 (quantize, torch._int_mm,
    dequantize) computes K4's function: equal to the plain version."""
    smoke = _chip_smoke()
    rs = np.random.RandomState(8)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rs.randn(40, 192).astype(np.float32)).to(dt)
    q = PQ.quantize_linear({"kernel": torch.from_numpy(rs.randn(192, 24).astype(np.float32))})
    ascale = x.float().abs().amax() * (0.9 / 127.0)
    bias = torch.from_numpy(rs.randn(24).astype(np.float32)).to(dt)
    args = (x, q["kernel_q"], q["kscale"], ascale, bias)
    assert torch.equal(smoke.composed_int8_linear(*args), K4.linear_int8_plain(*args))