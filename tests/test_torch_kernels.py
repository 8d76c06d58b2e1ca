"""The plain versions of the port's three CUDA kernels against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs in
float32 (JAX matmul precision "highest"). The wrappers take these plain
versions for CPU tensors; CUDA tensors launch the kernels (chip_smoke.py
holds each kernel against its plain version on the card). Tolerance: atol
1e-4, rtol 1e-3."""
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.ops import windows as JW
from dg_sct_tpu.ops.basic import grouped_linear_init
from dg_sct_tpu.ops.pallas import adapter_bottleneck as JK3
from dg_sct_tpu.ops.pallas import block_attention as JK2
from dg_sct_tpu.ops.pallas import window_attention as JK1
from dg_sct_tpu_torch.ops import windows as PW
from dg_sct_tpu_torch.ops.kernels import adapter_bottleneck as PK3
from dg_sct_tpu_torch.ops.kernels import block_attention as PK2
from dg_sct_tpu_torch.ops.kernels import window_attention as PK1
from torch_port_helpers import to_numpy, to_torch

ATOL, RTOL = 1e-4, 1e-3


def close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# K1: window-attention core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nW,N,H,D,masked", [(4, 16, 2, 8, False), (4, 16, 2, 8, True),
                                             (4, 64, 4, 24, True), (1, 36, 3, 32, False),
                                             (3, 144, 2, 32, True)])   # Swin's 12x12 windows
def test_k1_plain_matches_pallas(nW, N, H, D, masked):
    rs = np.random.RandomState(0)
    Bw = 2 * nW
    q, k, v = (rs.randn(Bw, N, H, D).astype(np.float32) * s for s in (0.3, 0.3, 1.0))
    bias = rs.randn(H, N, N).astype(np.float32) * 0.3
    mask = np.where(rs.rand(nW, N, N) > 0.7, -100.0, 0.0).astype(np.float32) if masked else None
    ref = JK1.fused_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), nW=nW, interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    close(PK1.window_attention_plain(t(q), t(k), t(v), t(bias), t(mask), nW=nW), ref)
    # the wrapper on CPU tensors takes the same plain version
    close(PK1.window_attention(t(q), t(k), t(v), t(bias), t(mask), nW=nW), ref)


@pytest.mark.parametrize("case", ["ok", "device", "dtype", "strided", "shape"])
def test_operand_checks(case):
    """The checks every wrapper runs before a launch: same device, dtype and
    contiguity as the reference operand, and the expected shape."""
    from dg_sct_tpu_torch.ops.kernels.build import check_cuda, check_shape

    ref = torch.zeros((4, 8))
    t = {"ok": torch.ones((4, 8)), "device": torch.zeros((4, 8), device="meta"),
         "dtype": torch.zeros((4, 8), dtype=torch.float64), "strided": torch.zeros((8, 4)).t(),
         "shape": torch.zeros((4, 7))}[case]
    want = {"device": "is on", "dtype": "float64", "strided": "not contiguous", "shape": "shape"}
    if case == "ok":
        check_cuda("k", ref, a=ref, b=t, c=None)
        check_shape("k", "b", t, (4, 8))
        check_shape("k", "b", t, ref.shape)
        return
    with pytest.raises(ValueError, match=want[case]):
        check_cuda("k", ref, a=ref, b=t)
        check_shape("k", "b", t, (4, 8))


def test_wrappers_raise_without_a_kernel_for_the_device():
    q = torch.zeros((2, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        PK1.window_attention(q, q, q, torch.zeros((1, 4, 4), device="meta"))
    x = torch.zeros((3, 8), device="meta")
    w = torch.zeros((2, 4, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        PK3.bottleneck_rows(x, w, None, None, None, None, None, None, None, has_ln1=False)


# ---------------------------------------------------------------------------
# K2: attention half-block
# ---------------------------------------------------------------------------

def _k2_params(kind, C, heads, ws, seed):
    rs = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    if kind == "v1":
        attn = JW.attention_v1_init(key, C, ws, heads)
    else:
        attn = JW.attention_v2_init(key, C, heads)
        attn["q_bias"] = jnp.asarray(0.1 * rs.randn(C).astype(np.float32))
        attn["v_bias"] = jnp.asarray(0.1 * rs.randn(C).astype(np.float32))
        attn["logit_scale"] = jnp.asarray(
            (math.log(10.0) + 0.5 * rs.randn(heads, 1, 1)).astype(np.float32))
    params = {"attn": attn,
              "norm1": {"scale": jnp.asarray(1.0 + 0.1 * rs.randn(C).astype(np.float32)),
                        "bias": jnp.asarray(0.1 * rs.randn(C).astype(np.float32))}}
    return to_numpy(params)


@pytest.mark.parametrize("kind,shift,B,H,W,C,heads,ws", [
    ("v1", 0, 2, 8, 8, 32, 4, 4), ("v1", 2, 2, 8, 8, 32, 4, 4),
    ("v2", 0, 2, 8, 8, 32, 4, 4), ("v2", 2, 2, 8, 8, 32, 4, 4),
    ("v2", 2, 1, 12, 8, 16, 2, 4),      # rectangular, several row strips, shifted
    ("v1", 4, 1, 16, 16, 48, 2, 8),     # HTS-AT-like head dim 24, 64-token windows
    # the geometries the CUDA kernels pad: 144-token windows (nine 16-row tiles)
    # on Swin's 24x24 grid shifted by 6, and head dim 24 over two row strips
    ("v2", 6, 1, 24, 24, 64, 2, 12),
    ("v1", 4, 2, 16, 24, 48, 2, 8),
])
def test_k2_plain_matches_pallas(kind, shift, B, H, W, C, heads, ws):
    params = _k2_params(kind, C, heads, ws, seed=C + shift)
    x = np.random.RandomState(1).randn(B, H * W, C).astype(np.float32)
    ref = JW.fused_half_block(params, jnp.asarray(x), kind=kind, heads=heads, res=(H, W),
                              ws=ws, shift=shift, interpret=True)
    got = PW.fused_half_block(to_torch(params), torch.from_numpy(x), kind=kind, heads=heads,
                              res=(H, W), ws=ws, shift=shift)
    close(got, ref)


def test_k2_plain_direct_call_matches_pallas():
    """The kernel-level signature: rolled x, dense operands, v2 with mask."""
    rs = np.random.RandomState(2)
    B, H, W, C, heads, ws, N = 1, 8, 8, 16, 2, 4, 16
    a = lambda *s, sc=1.0: (sc * rs.randn(*s)).astype(np.float32)
    args = [a(B, H, W, C), a(C, 3 * C, sc=0.2), a(3 * C, sc=0.1), a(C, C, sc=0.2),
            a(C, sc=0.1), 16.0 / (1.0 + np.exp(-a(heads, N, N))), 1.0 + a(C, sc=0.1),
            a(C, sc=0.1)]
    mask = JW.shift_attn_mask(H, W, ws, 2)
    ls = (math.log(10.0) + a(heads, sc=0.3)).astype(np.float32)
    ref = JK2.fused_attn_half_block(*map(jnp.asarray, args), mask=jnp.asarray(mask),
                                    logit_scale=jnp.asarray(ls), kind="v2", heads=heads,
                                    ws=ws, interpret=True)
    got = PK2.fused_attn_half_block(*map(torch.from_numpy, args), mask=torch.from_numpy(mask),
                                    logit_scale=torch.from_numpy(ls), kind="v2", heads=heads,
                                    ws=ws)
    close(got, ref)


# ---------------------------------------------------------------------------
# K3: adapter bottleneck
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,g,has_ln1,bias,rows", [
    (96, 2, True, True, 300),      # HTS-AT stage-0 geometry; 300 rows: not a tile multiple
    (192, 2, False, True, 77),
    (192, 4, True, False, 100),
    (64, 4, False, False, 33),
    (96, 4, True, True, 40),    # C/g = 24: the four groups of the AVS and AVQA adapters
    # the widths whose weights the bf16 kernel streams in several slabs
    (768, 2, True, True, 40),
    (1536, 2, True, True, 20),
])
def test_k3_plain_matches_pallas(C, g, has_ln1, bias, rows):
    key = jax.random.PRNGKey(C + g)
    ks = jax.random.split(key, 6)
    D = C // 8
    p = {"down": grouped_linear_init(ks[0], C, D, g, bias=bias),
         "up": grouped_linear_init(ks[1], D, C, g, bias=bias),
         "ln_post": {"scale": 1.0 + 0.1 * jax.random.normal(ks[2], (C,)),
                     "bias": 0.1 * jax.random.normal(ks[3], (C,))}}
    if has_ln1:
        p["ln_before"] = {"scale": 1.0 + 0.1 * jax.random.normal(ks[4], (C,)),
                          "bias": 0.1 * jax.random.normal(ks[5], (C,))}
    p = to_numpy(p)
    x = np.random.RandomState(3).randn(1, rows, C).astype(np.float32)
    ref = JK3.fused_bottleneck(p, jnp.asarray(x), has_ln1=has_ln1, interpret=True)
    got = PK3.fused_bottleneck(to_torch(p), torch.from_numpy(x), has_ln1=has_ln1)
    close(got, ref)


def test_k2_eligibility_follows_the_jax_rule():
    attn = {"qkv": {"kernel": None}, "proj": {"kernel": None}}  # an unquantized block
    for C, heads in ((96, 4), (768, 24), (1536, 48), (100, 3)):
        JW.set_fused_block(True)
        try:
            want = JW.fused_block_eligible(C, heads, False)
        finally:
            JW.set_fused_block(False)
        assert PW.fused_block_eligible(C, heads, False, True, attn) == want
        assert not PW.fused_block_eligible(C, heads, False, False, attn)
        assert not PW.fused_block_eligible(C, heads, True, True, attn)


# ---------------------------------------------------------------------------
# chip_smoke.py: profile groups and the library yardsticks
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py as a module; it imports only torch and numpy at top level."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_module", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_every_csrc_kernel_falls_in_its_profile_group():
    """chip_smoke.py sums the profiled device time by kernel group; every
    __global__ kernel of csrc/ must land in its source's group (K1, K2, K3,
    K4), never in "other"."""
    root = Path(__file__).resolve().parents[1]
    smoke = _chip_smoke()
    want = {"window_attention": "K1", "block_attention": "K2", "adapter_bottleneck": "K3",
            "int8_linear": "K4"}
    kernel = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
                        r"(\w+)\s*\(")
    csrc = root / "dg_sct_tpu_torch" / "csrc"
    found = {f.name: kernel.findall(f.read_text())
             for f in sorted(csrc.iterdir()) if f.suffix in (".cu", ".cuh")}
    assert {n for n, ks in found.items() if ks} == {f"{s}.cu" for s in want}, found
    for fname, names in found.items():
        for name in names:
            profiled = f"void dgsct::(anonymous namespace)::{name}<__nv_bfloat16>(float const*)"
            assert smoke.kernel_group(profiled) == want[Path(fname).stem], (fname, name)


@pytest.mark.parametrize("case", ["k3-96-2-f32", "k3-96-2-bf16", "k3-192-4-f32", "k3-192-4-bf16",
                                  "k2-v1", "k2-v2"])
def test_chip_smoke_yardsticks_match_plain(case):
    """The library compositions chip_smoke.py times beside K3 and K2
    (composed_bottleneck, composed_half_block) compute the kernels' function:
    held against the plain versions on CPU tensors. K3 in float32 at atol /
    rtol 1e-5, in bfloat16 at 2e-2 (the composition also rounds o to bf16
    before LN_post); K2 in float32 at 1e-5."""
    smoke = _chip_smoke()
    rs = np.random.RandomState(7)
    t = lambda *s, sc=1.0: torch.from_numpy((sc * rs.randn(*s)).astype(np.float32))
    if case.startswith("k3"):
        _, C, g, dt = case.split("-")
        C, g = int(C), int(g)
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
        gi, go = C // g, C // 16
        args = [t(37, C), t(g, gi, go, sc=gi ** -0.5), t(g * go, sc=0.1), t(g, go, gi, sc=go ** -0.5),
                t(C, sc=0.1), 1.0 + t(C, sc=0.1), t(C, sc=0.1), 1.0 + t(C, sc=0.1), t(C, sc=0.1)]
        args = [a.to(dtype) for a in args]
        has_ln1 = g == 2
        got = smoke.composed_bottleneck(*args, has_ln1=has_ln1)
        ref = PK3.bottleneck_rows_plain(*args, has_ln1=has_ln1)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), atol=tol, rtol=tol)
        return
    kind = case.split("-")[1]
    B, H, W, C, heads, ws, shift = 1, 8, 8, 32, 2, 4, 2
    N = ws * ws
    x = t(B, H, W, C)
    wqkv, bqkv, wproj, bproj = t(C, 3 * C, sc=C ** -0.5), t(3 * C, sc=0.1), t(C, C, sc=C ** -0.5), t(C, sc=0.1)
    ln_s, ln_b = 1.0 + t(C, sc=0.1), t(C, sc=0.1)
    if kind == "v2":
        bias, logit_scale = 16.0 * torch.sigmoid(t(heads, N, N)), math.log(10.0) + t(heads, sc=0.3)
    else:
        bias, logit_scale = t(heads, N, N, sc=0.02), None
    mask = torch.from_numpy(JW.shift_attn_mask(H, W, ws, shift))
    full = smoke.window_bias(bias, mask, B * H * W // N)
    got = smoke.composed_half_block(x, wqkv, bqkv, wproj, bproj, full, ln_s, ln_b, logit_scale,
                                    kind=kind, heads=heads, ws=ws)
    ref = PK2.fused_attn_half_block_plain(x, wqkv, bqkv, wproj, bproj, bias, ln_s, ln_b, mask,
                                          logit_scale, kind=kind, heads=heads, ws=ws)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
