"""K4's two plain versions (dg_sct_tpu_torch/ops/kernels/int8_linear.py:
`quantize_rows_plain`, the quantize kernel's arithmetic, and
`int8_gemm_plain`, the int8 GEMM kernel's) against the JAX package's
activation quantize in `dg_sct_tpu/ops/quant.py:linear_int8` (static and
dynamic scales, float32 and bfloat16 inputs), and `linear_int8_plain`
against their composition. Every comparison is bit for bit: the quantize is
the same IEEE division, half-to-even rounding and clip in both packages.

The inputs put values on and around the half-integers of x / ascale (the
rounding ties, and their float32 neighbours), values that clip at +-127, a
zero row (the dynamic scale's 1e-8 floor) and seeded random rows.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.ops import quant as JQ
from dg_sct_tpu_torch.ops.kernels import int8_linear as K4

SCALE = np.float32(2.0 ** -4)  # static; also a dynamic row's whose absmax is 127 * SCALE
K = 256


def _inputs(dtype):
    """(rows, K) float32 numpy values, representable in `dtype`: ties of
    x / SCALE, their neighbours, clipping values, a zero row, random rows."""
    ties = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)) * SCALE  # 254 ties
    rows = []
    up, down = np.nextafter(ties, np.float32(np.inf)), np.nextafter(ties, -np.float32(np.inf))
    for r in (ties, up, down):
        row = np.zeros(K, np.float32)
        row[:254] = r
        row[254] = 127 * SCALE   # the row's absmax: its dynamic scale is SCALE
        row[255] = -127 * SCALE
        rows.append(row)
    clip = np.linspace(-300.0, 300.0, K).astype(np.float32) * SCALE  # |x / s| up to 300
    rs = np.random.RandomState(0)
    rows += [clip, np.zeros(K, np.float32)] + list((rs.randn(4, K) * 3.0).astype(np.float32))
    x = np.stack(rows)
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _jax_quantize(x, ascale):
    """The activation quantize of `JQ.linear_int8` (dg_sct_tpu/ops/quant.py:71-75)
    as it stands there -> (xq int8, ascale)."""
    xf = x.astype(jnp.float32)
    if ascale is None:
        ascale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    return jnp.clip(jnp.round(xf / ascale), -127.0, 127.0).astype(jnp.int8), ascale


def _operands(mode, dtype):
    x = _inputs(dtype)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    ascale = None if mode == "dynamic" else SCALE
    return jx, px, ascale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_quantize_rows_plain_matches_jax(mode, dtype):
    """int8 rows equal JAX's, each row's s equals JAX's scale and 1/s is its
    correctly rounded reciprocal."""
    jx, px, ascale = _operands(mode, dtype)
    jq, js = _jax_quantize(jx, None if ascale is None else jnp.float32(ascale))
    xq, rs = K4.quantize_rows_plain(px, None if ascale is None else torch.tensor(ascale))
    assert xq.dtype == torch.int8 and rs.dtype == torch.float32 and rs.shape == (len(px), 2)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    s = np.broadcast_to(np.asarray(js, np.float32).reshape(-1, 1), (len(px), 1))[:, 0]
    np.testing.assert_array_equal(rs[:, 0].numpy(), s)
    np.testing.assert_array_equal(rs[:, 1].numpy(), np.float32(1.0) / s)
    q = xq.numpy().astype(np.int32)
    assert (np.abs(q) <= 127).all() and (np.abs(q) == 127).any()
    if mode == "dynamic":  # the zero row: scale 1e-8 / 127, all zeros
        assert rs[4, 0].item() == np.float32(np.float32(1e-8) / np.float32(127.0))
        assert not q[4].any()
        assert rs[0, 0].item() == SCALE  # the tie rows' absmax gives them the static scale
    assert (q[0, :254] % 2 == 0).all()  # ties round half to even


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_quantize_then_gemm_matches_jax_linear(mode, dtype):
    """JAX's own `linear_int8` through an identity weight with unit column
    scales returns float(xq) * ascale in x's type; the two plain pieces
    composed give the same bits."""
    jx, px, ascale = _operands(mode, dtype)
    jp = {"kernel_q": jnp.eye(K, dtype=jnp.int8), "kscale": jnp.ones(K, jnp.float32)}
    if ascale is not None:
        jp["ascale"] = jnp.float32(ascale)
    ref = np.asarray(JQ.linear_int8(jp, jx).astype(jnp.float32))
    got = K4.int8_gemm_plain(*K4.quantize_rows_plain(px, None if ascale is None
                                                     else torch.tensor(ascale)),
                             torch.eye(K, dtype=torch.int8), torch.ones(K), None, px.dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_linear_int8_plain_is_the_composition(mode, dtype, bias):
    """`linear_int8_plain` equals `int8_gemm_plain` after `quantize_rows_plain`
    bit for bit, and the CPU wrappers return the plain versions."""
    _, px, ascale = _operands(mode, dtype)
    g = torch.Generator().manual_seed(2)
    wq = torch.randint(-127, 128, (96, K), generator=g, dtype=torch.int8).t()  # (K, N) view
    kscale = torch.rand(96, generator=g) * 0.01
    b = (torch.randn(96, generator=g) * 0.1).to(px.dtype) if bias else None
    a = None if ascale is None else torch.tensor(ascale)
    ref = K4.linear_int8_plain(px, wq, kscale, a, b)
    parts = K4.quantize_rows_plain(px, a)
    got = K4.int8_gemm_plain(*parts, wq, kscale, b, px.dtype)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert torch.equal(K4.int8_linear(px, wq, kscale, a, b), ref)
    for w, p in zip(K4.quantize_rows(px, a), parts):
        assert torch.equal(w, p)
    assert torch.equal(K4.int8_gemm(*parts, wq, kscale, b, px.dtype), ref)


def test_quantize_wrappers_never_fall_back():
    """On a device other than the CPU the wrappers launch their kernel or
    raise; on "meta" (no kernel) they raise."""
    x = torch.empty(64, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K4.quantize_rows(x)
    with pytest.raises(ValueError, match="no kernel"):
        K4.int8_gemm(torch.empty(64, 128, dtype=torch.int8, device="meta"),
                     torch.empty(64, 2, device="meta"),
                     torch.empty(128, 64, dtype=torch.int8, device="meta"),
                     torch.empty(64, device="meta"))
