"""K2: the attention half-block of an eval Swin block (CUDA kernels
`csrc/block_attention.cu`).

Replaces `dg_sct_tpu/ops/pallas/block_attention.py:113` `fused_attn_half_block`.
x is (B, H, W, C) in spatial layout, rolled by the caller for shifted windows:
  kind="v1" (HTS-AT):  x + proj(attn(LN1(x)))
  kind="v2" (Swin-V2): x + LN1(proj(cos-attn(x)))
qkv, q, k, v and the softmax stay float32; LN1(x) (v1) and the attention
output are rounded to x's type before their products.
"""
from __future__ import annotations

import math

import torch

from ..basic import layer_norm
from .build import (CudaKernel, I, P, check_aligned, check_cuda, check_shape, dtype_code,
                    ptr, refuse_grad, stream_of)

KERNEL = CudaKernel("block_attention", "k2_block_attention", [P] * 14 + [I] * 8 + [P])

KINDS = {"v1": 1, "v2": 2}
MAX_TOKENS = 144     # window tokens: nine 16-row query tiles
MAX_HEAD_DIM = 32    # four 8-column output tiles; a multiple of 8 (16-byte rows)


def fused_attn_half_block_plain(x, wqkv, bqkv, wproj, bproj, bias, ln_scale, ln_bias,
                                mask=None, logit_scale=None, *, kind, heads, ws):
    """The kernels' arithmetic in PyTorch, composed from window partition,
    attention and window reverse."""
    B, H, W, C = x.shape
    D, N = C // heads, ws * ws
    nWr, nWc = H // ws, W // ws
    f = lambda t: t.to(torch.float32)
    xf = f(x)
    h_in = layer_norm({"scale": f(ln_scale), "bias": f(ln_bias)}, xf) if kind == "v1" else xf
    qkv = f(h_in.to(x.dtype)) @ f(wqkv) + f(bqkv)                       # (B, H, W, 3C)
    qkv = qkv.reshape(B, nWr, ws, nWc, ws, 3, heads, D).permute(0, 1, 3, 2, 4, 5, 6, 7)
    qkv = qkv.reshape(B * nWr * nWc, N, 3, heads, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]                  # (Bw, N, h, D)
    if kind == "v2":
        q = q * torch.rsqrt(q.square().sum(-1, keepdim=True) + 1e-12)
        k = k * torch.rsqrt(k.square().sum(-1, keepdim=True) + 1e-12)
        q = q * torch.exp(torch.clamp(f(logit_scale), max=math.log(100.0)))[None, None, :, None]
    else:
        q = q * D ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) + f(bias)[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(-1, nW, heads, N, N) + f(mask)[None, :, None]).reshape(-1, heads, N, N)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhnm,bmhd->bnhd", e / e.sum(-1, keepdim=True), v)
    o = o.reshape(B, nWr, nWc, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    proj = f(o.to(x.dtype)) @ f(wproj) + f(bproj)
    if kind == "v2":
        proj = layer_norm({"scale": f(ln_scale), "bias": f(ln_bias)}, proj)
    return (xf + proj).to(x.dtype)


def fused_attn_half_block(x, wqkv, bqkv, wproj, bproj, bias, ln_scale, ln_bias,
                          mask=None, logit_scale=None, *, kind, heads, ws):
    """K2 on a CUDA tensor; the plain version on a CPU tensor. x: (B, H, W, C);
    wqkv (C, 3C); bqkv (3C,); wproj (C, C); bproj, ln_scale, ln_bias (C,);
    bias (heads, N, N); mask (nW, N, N) or None; logit_scale (heads,) for v2.
    Under grad mode an operand that requires grad raises (`build.refuse_grad`)."""
    refuse_grad("fused_attn_half_block", x, wqkv, bqkv, wproj, bproj, bias, ln_scale, ln_bias,
                mask, logit_scale)
    if x.device.type == "cpu":
        return fused_attn_half_block_plain(x, wqkv, bqkv, wproj, bproj, bias, ln_scale,
                                           ln_bias, mask, logit_scale, kind=kind,
                                           heads=heads, ws=ws)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_half_block: no kernel for device {x.device}")
    B, H, W, C = x.shape
    N = ws * ws
    if kind not in KINDS:
        raise ValueError(f"fused_attn_half_block: kind {kind!r} not in {tuple(KINDS)}")
    if H % ws or W % ws or C % heads:
        raise ValueError(f"fused_attn_half_block: {H}x{W}x{C} does not tile into "
                         f"{ws}x{ws} windows of {heads} heads")
    if N > MAX_TOKENS or C // heads > MAX_HEAD_DIM or (C // heads) % 8:
        raise ValueError(f"fused_attn_half_block: window of {N} tokens, head dim "
                         f"{C // heads}: the kernel takes <= {MAX_TOKENS} and a multiple "
                         f"of 8 <= {MAX_HEAD_DIM}")
    if kind == "v2" and logit_scale is None:
        raise ValueError("fused_attn_half_block: v2 needs logit_scale")
    name = "fused_attn_half_block"
    check_cuda(name, x, x=x, wqkv=wqkv, bqkv=bqkv, wproj=wproj, bproj=bproj, bias=bias,
               ln_scale=ln_scale, ln_bias=ln_bias, mask=mask, logit_scale=logit_scale)
    for key, t, shape in (("wqkv", wqkv, (C, 3 * C)), ("bqkv", bqkv, (3 * C,)),
                          ("wproj", wproj, (C, C)), ("bproj", bproj, (C,)),
                          ("bias", bias, (heads, N, N)), ("ln_scale", ln_scale, (C,)),
                          ("ln_bias", ln_bias, (C,)),
                          ("mask", mask, ((H // ws) * (W // ws), N, N)),
                          ("logit_scale", logit_scale, (heads,))):
        check_shape(name, key, t, shape)
    check_aligned(name, x=x, wqkv=wqkv, wproj=wproj, bias=bias, mask=mask)
    # scratch: q, k, v per (window, head) in float32; the attention output
    # (v1: LN1(x) first) in x's type; v2's float32 proj output for LN1
    qkv = torch.empty(3 * x.numel(), device=x.device, dtype=torch.float32)
    attn = torch.empty_like(x)
    y = torch.empty(x.shape, device=x.device, dtype=torch.float32) if kind == "v2" else None
    out = torch.empty_like(x)
    KERNEL.launch(ptr(x), ptr(wqkv), ptr(bqkv), ptr(wproj), ptr(bproj), ptr(bias),
                  ptr(ln_scale), ptr(ln_bias), ptr(mask),
                  ptr(logit_scale if kind == "v2" else None), ptr(qkv), ptr(attn), ptr(y),
                  ptr(out), B, H, W, C, heads, ws, KINDS[kind], dtype_code(x), stream_of(x))
    return out
