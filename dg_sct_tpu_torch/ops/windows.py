"""Windowed attention shared by both towers.

V1 window attention with a relative-position bias table (HTS-AT) and V2
scaled-cosine attention with the log-CPB bias (Swin-V2, timm 0.6.12), the
shifted-window step around them, and the eval attention half-block. With
`kernels=True` the attention core runs as K1, an eligible half-block as K2
and a quantized linear as K4 (`ops/kernels/`); with `kernels=False`
everything is plain PyTorch. `int8_attn` runs the V2 core of a quantized
Swin-V2 block in int8 (`_attn_core_int8`).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import constant
from ..parallel.tp import project, split_heads
from .basic import Init, linear, linear_init
from .kernels.block_attention import fused_attn_half_block
from .kernels.window_attention import window_attention, window_attention_plain


def window_partition(x, ws):
    """(B, H, W, C) -> (B * nW, ws*ws, C), row-major over the window grid."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(wins, ws, H, W):
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    nW = (H // ws) * (W // ws)
    B = wins.shape[0] // nW
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


@functools.lru_cache(maxsize=None)
def relative_position_index(ws_h: int, ws_w: int) -> np.ndarray:
    """(ws_h*ws_w, ws_h*ws_w) index into the (2h-1)(2w-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws_h), np.arange(ws_w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws_h - 1
    rel[:, :, 1] += ws_w - 1
    rel[:, :, 0] *= 2 * ws_w - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) additive mask (0 / -100) of shifted windows."""
    img = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def log_cpb_coords_table(ws_h: int, ws_w: int, pretrained_ws: int = 0) -> np.ndarray:
    """((2h-1)*(2w-1), 2) log-spaced relative coordinates of the Swin-V2 CPB MLP."""
    rh = np.arange(-(ws_h - 1), ws_h, dtype=np.float32)
    rw = np.arange(-(ws_w - 1), ws_w, dtype=np.float32)
    table = np.stack(np.meshgrid(rh, rw, indexing="ij"), axis=-1)
    table[:, :, 0] /= (pretrained_ws - 1) if pretrained_ws > 0 else (ws_h - 1)
    table[:, :, 1] /= (pretrained_ws - 1) if pretrained_ws > 0 else (ws_w - 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


# ---------------------------------------------------------------------------
# attention core: K1 or its plain version
# ---------------------------------------------------------------------------

def _attn_core(q, k, v, bias, mask, out_dtype, nW=1, *, kernels=True):
    """q/k/v: (Bw, N, H, D) with q pre-scaled; bias (H, N, N); mask
    (nW, N, N) or None. Returns (Bw, N, H*D)."""
    Bw, N, H, D = q.shape
    bias = bias.to(q.dtype)
    mask = None if mask is None else mask.to(q.dtype)
    if kernels:
        out = window_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               bias.contiguous(), mask, nW=nW)
    else:
        out = window_attention_plain(q, k, v, bias, mask, nW=nW)
    return out.reshape(Bw, N, H * D).to(out_dtype)


def _int8_matmul(a, b):
    """a @ b of integer-valued float32 tensors with int8-range entries. Exact:
    every partial sum is an integer below 2^24 (asserted from the depth)."""
    depth = a.shape[-1]
    assert depth * 127 * 127 < 2 ** 24, f"an int8 product of depth {depth} is not exact in float32"
    return a @ b


def _attn_core_int8(qn, kn, v, logit_scale, bias, mask, out_dtype):
    """The int8 cosine-attention core of a quantized Swin-V2 block
    (`dg_sct_tpu/ops/windows.py:133` `_attn_core_int8`), in plain PyTorch.
    qn/kn (Bw, N, H, D) are L2-normalized, so 1/127 is their exact static
    scale; the softmax output in [0, 1] takes 1/127 too; v takes a dynamic
    scale per (window, head, channel). logit_scale (H,) is applied at the
    dequantize. The two int8 products run as float32 matmuls of integers
    (`_int8_matmul`). Returns (Bw, N, H*D) in `out_dtype`."""
    Bw, N, H, D = qn.shape
    f = lambda t: t.to(torch.float32)
    qq = torch.clamp(torch.round(f(qn) * 127.0), -127, 127).permute(0, 2, 1, 3)  # (Bw, H, N, D)
    kq = torch.clamp(torch.round(f(kn) * 127.0), -127, 127).permute(0, 2, 3, 1)  # (Bw, H, D, N)
    scale = (f(logit_scale) / (127.0 * 127.0)).reshape(1, H, 1, 1)
    attn = _int8_matmul(qq, kq) * scale + f(bias)[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.reshape(Bw // nW, nW, H, N, N) + f(mask)[None, :, None]).reshape(Bw, H, N, N)
    pq = torch.clamp(torch.round(torch.softmax(attn, dim=-1) * 127.0), 0, 127)
    vf = f(v)
    vscale = torch.clamp(vf.abs().amax(1, keepdim=True), min=1e-8) / 127.0   # (Bw, 1, H, D)
    vq = torch.clamp(torch.round(vf / vscale), -127, 127).permute(0, 2, 1, 3)  # (Bw, H, N, D)
    out = _int8_matmul(pq, vq) * (vscale.permute(0, 2, 1, 3) / 127.0)
    return out.permute(0, 2, 1, 3).reshape(Bw, N, H * D).to(out_dtype)


# ---------------------------------------------------------------------------
# V1 (HTS-AT): scaled dot product + learned relative-position bias table
# ---------------------------------------------------------------------------

def attention_v1_init(init: Init, dim, ws, num_heads, qkv_bias=True):
    return {"qkv": linear_init(init, dim, dim * 3, bias=qkv_bias),
            "proj": linear_init(init, dim, dim),
            "rpb_table": init.trunc_normal(((2 * ws - 1) * (2 * ws - 1), num_heads))}


def _v1_bias(params, ws, heads):
    N = ws * ws
    idx = constant(relative_position_index, ws, ws, device=params["rpb_table"].device).reshape(-1)
    return params["rpb_table"][idx].reshape(N, N, heads).permute(2, 0, 1)


def window_attention_v1(params, x, *, num_heads, ws, mask=None, nW=1, kernels=True, tp=None):
    """x: (Bw, N, C) windows -> (Bw, N, C). With `tp` and a split qkv, on
    this rank's heads (`parallel.tp`)."""
    Bw, N, C = x.shape
    hd = C // num_heads
    params, num_heads = split_heads(tp, params, num_heads, C)
    qkv = linear(params["qkv"], x, kernels=kernels).reshape(Bw, N, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = q * hd ** -0.5
    out = _attn_core(q, k, v, _v1_bias(params, ws, num_heads), mask, x.dtype, nW,
                     kernels=kernels)
    return project(tp, params["proj"], out, kernels=kernels)


# ---------------------------------------------------------------------------
# V2 (Swin-V2): scaled cosine + log-CPB MLP bias
# ---------------------------------------------------------------------------

def attention_v2_init(init: Init, dim, num_heads):
    return {"qkv": {"kernel": init.kaiming_uniform((dim, dim * 3), dim)},
            "q_bias": init.zeros((dim,)),
            "v_bias": init.zeros((dim,)),
            "logit_scale": torch.log(init.full((num_heads, 1, 1), 10.0)),
            "cpb_fc1": linear_init(init, 2, 512),
            "cpb_fc2": {"kernel": init.kaiming_uniform((512, num_heads), 512)},
            "proj": linear_init(init, dim, dim)}


def _v2_bias(params, ws, heads, pretrained_ws):
    """16 sigmoid(CPB MLP(log coords)) gathered to (heads, N, N), float32 (float64
    for float64 weights: a float32 MLP would round a float64 step's gradient
    of its weights to float32's precision)."""
    N = ws * ws
    w = params["cpb_fc2"]["kernel"]
    dt = torch.promote_types(w.dtype, torch.float32)
    f = lambda p: {k: v.to(dt) for k, v in p.items()}
    table = constant(log_cpb_coords_table, ws, ws, pretrained_ws, device=w.device).to(dt)
    cpb = linear(f(params["cpb_fc2"]), torch.relu(linear(f(params["cpb_fc1"]), table)))
    idx = constant(relative_position_index, ws, ws, device=w.device).reshape(-1)
    return 16.0 * torch.sigmoid(cpb[idx].reshape(N, N, heads).permute(2, 0, 1))


def _v2_qkv_bias(params):
    return torch.cat([params["q_bias"], torch.zeros_like(params["v_bias"]), params["v_bias"]])


def window_attention_v2(params, x, *, num_heads, ws, mask=None, pretrained_ws=0, nW=1,
                        kernels=True, int8_attn=False, tp=None):
    """Scaled-cosine window attention with the log-CPB bias. x: (Bw, N, C).
    With `int8_attn` and a quantized qkv, the core runs in int8. With `tp`
    and a split qkv, on this rank's heads (`parallel.tp`)."""
    Bw, N, C = x.shape
    hd = C // num_heads
    params, num_heads = split_heads(tp, params, num_heads, C)
    qkv = linear(params["qkv"], x, kernels=kernels) + _v2_qkv_bias(params)
    qkv = qkv.reshape(Bw, N, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    qn = q * torch.rsqrt(q.square().sum(-1, keepdim=True) + 1e-12)
    kn = k * torch.rsqrt(k.square().sum(-1, keepdim=True) + 1e-12)
    logit_scale = torch.exp(torch.clamp(params["logit_scale"], max=math.log(1.0 / 0.01)))
    bias = _v2_bias(params, ws, num_heads, pretrained_ws).to(x.dtype)
    if int8_attn and "kernel_q" in params["qkv"]:
        out = _attn_core_int8(qn, kn, v, logit_scale[:, 0, 0], bias, mask, x.dtype)
    else:
        qn = qn * logit_scale[:, 0, 0][None, None, :, None].to(qn.dtype)
        out = _attn_core(qn, kn, v, bias, mask, x.dtype, nW, kernels=kernels)
    return project(tp, params["proj"], out, kernels=kernels)


def shifted_window_attention(attn_fn, x, *, H, W, ws, shift):
    """roll -> partition -> attn_fn(windows, mask, nW) -> reverse -> unroll.
    x: (B, H*W, C)."""
    B, L, C = x.shape
    xs = x.reshape(B, H, W, C)
    mask = None
    if shift > 0:
        xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
        mask = constant(shift_attn_mask, H, W, ws, shift, device=x.device)
    wins = attn_fn(window_partition(xs, ws), mask, (H // ws) * (W // ws))
    xs = window_reverse(wins, ws, H, W)
    if shift > 0:
        xs = torch.roll(xs, (shift, shift), dims=(1, 2))
    return xs.reshape(B, L, C)


# ---------------------------------------------------------------------------
# eval attention half-block: K2 or its plain version
# ---------------------------------------------------------------------------

def fused_block_eligible(C: int, heads: int, train: bool, kernels: bool, attn, tp=None) -> bool:
    """K2 takes the eval blocks with C <= 768, the rule of the JAX package
    (`dg_sct_tpu/ops/windows.py:337`), so both packages take the same path;
    and only if the block's `attn` params hold an unquantized qkv and proj:
    the JAX package's K2 cannot take an int8 proj, so its int8 serving runs
    such blocks on the plain path, and so does the port. Never for an
    attention split under tensor parallelism (`tp`): K2 adds the residual
    after proj, before the all-reduce of proj's partial sums could. One that
    stays whole on every rank comes here with `tp` None, as in one process."""
    return (tp is None and kernels and not train and C <= 768 and C % heads == 0
            and "kernel" in attn["qkv"] and "kernel" in attn["proj"])


def fused_half_block(params, x, *, kind, heads, res, ws, shift, pretrained_ws=0):
    """x: (B, L, C) -> x + attention half-block residual.

    kind="v1": x + proj(attn_v1(LN1(x)))   (HTS-AT pre-norm half)
    kind="v2": x + LN1(proj(attn_v2(x)))   (Swin-V2 post-norm half)
    The operands go to x's type, as the JAX caller casts them."""
    H, W = res
    B, L, C = x.shape
    ap = params["attn"]
    if kind == "v2":
        bias = _v2_bias(ap, ws, heads, pretrained_ws)
        bqkv = _v2_qkv_bias(ap)
        logit_scale = ap["logit_scale"].reshape(heads)
    else:
        bias = _v1_bias(ap, ws, heads)
        bqkv = ap["qkv"]["bias"]
        logit_scale = None
    t = lambda a: None if a is None else a.to(x.dtype).contiguous()
    xs = x.reshape(B, H, W, C)
    mask = None
    if shift > 0:
        xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
        mask = constant(shift_attn_mask, H, W, ws, shift, device=x.device, dtype=x.dtype)
    ln = params["norm1"]
    out = fused_attn_half_block(
        xs.contiguous(), t(ap["qkv"]["kernel"]), t(bqkv), t(ap["proj"]["kernel"]),
        t(ap["proj"]["bias"]), t(bias), t(ln["scale"]), t(ln["bias"]), mask=mask,
        logit_scale=t(logit_scale), kind=kind, heads=heads, ws=ws)
    if shift > 0:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out.reshape(B, L, C)
