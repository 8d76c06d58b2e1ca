"""PVT-v2 (Pyramid Vision Transformer v2) backbone over the JAX package's
tree (`dg_sct_tpu/models/pvt.py`): every preset b0-b5 and b2_li, and
`forward_features` returning the four channels-last maps at strides 4, 8,
16 and 32.

  * overlapping patch embeds, 7x7/4 then 3x3/2, padded by patch // 2 on
    every side as torch pads them (not XLA's "SAME");
  * pre-norm blocks, LayerNorm eps 1e-6, with spatial-reduction attention:
    a strided convolution, or in the `_li` variants the linear SRA (a 7x7
    adaptive average pool with torch's floor/ceil bins, 1x1 convolution,
    LN, GELU);
  * depthwise 3x3 convolutions in the MLPs (a ReLU before them in the
    linear variants);
  * stochastic depth linearly spaced over the total depth, drawn from a
    torch.Generator in training.

The AVS checkpoint carries the b5 tower (`utils.torch_convert.convert_pvt_v2`);
the AVS forward does not run it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.basic import (Init, apply_drop_path, conv2d, conv2d_init, drop_path_mask,
                         drop_path_rates, layer_norm, layer_norm_init, linear, linear_init)


@dataclasses.dataclass(frozen=True)
class PVTv2Config:
    img_size: int = 224
    embed_dims: tuple = (64, 128, 320, 512)
    depths: tuple = (3, 6, 40, 3)       # b5
    num_heads: tuple = (1, 2, 5, 8)
    mlp_ratios: tuple = (4, 4, 4, 4)
    sr_ratios: tuple = (8, 4, 2, 1)
    drop_path_rate: float = 0.1         # b5
    linear_sra: bool = False            # the `_li` variants
    ln_eps: float = 1e-6


def _preset(**defaults):
    def make(**kw):
        return PVTv2Config(**{**defaults, **kw})
    return make


pvt_v2_b0 = _preset(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2), mlp_ratios=(8, 8, 4, 4))
pvt_v2_b1 = _preset(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2), mlp_ratios=(8, 8, 4, 4))
pvt_v2_b2 = _preset(depths=(3, 4, 6, 3))
pvt_v2_b2_li = _preset(depths=(3, 4, 6, 3), linear_sra=True)
pvt_v2_b3 = _preset(depths=(3, 4, 18, 3))
pvt_v2_b4 = _preset(depths=(3, 8, 27, 3))
pvt_v2_b5 = _preset(depths=(3, 6, 40, 3))

LINEAR_SRA_POOL = 7


def _dwconv_init(init: Init, dim):
    """Depthwise 3x3: kernel (3, 3, 1, dim), one group a channel."""
    return {"kernel": init.normal((3, 3, 1, dim), 0.02), "bias": init.zeros((dim,))}


def _dwconv(params, x, H, W):
    B, L, C = x.shape
    return conv2d(params, x.reshape(B, H, W, C), groups=C).reshape(B, L, C)


def init_block(init: Init, dim, heads, mlp_ratio, sr_ratio, *, linear_sra=False):
    p = {"norm1": layer_norm_init(init, dim),
         "q": linear_init(init, dim, dim),
         "kv": linear_init(init, dim, 2 * dim),
         "proj": linear_init(init, dim, dim),
         "norm2": layer_norm_init(init, dim),
         "fc1": linear_init(init, dim, dim * mlp_ratio),
         "dwconv": _dwconv_init(init, dim * mlp_ratio),
         "fc2": linear_init(init, dim * mlp_ratio, dim)}
    if linear_sra:  # pool(7) -> 1x1 conv -> LN -> GELU whatever sr_ratio says
        p["sr"] = conv2d_init(init, 1, 1, dim, dim)
        p["sr_norm"] = layer_norm_init(init, dim)
    elif sr_ratio > 1:
        p["sr"] = conv2d_init(init, sr_ratio, sr_ratio, dim, dim)
        p["sr_norm"] = layer_norm_init(init, dim)
    return p


def block(params, x, H, W, *, heads, sr_ratio, linear_sra=False, eps=1e-6, drop=None):
    """x (B, H*W, C). `drop` (mask1, mask2, rate): stochastic depth on the
    attention and MLP residuals (training)."""
    B, L, C = x.shape
    hd = C // heads
    xn = layer_norm(params["norm1"], x, eps=eps)
    q = linear(params["q"], xn).reshape(B, L, heads, hd)
    if linear_sra:
        img = F.adaptive_avg_pool2d(xn.reshape(B, H, W, C).permute(0, 3, 1, 2), LINEAR_SRA_POOL)
        red = conv2d(params["sr"], img.permute(0, 2, 3, 1))
        red = F.gelu(layer_norm(params["sr_norm"], red.reshape(B, -1, C), eps=eps))
    elif sr_ratio > 1:
        red = conv2d(params["sr"], xn.reshape(B, H, W, C), stride=sr_ratio, padding="VALID")
        red = layer_norm(params["sr_norm"], red.reshape(B, -1, C), eps=eps)
    else:
        red = xn
    kv = linear(params["kv"], red).reshape(B, -1, 2, heads, hd)
    attn = torch.einsum("bnhd,bshd->bhns", q * hd ** -0.5, kv[:, :, 0])
    attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhns,bshd->bnhd", attn, kv[:, :, 1]).reshape(B, L, C)
    y = linear(params["proj"], out)
    x = x + (y if drop is None else apply_drop_path(y, drop[0], drop[2]))
    h = linear(params["fc1"], layer_norm(params["norm2"], x, eps=eps))
    if linear_sra:
        h = torch.relu(h)
    h = F.gelu(_dwconv(params["dwconv"], h, H, W))
    y = linear(params["fc2"], h)
    return x + (y if drop is None else apply_drop_path(y, drop[1], drop[2]))


def init_pvt_v2(init: Init, cfg: PVTv2Config = PVTv2Config()):
    stages, in_ch = [], 3
    for s in range(len(cfg.depths)):
        patch = 7 if s == 0 else 3
        dim = cfg.embed_dims[s]
        stages.append({
            "patch_embed": {"proj": conv2d_init(init, patch, patch, in_ch, dim),
                            "norm": layer_norm_init(init, dim)},
            "blocks": [init_block(init, dim, cfg.num_heads[s], cfg.mlp_ratios[s],
                                  cfg.sr_ratios[s], linear_sra=cfg.linear_sra)
                       for _ in range(cfg.depths[s])],
            "norm": layer_norm_init(init, dim)})
        in_ch = dim
    return {"stages": stages}


def forward_features(params, images, cfg: PVTv2Config = PVTv2Config(), *, train=False, gen=None):
    """images (N, H, W, 3) -> the 4 maps (N, H_i, W_i, C_i) at strides 4,
    8, 16, 32, each stage's tokens after its norm. Training with `gen`:
    stochastic depth at rates linearly spaced to cfg.drop_path_rate, each
    block's two masks drawn before it runs."""
    x, outs = images, []
    dprs = drop_path_rates(cfg.depths, cfg.drop_path_rate)
    cur = 0
    for s, stage in enumerate(params["stages"]):
        patch, stride = (7, 4) if s == 0 else (3, 2)
        pad = patch // 2
        x = conv2d(stage["patch_embed"]["proj"], x, stride=stride,
                   padding=((pad, pad), (pad, pad)))
        N, H, W, C = x.shape
        t = layer_norm(stage["patch_embed"]["norm"], x.reshape(N, H * W, C), eps=cfg.ln_eps)
        for bi, bp in enumerate(stage["blocks"]):
            rate = dprs[cur + bi]
            drop = None
            if train and gen is not None and rate > 0.0:
                drop = (drop_path_mask(gen, N, rate, x.device),
                        drop_path_mask(gen, N, rate, x.device), rate)
            t = block(bp, t, H, W, heads=cfg.num_heads[s], sr_ratio=cfg.sr_ratios[s],
                      linear_sra=cfg.linear_sra, eps=cfg.ln_eps, drop=drop)
        cur += cfg.depths[s]
        x = layer_norm(stage["norm"], t, eps=cfg.ln_eps).reshape(N, H, W, C)
        outs.append(x)
    return outs
