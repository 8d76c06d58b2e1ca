"""Swin-V2-Large visual tower (frozen backbone).

timm 0.6.12 `swinv2_large_window12_192_22k` semantics: post-norm residuals,
scaled-cosine window attention with a clamped logit scale, the log-CPB bias,
and V2 patch merging (reduction, then norm). The interleave drives it block
by block; `forward_features` runs it alone, without adapters.
"""
from __future__ import annotations

from ..configs import SwinV2Config
from ..ops.basic import (Init, drop_path_rates, drop_residual, layer_norm, layer_norm_init,
                         linear, merge_2x2, mlp, mlp_init, patch_embed, patch_embed_init)
from ..ops.windows import (attention_v2_init, fused_block_eligible, fused_half_block,
                           shifted_window_attention, window_attention_v2)
from ..parallel.tp import for_split


def init_block(init: Init, dim, heads, mlp_ratio):
    return {"attn": attention_v2_init(init, dim, heads),
            "norm1": layer_norm_init(init, dim),
            "mlp": mlp_init(init, dim, int(dim * mlp_ratio)),
            "norm2": layer_norm_init(init, dim)}


def init_swinv2(init: Init, cfg: SwinV2Config):
    params = {"patch_embed": patch_embed_init(init, cfg.patch_size, cfg.in_chans,
                                              cfg.embed_dim, norm=True)}
    layers = []
    for s in range(cfg.num_layers):
        dim = cfg.stage_dim(s)
        stage = {"blocks": [init_block(init, dim, cfg.num_heads[s], cfg.mlp_ratio)
                            for _ in range(cfg.depths[s])]}
        if s < cfg.num_layers - 1:
            stage["downsample"] = {"reduction": {"kernel": init.normal((4 * dim, 2 * dim), 0.02)},
                                   "norm": layer_norm_init(init, 2 * dim)}
        layers.append(stage)
    params["layers"] = layers
    params["norm"] = layer_norm_init(init, cfg.num_features)
    return params


def block_plan(cfg: SwinV2Config):
    """Static per-block metadata (timm's constructor): dim, heads, res, ws,
    shift and the drop-path rate dpr, linearly spaced to cfg.drop_path_rate."""
    dprs = drop_path_rates(cfg.depths, cfg.drop_path_rate)
    plan = []
    for s in range(cfg.num_layers):
        res = cfg.stage_resolution(s)
        ws = min(cfg.window_size, min(res))
        first = sum(cfg.depths[:s])
        plan.append([dict(dim=cfg.stage_dim(s), heads=cfg.num_heads[s], res=res, ws=ws,
                          shift=0 if min(res) <= cfg.window_size or d % 2 == 0 else ws // 2,
                          pretrained_ws=cfg.pretrained_window_sizes[s], dpr=dprs[first + d],
                          hidden=int(cfg.stage_dim(s) * cfg.mlp_ratio))
                     for d in range(cfg.depths[s])])
    return plan


def attn_part(params, x, meta, *, kernels=True, int8_attn=False, tp=None):
    """The spatial-attention half of a block before norm1 and the residual
    (timm's `blk._attn(x)`, which the interleave drives). x: (N, L, C).
    `tp`: tensor parallelism over this rank's heads (`parallel.tp`)."""
    H, W = meta["res"]
    return shifted_window_attention(
        lambda w, m, nw: window_attention_v2(params["attn"], w, num_heads=meta["heads"],
                                             ws=meta["ws"], mask=m, nW=nw,
                                             pretrained_ws=meta["pretrained_ws"],
                                             kernels=kernels, int8_attn=int8_attn, tp=tp),
        x, H=H, W=W, ws=meta["ws"], shift=meta["shift"])


def attn_half(params, x, meta, *, kernels=True, int8_attn=False, drop=None, tp=None):
    """x + norm1(attn(x)): K2 where it applies, else the plain composition,
    whose residual goes through drop_path with `drop` (mask1, mask2, rate).
    Under `tp`, an attention whose heads the model axis does not split runs
    whole, as in one process."""
    tp = for_split(tp, meta["heads"])
    if drop is None and fused_block_eligible(meta["dim"], meta["heads"], False, kernels,
                                             params["attn"], tp):
        return fused_half_block(params, x, kind="v2", heads=meta["heads"], res=meta["res"],
                                ws=meta["ws"], shift=meta["shift"],
                                pretrained_ws=meta["pretrained_ws"])
    attn = attn_part(params, x, meta, kernels=kernels, int8_attn=int8_attn, tp=tp)
    return x + drop_residual(layer_norm(params["norm1"], attn), drop, 0)


def block(params, x, meta, *, kernels=True, int8_attn=False, gelu="exact", drop=None, tp=None):
    """Post-norm V2 block: x += norm1(attn(x)); x += norm2(mlp(x)). `drop`
    (mask1, mask2, rate): drop_path on the two residuals (training). `tp`:
    an eval forward over tensor-parallel shards (`parallel.tp`)."""
    x = attn_half(params, x, meta, kernels=kernels, int8_attn=int8_attn, drop=drop, tp=tp)
    y = mlp(params["mlp"], x, gelu, kernels=kernels, tp=for_split(tp, meta["hidden"]))
    return x + drop_residual(layer_norm(params["norm2"], y), drop, 1)


def patch_merging(params, x, res, *, kernels=True):
    """V2 patch merging: cat 4 -> Linear(4C, 2C, no bias) -> LayerNorm(2C)."""
    return layer_norm(params["norm"], linear(params["reduction"], merge_2x2(x, res),
                                             kernels=kernels))


def patch_embed_tokens(params, images, cfg: SwinV2Config):
    """(N, H, W, 3) -> (N, (H/4)*(W/4), 192) patch tokens."""
    return patch_embed(params["patch_embed"], images, cfg.patch_size)


def forward_features(params, images, cfg: SwinV2Config, *, kernels=True, int8_attn=False,
                     gelu="exact"):
    """The tower alone, without adapters and in eval form (no drop_path):
    (N, H, W, 3) -> (N, 36, 1536) tokens after the final norm. AVQA's
    negative branch and its grounding stage run it frozen."""
    x = patch_embed_tokens(params, images, cfg)
    for s, stage in enumerate(block_plan(cfg)):
        for d, meta in enumerate(stage):
            x = block(params["layers"][s]["blocks"][d], x, meta, kernels=kernels,
                      int8_attn=int8_attn, gelu=gelu)
        if "downsample" in params["layers"][s]:
            x = patch_merging(params["layers"][s]["downsample"], x, cfg.stage_resolution(s),
                              kernels=kernels)
    return layer_norm(params["norm"], x)
