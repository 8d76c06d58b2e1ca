"""Interleaved dual-tower encoder, eval: Swin-V2-L and HTS-AT in lockstep
with DG-SCT adapters between every paired block. Per paired block:

    a_res, _ = adapter_a_p1(f_a, prompt=f_v)
    v_res, _ = adapter_v_p1(f_v, prompt=f_a)
    f_v = f_v + norm1(attn(f_v)) + v_res          # post-norm V2 half-block
    f_a = block_a(f_a) + a_res                    # full pre-norm V1 block
    a_res, a_maps = adapter_a_p2(f_a, prompt=f_v)
    v_res, v_maps = adapter_v_p2(f_v, prompt=f_a)
    f_v = f_v + norm2(mlp(f_v)) + v_res
    f_a = f_a + a_res

Unpaired visual blocks run the plain V2 block; stage ends merge patches in
both towers. The last p2 spatial maps pool each tower's final tokens. The
blocks run unrolled, in order.
"""
from __future__ import annotations

import torch

from ..configs import AVEModelConfig, ave_adapter_dims, ave_paired_layout
from ..ops.basic import Init, layer_norm, mlp
from . import adapter as A
from . import htsat as H
from . import swinv2 as S

ADKEYS = ("a_p1", "v_p1", "a_p2", "v_p2")


def init_adapters(init: Init, cfg: AVEModelConfig):
    """4 x 12 adapters (audio/visual x p1/p2). Returns (params, state)."""
    params = {k: [] for k in ADKEYS}
    state = {k: [] for k in ADKEYS}
    for (v_dim, v_tok, a_dim, a_tok) in ave_adapter_dims(cfg.swin, cfg.htsat):
        for name in ("a_p1", "a_p2"):
            p, s = A.init_adapter(init, dim=a_dim, other_dim=v_dim, num_tokens_self=a_tok,
                                  num_tokens_other=v_tok, cfg=cfg.adapter)
            params[name].append(p)
            state[name].append(s)
        for name in ("v_p1", "v_p2"):
            p, s = A.init_adapter(init, dim=v_dim, other_dim=a_dim, num_tokens_self=v_tok,
                                  num_tokens_other=a_tok, cfg=cfg.adapter)
            params[name].append(p)
            state[name].append(s)
    return params, state


def fold_adapters_eval(params, state, cfg: AVEModelConfig):
    """`adapter.fold_eval` over all four adapter lists; exact in eval."""
    p, s = dict(params), dict(state)
    p["adapters"] = {k: [] for k in ADKEYS}
    s["adapters"] = {k: [] for k in ADKEYS}
    for k in ADKEYS:
        for ap, ast in zip(params["adapters"][k], state["adapters"][k]):
            fp, fs = A.fold_eval(ap, ast, cfg.adapter)
            p["adapters"][k].append(fp)
            s["adapters"][k].append(fs)
    return p, s


def forward(params, state, wave, images, cfg: AVEModelConfig, *, kernels=True, gelu="exact"):
    """wave: (N, L) flattened clips; images: (N, H, W, 3) flattened frames.
    Returns {"f_v" (N, 1, 1536), "f_a" (N, 1, 768), "vis_tokens" (N, 36, 1536)}."""
    acfg = cfg.adapter
    f_v = S.patch_embed_tokens(params["swin"], images, cfg.swin)
    f_a = H.frontend(params["htsat"], state["htsat"], wave, cfg.htsat)
    vis_plan = S.block_plan(cfg.swin)
    aud_plan = H.block_plan(cfg.htsat)
    v_maps = a_maps = None

    for s_idx, stage in enumerate(ave_paired_layout(cfg.swin, cfg.htsat)):
        for (vb, ab, ai) in stage:
            vp = params["swin"]["layers"][s_idx]["blocks"][vb]
            vmeta = vis_plan[s_idx][vb]
            if ai is None:
                f_v = S.block(vp, f_v, vmeta, kernels=kernels, gelu=gelu)
                continue
            ap = params["htsat"]["layers"][s_idx]["blocks"][ab]
            ameta = aud_plan[s_idx][ab]
            ad = {k: (params["adapters"][k][ai], state["adapters"][k][ai]) for k in ADKEYS}
            a_res, _ = A.adapter(*ad["a_p1"], f_a, f_v, acfg, kernels=kernels)
            v_res, _ = A.adapter(*ad["v_p1"], f_v, f_a, acfg, kernels=kernels)
            f_v = S.attn_half(vp, f_v, vmeta, kernels=kernels) + v_res
            f_a = H.block(ap, f_a, dim=ameta["dim"], heads=ameta["heads"], res=ameta["res"],
                          ws=ameta["ws"], shift=ameta["shift"], kernels=kernels, gelu=gelu)
            f_a = f_a + a_res
            a_res, a_maps = A.adapter(*ad["a_p2"], f_a, f_v, acfg, kernels=kernels)
            v_res, v_maps = A.adapter(*ad["v_p2"], f_v, f_a, acfg, kernels=kernels)
            f_v = f_v + layer_norm(vp["norm2"], mlp(vp["mlp"], f_v, gelu)) + v_res
            f_a = f_a + a_res

        if "downsample" in params["swin"]["layers"][s_idx]:
            f_v = S.patch_merging(params["swin"]["layers"][s_idx]["downsample"], f_v,
                                  cfg.swin.stage_resolution(s_idx))
        if "downsample" in params["htsat"]["layers"][s_idx]:
            f_a = H.patch_merging(params["htsat"]["layers"][s_idx]["downsample"], f_a,
                                  cfg.htsat.stage_resolution(s_idx))

    f_v = layer_norm(params["swin"]["norm"], f_v)
    vis_tokens = f_v
    # spatial-attention pooling with the last p2 maps
    f_v = torch.einsum("bon,bnc->boc", v_maps, f_v)
    f_a = torch.einsum("bon,bnc->boc", a_maps, f_a)
    return {"f_v": f_v, "f_a": f_a, "vis_tokens": vis_tokens}
