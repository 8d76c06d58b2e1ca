"""Interleaved dual-tower encoder: Swin-V2-L and HTS-AT in lockstep with
DG-SCT adapters between every paired block. Per paired block:

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
audio adapters take `cfg.adapter`, the visual ones `cfg.adapter_vis` where
the model has one (AVS, AVQA), else `cfg.adapter`. The
blocks run unrolled, in order. In training the tower residuals (never the
adapters') pass through drop_path, and each paired step and each plain
visual block is checkpointed under a remat policy. An eval forward may
pipeline a stage of repeated pairs over a `pipe` group (`pipeline`), as
the JAX package's `set_pipeline` does process-wide.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..configs import AVEModelConfig, ave_adapter_dims, ave_paired_layout, vis_adapter_cfg
from ..ops.basic import Init, drop_path_mask, drop_residual, layer_norm, mlp
from ..parallel.pipeline import gpipe
from ..parallel.tp import for_split
from ..utils.profiling import span
from . import adapter as A
from . import htsat as H
from . import swinv2 as S

ADKEYS = ("a_p1", "v_p1", "a_p2", "v_p2")


def _adapter_cfg(cfg, key):
    """The options of the adapters under `key` (an ADKEYS entry)."""
    return cfg.adapter if key.startswith("a_") else vis_adapter_cfg(cfg)


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
                                  num_tokens_other=a_tok, cfg=vis_adapter_cfg(cfg))
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
            fp, fs = A.fold_eval(ap, ast, _adapter_cfg(cfg, k))
            p["adapters"][k].append(fp)
            s["adapters"][k].append(fs)
    return p, s


REMAT_POLICIES = ("full", "dots", "none")
# matmul outputs, the activations policy "dots" keeps for the backward pass
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def remat(fn, policy: str):
    """`fn` checkpointed under a remat policy: "full" recomputes the whole
    block in the backward pass, "dots" keeps the matmul outputs and
    recomputes the rest, "none" keeps every activation (fn itself). The
    checkpointed fn must draw nothing at random: a recompute restores the
    global RNG only, never an explicit generator."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} not in {REMAT_POLICIES}")
    if policy == "none":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             list(DOT_OPS))
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _paired_step(blk_params, blk_state, f_v, f_a, v_drop, a_drop, vmeta, ameta, cfg, *,
                 kernels, int8_attn, gelu, train, group=None, tp=None):
    """One paired block: the four adapters around the Swin-V2 attention and
    MLP halves and the full HTS-AT block -> (f_v, f_a, a_maps, v_maps, new
    adapter states). `v_drop`/`a_drop`: (mask1, mask2, rate) of each tower's
    drop_path, or None; the adapter residuals are never dropped. `group`:
    the data-parallel group of the adapters' BNs; `tp`: tensor parallelism."""
    vp, ap, ad = blk_params
    acfg, vcfg = cfg.adapter, vis_adapter_cfg(cfg)
    kw = dict(kernels=kernels, train=train, group=group, tp=tp)
    new_st = {}
    with span("dgsct.model.adapter"):
        a_res, _, new_st["a_p1"] = A.adapter(ad["a_p1"], blk_state["a_p1"], f_a, f_v, acfg, **kw)
    with span("dgsct.model.adapter"):
        v_res, _, new_st["v_p1"] = A.adapter(ad["v_p1"], blk_state["v_p1"], f_v, f_a, vcfg, **kw)
    f_v = S.attn_half(vp, f_v, vmeta, kernels=kernels, int8_attn=int8_attn, drop=v_drop,
                      tp=tp) + v_res
    f_a = H.block(ap, f_a, dim=ameta["dim"], heads=ameta["heads"], res=ameta["res"],
                  ws=ameta["ws"], shift=ameta["shift"], kernels=kernels, gelu=gelu,
                  drop=a_drop, tp=tp, hidden=ameta["hidden"]) + a_res
    with span("dgsct.model.adapter"):
        a_res, a_maps, new_st["a_p2"] = A.adapter(ad["a_p2"], blk_state["a_p2"], f_a, f_v,
                                                  acfg, **kw)
    with span("dgsct.model.adapter"):
        v_res, v_maps, new_st["v_p2"] = A.adapter(ad["v_p2"], blk_state["v_p2"], f_v, f_a,
                                                  vcfg, **kw)
    y = mlp(vp["mlp"], f_v, gelu, kernels=kernels, tp=for_split(tp, vmeta["hidden"]))
    f_v = f_v + drop_residual(layer_norm(vp["norm2"], y), v_drop, 1) + v_res
    return f_v, f_a + a_res, a_maps, v_maps, new_st


def _plain_step(vp, f_v, v_drop, *, vmeta, kernels, int8_attn, gelu, tp=None):
    """An unpaired Swin-V2 block."""
    return S.block(vp, f_v, vmeta, kernels=kernels, int8_attn=int8_attn, gelu=gelu,
                   drop=v_drop, tp=tp)


SCAN_MIN_PAIRS = 2  # the JAX package's least number of pairs it stacks


def detect_pairs(stage, vplan, aplan):
    """A stage layout as PAIRS of repeated `(k-1 plain + 1 paired)` groups
    whose static metas (all but dpr) agree pair to pair, stage 2's
    `[None, None, b0] * 6` pattern (`dg_sct_tpu/models/interleave.py:130`):
    a list of per-pair entry lists, or None. A pair, not a group, repeats
    because the window shift alternates group to group; fewer than
    SCAN_MIN_PAIRS pairs give None."""
    groups, cur = [], []
    for e in stage:
        cur.append(e)
        if e[2] is not None:
            groups.append(cur)
            cur = []
    if cur or len(groups) < 2 or len(groups) % 2:
        return None
    k = len(groups[0])
    if any(len(g) != k for g in groups):
        return None
    pairs = [groups[i] + groups[i + 1] for i in range(0, len(groups), 2)]
    if len(pairs) < SCAN_MIN_PAIRS:
        return None
    same = lambda m1, m2: all(m1[kk] == m2[kk] for kk in m1 if kk != "dpr")
    for p in range(2 * k):
        for pair in pairs[1:]:
            if not same(vplan[pair[p][0]], vplan[pairs[0][p][0]]):
                return None
            if pairs[0][p][2] is not None and not same(aplan[pair[p][1]],
                                                       aplan[pairs[0][p][1]]):
                return None
    return pairs


def _pipelined_stage(params, state, s_idx, pairs, f_v, f_a, vplan, aplan, cfg, pipeline, *,
                     kernels, int8_attn, gelu):
    """Eval: a stage's repeated pairs as GPipe stages over `pipeline` =
    (pipe group, n_micro); the (batch x frames) rows stream through in
    n_micro microbatches and the last pair's spatial maps ride the carry.
    -> (f_v, f_a, a_maps, v_maps), the same on every rank of the group."""
    group, n_micro = pipeline
    n = f_v.shape[0]
    if n % n_micro:
        raise ValueError(f"batch*frames={n} not divisible by n_micro={n_micro}")
    vblocks = params["swin"]["layers"][s_idx]["blocks"]
    ablocks = params["htsat"]["layers"][s_idx]["blocks"]
    metas = [(vplan[vb], None if ai is None else aplan[ab]) for vb, ab, ai in pairs[0]]
    stages = [[{"v": vblocks[vb]} if ai is None else
               {"v": vblocks[vb], "a": ablocks[ab],
                "ad": {k: params["adapters"][k][ai] for k in ADKEYS},
                "ast": {k: state["adapters"][k][ai] for k in ADKEYS}}
               for vb, ab, ai in pair] for pair in pairs]

    def pair_body(stage, carry):
        fv, fa, am, vm = carry
        for sp, (vmeta, ameta) in zip(stage, metas):
            if ameta is None:
                fv = _plain_step(sp["v"], fv, None, vmeta=vmeta, kernels=kernels,
                                 int8_attn=int8_attn, gelu=gelu)
            else:
                fv, fa, am, vm, _ = _paired_step((sp["v"], sp["a"], sp["ad"]), sp["ast"], fv, fa,
                                                 None, None, vmeta, ameta, cfg, kernels=kernels,
                                                 int8_attn=int8_attn, gelu=gelu, train=False)
        return [fv, fa, am, vm]

    mb = n // n_micro
    split = lambda x: x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    zeros = lambda tokens, x: torch.zeros((n_micro, mb, 1, tokens), dtype=x.dtype,
                                          device=x.device)
    mbs = [split(f_v), split(f_a), zeros(f_a.shape[1], f_a), zeros(f_v.shape[1], f_v)]
    outs = gpipe(pair_body, stages, mbs, group)
    return tuple(o.reshape((n,) + tuple(o.shape[2:])) for o in outs)


def _drop_masks(gen, n, rate, device):
    """A block's (mask1, mask2, rate) of drop_path, drawn from `gen` now;
    None without `gen` or at rate 0."""
    if gen is None or rate == 0.0:
        return None
    return (drop_path_mask(gen, n, rate, device), drop_path_mask(gen, n, rate, device), rate)


def forward(params, state, wave, images, cfg: AVEModelConfig, *, kernels=True, int8_attn=False,
            gelu="exact", train=False, gen=None, mixup_lambda=None, remat_policy="full",
            return_stage_taps=False, group=None, tp=None, pipeline=None):
    """wave: (N, L) flattened clips; images: (N, H, W, 3) flattened frames.
    Returns ({"f_v" (N, 1, 1536), "f_a" (N, 1, 768), "vis_tokens" (N, 36,
    1536)}, new state). With `return_stage_taps` the outputs also hold
    "stage_taps": each stage's visual tokens before its downsample (the
    AVS model's multi-scale taps), the last one through `swin.norm`.

    Training: bn0 and the adapters' BNs on the batch's statistics, their
    new running stats in the new state; with `gen`, SpecAugment, then per
    block in order the visual drop_path masks (attention, MLP) and, in a
    paired block, the audio ones, all drawn before the block runs; with
    `mixup_lambda` (N,), mixup of the log-mel maps. Each paired step and
    each plain visual block is checkpointed under `remat_policy`.
    `int8_attn`: the quantized Swin-V2 blocks run the int8 attention core.

    Parallel modes: `group`, data parallelism in training (bn0 and the
    adapters' BNs on the global batch's statistics, mixup's flip over it);
    `tp`, an eval forward over tensor-parallel shards (`parallel.tp`);
    `pipeline` = (pipe group, n_micro), an eval forward that runs each stage
    of at least SCAN_MIN_PAIRS repeated pairs whose count the group's size
    divides through GPipe (stage 2 at full width: 3 pairs), every other
    stage on every rank; the outputs then hold "pipelined_stages", the
    indices of the stages it pipelined."""
    device = wave.device
    f_v = S.patch_embed_tokens(params["swin"], images, cfg.swin)
    f_a, new_frontend_state = H.frontend(params["htsat"], state["htsat"], wave, cfg.htsat,
                                         train=train, gen=gen, mixup_lambda=mixup_lambda,
                                         group=group)
    vis_plan = S.block_plan(cfg.swin)
    aud_plan = H.block_plan(cfg.htsat)
    new_adapter_state = {k: list(state["adapters"][k]) for k in ADKEYS}
    v_maps = a_maps = None
    tower_gen = gen if train else None
    wrap = (lambda fn: remat(fn, remat_policy)) if train else (lambda fn: fn)
    layout = ave_paired_layout(cfg.swin, cfg.htsat)
    stage_taps, pipelined = [], []

    for s_idx, stage in enumerate(layout):
        if pipeline is not None and not train:
            pairs = detect_pairs(stage, vis_plan[s_idx], aud_plan[s_idx])
            if pairs is not None and len(pairs) % dist.get_world_size(pipeline[0]) == 0:
                f_v, f_a, a_maps, v_maps = _pipelined_stage(
                    params, state, s_idx, pairs, f_v, f_a, vis_plan[s_idx], aud_plan[s_idx], cfg,
                    pipeline, kernels=kernels, int8_attn=int8_attn, gelu=gelu)
                pipelined.append(s_idx)
                stage = []
        for (vb, ab, ai) in stage:
            vp = params["swin"]["layers"][s_idx]["blocks"][vb]
            vmeta = vis_plan[s_idx][vb]
            v_drop = _drop_masks(tower_gen, f_v.shape[0], vmeta["dpr"], device)
            if ai is None:
                step = wrap(functools.partial(_plain_step, vmeta=vmeta, kernels=kernels,
                                              int8_attn=int8_attn, gelu=gelu, tp=tp))
                f_v = step(vp, f_v, v_drop)
                continue
            ap = params["htsat"]["layers"][s_idx]["blocks"][ab]
            ameta = aud_plan[s_idx][ab]
            a_drop = _drop_masks(tower_gen, f_a.shape[0], ameta["dpr"], device)
            blk_params = (vp, ap, {k: params["adapters"][k][ai] for k in ADKEYS})
            blk_state = {k: state["adapters"][k][ai] for k in ADKEYS}
            step = wrap(functools.partial(_paired_step, vmeta=vmeta, ameta=ameta, cfg=cfg,
                                          kernels=kernels, int8_attn=int8_attn, gelu=gelu,
                                          train=train, group=group, tp=tp))
            f_v, f_a, a_maps, v_maps, new_st = step(blk_params, blk_state, f_v, f_a, v_drop,
                                                    a_drop)
            for k in ADKEYS:
                new_adapter_state[k][ai] = new_st[k]

        if return_stage_taps:
            last = s_idx == len(layout) - 1
            stage_taps.append(layer_norm(params["swin"]["norm"], f_v) if last else f_v)
        if "downsample" in params["swin"]["layers"][s_idx]:
            f_v = S.patch_merging(params["swin"]["layers"][s_idx]["downsample"], f_v,
                                  cfg.swin.stage_resolution(s_idx), kernels=kernels)
        if "downsample" in params["htsat"]["layers"][s_idx]:
            f_a = H.patch_merging(params["htsat"]["layers"][s_idx]["downsample"], f_a,
                                  cfg.htsat.stage_resolution(s_idx), kernels=kernels)

    f_v = layer_norm(params["swin"]["norm"], f_v)
    vis_tokens = f_v
    # spatial-attention pooling with the last p2 maps
    f_v = torch.einsum("bon,bnc->boc", v_maps, f_v)
    f_a = torch.einsum("bon,bnc->boc", a_maps, f_a)
    new_state = {"htsat": new_frontend_state, "adapters": new_adapter_state}
    out = {"f_v": f_v, "f_a": f_a, "vis_tokens": vis_tokens}
    if return_stage_taps:
        out["stage_taps"] = stage_taps
    if pipeline is not None:
        out["pipelined_stages"] = tuple(pipelined)
    return out, new_state
