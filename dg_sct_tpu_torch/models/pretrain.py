"""The pretrain suite's model (`dg_sct_tpu/models/pretrain.py`, the CLIP x
CLAP `MMIL_Net` of the reference's `pretrain/nets/net_trans.py`):
(wave (B, T, L), frames (B, T, 224, 224, 3)) -> modality-weighted event
scores over the prompt classes and the clip-pooled audio-visual contrastive
logits.

CLIP's ViT-B/32 and the HTS-AT tower run in lockstep, their 12 blocks
paired 1:1. Per pair, in the reference's order: the HTS-AT block, the ViT
attention half, adapters a_p1 and v_p1, the ViT MLP half, adapters a_p2
and v_p2, then HTS-AT's patch merging at a stage's end. The visual
adapters see all 50 ViT tokens, the class token included. Heads:
  * clip_matching: the prompt-learned text features through the whole text
    tower (n_cls x 77 tokens, every forward), each side blended with its
    ClipAdapter (ratio 0.2), cosine logits against the projected class token;
  * clap_matching: cosine logits of the projected audio latent against the
    static CLAP text features (`clap_text_features`, a frozen leaf);
  * event_scores = w1 * logits_v + w2 * logits_a, w = logits / (logits_v +
    logits_a) (nothing keeps that sum away from zero, as in the reference);
  * the symmetric audio <-> image contrastive logits over the clips.

The audio head reads only HTS-AT's latent (`htsat.tscam_latent`), not the
whole tscam head. Eval runs K2 in HTS-AT's blocks and, on adapters folded by
`interleave.fold_adapters_eval`, K3 in all 48 adapters; training runs none.
"""
from __future__ import annotations

import torch

from ..configs import PretrainModelConfig
from ..device import resolve_device
from ..ops.basic import linear, linear_init, seeded_init
from . import adapter as A
from . import clip as C
from . import htsat as H
from . import prompt_learner as P
from .ave import cast_for_compute

ADKEYS = ("a_p1", "v_p1", "a_p2", "v_p2")
RATIO = 0.2   # the ClipAdapter blend of clip_matching


def htsat_block_list(cfg: PretrainModelConfig):
    """HTS-AT's (stage, block) pairs in order: 12 at full width."""
    return [(s, b) for s, depth in enumerate(cfg.htsat.depths) for b in range(depth)]


def init_pretrain_model(cfg: PretrainModelConfig, classnames, *, clap_text_features=None,
                        seed: int = 0, device=None):
    """Random float32 (params, state, prompt buffers) with the JAX package's
    tree, from a torch.Generator seeded with `seed`, on `device` (None: the
    card); on "meta" shapes only. `clap_text_features` (n_cls, embed_dim),
    e.g. from `compute_clap_text_features`; random if None."""
    init = seeded_init(seed, device)
    device = init.device
    blocks = htsat_block_list(cfg)
    if len(blocks) != cfg.clip.vision_layers:
        raise ValueError(f"{len(blocks)} HTS-AT blocks pair with {cfg.clip.vision_layers} ViT "
                         f"blocks")
    visual = C.init_visual(init, cfg.clip)
    text = C.init_text(init, cfg.clip)
    htsat_params, htsat_state = H.init_htsat(init, cfg.htsat)
    buffers = P.build_prompt_buffers(list(classnames), text["token_embedding"], cfg.prompt,
                                     cfg.clip)
    adapters = {k: [] for k in ADKEYS}
    adapter_state = {k: [] for k in ADKEYS}
    v_dim = cfg.clip.vision_width
    v_tok = (cfg.clip.image_size // cfg.clip.vision_patch) ** 2 + 1   # the class token too
    for s, _ in blocks:
        a_dim = cfg.htsat.stage_dim(s)
        res = cfg.htsat.stage_resolution(s)
        a_tok = res[0] * res[1]
        for k in ADKEYS:
            audio = k.startswith("a_")
            p, st = A.init_adapter(init, dim=a_dim if audio else v_dim,
                                   other_dim=v_dim if audio else a_dim,
                                   num_tokens_self=a_tok if audio else v_tok,
                                   num_tokens_other=v_tok if audio else a_tok, cfg=cfg.adapter)
            adapters[k].append(p)
            adapter_state[k].append(st)
    n_cls = buffers["token_prefix"].shape[0]
    if clap_text_features is None:
        clap_text_features = init.normal((n_cls, cfg.clip.embed_dim), 0.02)
    embed = cfg.clip.embed_dim
    params = {
        "visual": visual,
        "text": text,
        "htsat": htsat_params,
        "adapters": adapters,
        "prompt_learner": P.init_prompt_learner(init, buffers, embed, cfg.clip.text_width),
        "clip_adapter": P.init_clip_adapter(init, embed, 4),
        "clip_adapter_text": P.init_clip_adapter(init, embed, 4),
        "audio_projection": {"fc1": linear_init(init, cfg.htsat.num_features, 512),
                             "fc2": linear_init(init, 512, embed)},
        "clap_text_features": torch.as_tensor(clap_text_features, device=device,
                                              dtype=torch.float32).clone(),
        "logit_scale_a": init.full((), float(torch.log(torch.tensor(1.0 / 0.07)))),
        "av_contrastive_fc": linear_init(init, embed, embed),
    }
    return params, {"htsat": htsat_state, "adapters": adapter_state}, buffers


def prompt_buffers(params, classnames, cfg: PretrainModelConfig):
    """The prompt buffers of `classnames` rebuilt from the model's own token
    embedding (as `init_pretrain_model` builds them)."""
    return P.build_prompt_buffers(list(classnames), params["text"]["token_embedding"],
                                  cfg.prompt, cfg.clip)


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def clip_matching(params, buffers, visual_grd, cfg: PretrainModelConfig):
    """Cosine logits (N, n_cls) of the blended visual features against the
    prompt-learned text features, scaled by CLIP's logit scale."""
    visual_grd = _unit(RATIO * P.clip_adapter(params["clip_adapter"], visual_grd)
                       + (1 - RATIO) * visual_grd)
    prompts = P.build_prompts(params["prompt_learner"], buffers,
                              class_token_position=cfg.prompt.class_token_position)
    text = C.encode_text_embeddings(params["text"], prompts, buffers["tokenized"], cfg.clip)
    text = _unit(RATIO * P.clip_adapter(params["clip_adapter_text"], text) + (1 - RATIO) * text)
    return torch.exp(params["text"]["logit_scale"]) * visual_grd @ text.T


def clap_matching(params, audio_features):
    """Cosine logits (N, n_cls) of the audio features against the static
    CLAP text features, scaled by logit_scale_a."""
    return (torch.exp(params["logit_scale_a"]) * _unit(audio_features)
            @ _unit(params["clap_text_features"]).T)


def heads(params, buffers, x, y, B, T, cfg: PretrainModelConfig):
    """The towers' final ViT tokens x (N, 50, 768) and HTS-AT tokens y
    (N, 64, 768) -> the output dict of `forward`."""
    ap = params["audio_projection"]
    latent = H.tscam_latent(params["htsat"], y, cfg.htsat)
    a_cls = linear(ap["fc2"], torch.relu(linear(ap["fc1"], latent)))    # (N, 512)
    v_cls = C.visual_project(params["visual"], x)                         # (N, 512)
    logits_v = clip_matching(params, buffers, v_cls, cfg)
    logits_a = clap_matching(params, a_cls)
    denom = logits_v + logits_a
    event_scores = (logits_v / denom) * logits_v + (logits_a / denom) * logits_a
    vn = _unit(v_cls.reshape(B, T, -1).mean(1))
    an = _unit(linear(params["av_contrastive_fc"], a_cls).reshape(B, T, -1).mean(1))
    scale = torch.exp(params["text"]["logit_scale"])
    return {"event_scores": event_scores, "v_cls": v_cls, "a_cls": a_cls,
            "logits_audio_image": scale * an @ vn.T, "logits_image_audio": scale * vn @ an.T}


def forward(params, state, buffers, wave, images, cfg: PretrainModelConfig, *, train=False,
            kernels=True, device=None, gen=None, mixup_lambda=None):
    """wave (B, T, L); images (B, T, H, W, 3) channels-last frames at
    cfg.clip.image_size; tensors or arrays, moved to `device` (None: the
    card), where `params` and `buffers` must lie. Outputs: event_scores
    (B*T, n_cls), v_cls and a_cls (B*T, embed_dim), logits_audio_image and
    logits_image_audio (B, B).

    Eval returns the outputs, with K2 in HTS-AT's blocks and K3 in each
    folded adapter when `kernels` is on. `train=True` returns (outputs, new
    state) and runs no kernel: bn0 and the adapters' BNs on the batch's
    statistics; `gen`, a torch.Generator on `device`, draws SpecAugment
    (None: none; the JAX forward gives the blocks no rng, so there is no
    drop_path, and the model has no dropout); `mixup_lambda` (B*T,) mixes
    the log-mel maps."""
    device = resolve_device(device)
    params = cast_for_compute(params, cfg.compute_dtype)
    dtype = params["visual"]["conv1"]["kernel"].dtype
    wave = torch.as_tensor(wave, device=device)
    images = torch.as_tensor(images, device=device).to(dtype)
    if cfg.compute_dtype != torch.float32:
        wave = wave.to(cfg.compute_dtype)
    if mixup_lambda is not None:
        mixup_lambda = torch.as_tensor(mixup_lambda, device=device)
    B, T = wave.shape[0], wave.shape[1]
    kernels = kernels and not train
    x = C.visual_embed(params["visual"], images.reshape((B * T,) + tuple(images.shape[2:])),
                       cfg.clip)                                          # (N, 50, 768)
    y, new_htsat_state = H.frontend(params["htsat"], state["htsat"], wave.reshape(B * T, -1),
                                    cfg.htsat, train=train, gen=gen if train else None,
                                    mixup_lambda=mixup_lambda)
    aud_plan = H.block_plan(cfg.htsat)
    ad, ad_state = params["adapters"], state["adapters"]
    new_adapter_state = {k: list(ad_state[k]) for k in ADKEYS}
    adapter = lambda k, i, a, b: A.adapter(ad[k][i], ad_state[k][i], a, b, cfg.adapter,
                                           kernels=kernels, train=train)
    for i, (s, b) in enumerate(htsat_block_list(cfg)):
        m = aud_plan[s][b]
        vp = params["visual"]["resblocks"][i]
        y = H.block(params["htsat"]["layers"][s]["blocks"][b], y, dim=m["dim"], heads=m["heads"],
                    res=m["res"], ws=m["ws"], shift=m["shift"], kernels=kernels)
        x = x + C.attention_part(vp, x, num_heads=cfg.clip.vision_heads)
        a_res, _, new_adapter_state["a_p1"][i] = adapter("a_p1", i, y, x)
        v_res, _, new_adapter_state["v_p1"][i] = adapter("v_p1", i, x, y)
        x, y = x + v_res, y + a_res
        x = x + C.mlp_part(vp, x)
        a_res, _, new_adapter_state["a_p2"][i] = adapter("a_p2", i, y, x)
        v_res, _, new_adapter_state["v_p2"][i] = adapter("v_p2", i, x, y)
        x, y = x + v_res, y + a_res
        layer = params["htsat"]["layers"][s]
        if b == cfg.htsat.depths[s] - 1 and "downsample" in layer:
            y = H.patch_merging(layer["downsample"], y, cfg.htsat.stage_resolution(s),
                                kernels=kernels)
    out = heads(params, buffers, x, y, B, T, cfg)
    if not train:
        return out
    return out, {"htsat": new_htsat_state, "adapters": new_adapter_state}
