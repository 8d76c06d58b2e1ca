"""AVVP model (`dg_sct_tpu/models/avvp.py`, DG-SCT's `MGN_Net`): (wave (B,
T, L), frames (B, T, H, W, 3), video_st (B, T, 512) r2plus1d features) ->
the clip, modality and per-segment event probabilities.

The interleaved towers and adapters are the AVE model's. On top: the
towers' features projected to `dim`, the slim temporal attention's gates,
the r2plus1d fusion, class-aware grouping of the audio (with the HAN
encoder over the visual tokens) and of the visual tokens onto the class
tokens, cross-modal grouping of the two, and the probability heads.
Parameters and state are nested dicts and lists of tensors with the JAX
package's tree and shapes.
"""
from __future__ import annotations

import torch

from ..configs import AVVPModelConfig
from ..device import resolve_device
from ..ops.basic import GELU_MODES, Init, linear, linear_init, seeded_init
from ..ops.rnn import bilstm, bilstm_init
from ..utils.profiling import span
from . import grouping as G
from . import htsat as H
from . import interleave as I
from . import swinv2 as S
from .ave import cast_for_compute
from .heads import ave as ave_heads

SLIM_D_MODEL = 64
SLIM_FFN = 1024
SLIM_GAMMA = 0.05


# ---------------------------------------------------------------------------
# the slim temporal attention: gates only
# ---------------------------------------------------------------------------

def init_slim_temporal_attention(init: Init, dim=128, d_model=SLIM_D_MODEL):
    enc = lambda: {"affine": linear_init(init, 2 * d_model, d_model),
                   "layers": [ave_heads.init_encoder_layer(init, d_model, SLIM_FFN)
                              for _ in range(2)]}
    return {"audio_rnn": bilstm_init(init, dim, d_model),
            "visual_rnn": bilstm_init(init, dim, d_model),
            "video_encoder": enc(),
            "audio_encoder": enc(),
            "audio_gated": linear_init(init, d_model, 1),
            "video_gated": linear_init(init, d_model, 1)}


def slim_temporal_attention(params, v_feat, a_feat, *, gamma=SLIM_GAMMA, train=False):
    """v_feat, a_feat (B, T, dim) -> gated (v, a), same shapes: each BiLSTM
    (dim -> 2 x 64), an affine to 64 and two encoder layers, then each
    modality scaled by 1 + gamma * the other's sigmoid gate. The encoder
    layers run without dropout in training too, as in the JAX package."""
    def run_encoder(p, x):
        x = linear(p["affine"], x)
        for lp in p["layers"]:
            x = ave_heads.encoder_layer(lp, x, nhead=4, train=train)
        return x

    video_kv = run_encoder(params["video_encoder"],
                           bilstm(params["visual_rnn"], v_feat).transpose(0, 1))
    audio_kv = run_encoder(params["audio_encoder"],
                           bilstm(params["audio_rnn"], a_feat).transpose(0, 1))
    audio_gate = torch.sigmoid(linear(params["audio_gated"], audio_kv)).transpose(0, 1)
    video_gate = torch.sigmoid(linear(params["video_gated"], video_kv)).transpose(0, 1)
    return v_feat + audio_gate * v_feat * gamma, a_feat + video_gate * a_feat * gamma


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def init_avvp_model(cfg: AVVPModelConfig, *, seed: int = 0, device=None):
    """Random float32 (params, state) with the JAX package's tree, from a
    torch.Generator seeded with `seed`, on `device` (None: the card). On
    device "meta" it builds shapes only. The class tokens start at zero, as
    in the JAX package."""
    init = seeded_init(seed, device)
    htsat_params, htsat_state = H.init_htsat(init, cfg.htsat)
    adapter_params, adapter_state = I.init_adapters(init, cfg)
    d, n = cfg.dim, cfg.num_classes
    group = lambda depth, **kw: G.modality_trans_init(init, d, depth=depth, num_group_tokens=n,
                                                      num_output_groups=n, **kw)
    params = {
        "swin": S.init_swinv2(init, cfg.swin),
        "htsat": htsat_params,
        "adapters": adapter_params,
        "fc_a": linear_init(init, cfg.htsat.num_features, d),
        "fc_v": linear_init(init, cfg.swin.num_features, d),
        "fc_st": linear_init(init, 512, d),
        "fc_fusion": linear_init(init, 2 * d, d),
        "audio_token": init.zeros((n, d)),
        "visual_token": init.zeros((n, d)),
        "audio_cug": group(cfg.depth_aud, use_han=True, han_tokens=cfg.num_frames),
        "visual_cug": group(cfg.depth_vis),
        "av_mcg": group(cfg.depth_av),
        "fc_prob": linear_init(init, d, 1),
        "fc_prob_a": linear_init(init, d, 1),
        "fc_prob_v": linear_init(init, d, 1),
        "fc_cls": linear_init(init, d, n),
        "temporal_attn": init_slim_temporal_attention(init, d),
    }
    return params, {"htsat": htsat_state, "adapters": adapter_state}


def heads(params, f_v, f_a, video_st, cfg: AVVPModelConfig, *, train=False, gen=None,
          gelu="exact"):
    """The towers' features f_v (B, T, 1536) and f_a (B, T, 768) and the
    r2plus1d features (B, T, 512) -> the output dict of `forward`."""
    x1_0 = linear(params["fc_a"], f_a)
    vid_s = linear(params["fc_v"], f_v)
    vid_s, x1_0 = slim_temporal_attention(params["temporal_attn"], vid_s, x1_0, train=train)
    vid_st = linear(params["fc_st"], video_st)
    x2_0 = linear(params["fc_fusion"], torch.cat([vid_s, vid_st], dim=-1))

    hard = cfg.unimodal_assign == "hard"
    xhard = cfg.crossmodal_assign == "hard"
    kw = dict(train=train, gen=gen, gelu=gelu)
    x2, attn_visual, _ = G.modality_trans(params["visual_cug"], x2_0, params["visual_token"],
                                          hard=hard, gumbel=hard, return_attn=True, **kw)
    x1, attn_audio, _ = G.modality_trans(params["audio_cug"], x1_0, params["audio_token"],
                                         x_other=x2_0, hard=hard, gumbel=hard,
                                         return_attn=True, **kw)
    x, _, _ = G.modality_trans(params["av_mcg"], x1, x2, hard=xhard, gumbel=xhard, **kw)

    key = cfg.unimodal_assign
    a_prob = torch.sigmoid(linear(params["fc_prob_a"], x1))         # (B, n, 1)
    v_prob = torch.sigmoid(linear(params["fc_prob_v"], x2))
    return {"aud_cls_prob": linear(params["fc_cls"], params["audio_token"]),
            "vis_cls_prob": linear(params["fc_cls"], params["visual_token"]),
            "global_prob": torch.sigmoid(linear(params["fc_prob"], x)).sum(-1),
            "a_prob": a_prob.sum(-1),
            "v_prob": v_prob.sum(-1),
            "a_frame_prob": (a_prob * attn_audio[key]).transpose(1, 2),     # (B, T, n)
            "v_frame_prob": (v_prob * attn_visual[key]).transpose(1, 2)}


def forward(params, state, wave, images, video_st, cfg: AVVPModelConfig, *, train=False,
            kernels=True, int8_attn=False, gelu="exact", device=None, gen=None,
            mixup_lambda=None, remat_policy="full"):
    """wave (B, T, L); images (B, T, H, W, 3) channels-last frames; video_st
    (B, T, 512); tensors or arrays, moved to `device` (None: the card), where
    `params` must lie. `kernels`, `int8_attn`, `gelu` (the towers' and the
    grouping heads' MLPs) as `models.ave.forward` takes them; the heads run
    no kernel. Outputs: aud_cls_prob and vis_cls_prob (n, n) class-token
    logits, global_prob, a_prob and v_prob (B, n), a_frame_prob and
    v_frame_prob (B, T, n).

    Eval returns the outputs. `train=True` returns (outputs, new state) and
    runs no kernel, whatever `kernels` says; `gen`, a torch.Generator on
    `device`, draws the towers' SpecAugment, drop_path and dropout and the
    HAN's Gumbel noise (None: none of them); `mixup_lambda` (B*T,) mixes the
    log-mel maps; `remat_policy` is the interleave's checkpointing."""
    if gelu not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu!r} not in {GELU_MODES}")
    device = resolve_device(device)
    params = cast_for_compute(params, cfg.compute_dtype)
    wave = torch.as_tensor(wave, device=device)
    if cfg.compute_dtype != torch.float32:
        wave = wave.to(cfg.compute_dtype)
    dtype = params["swin"]["patch_embed"]["kernel"].dtype
    images = torch.as_tensor(images, device=device).to(dtype)
    video_st = torch.as_tensor(video_st, device=device).to(params["fc_st"]["kernel"].dtype)
    if mixup_lambda is not None:
        mixup_lambda = torch.as_tensor(mixup_lambda, device=device)
    gen = gen if train else None
    B, T = wave.shape[0], wave.shape[1]
    with span("dgsct.model.towers"):
        feats, new_state = I.forward(params, state, wave.reshape(B * T, -1),
                                     images.reshape((B * T,) + tuple(images.shape[2:])), cfg,
                                     kernels=kernels and not train, int8_attn=int8_attn, gelu=gelu,
                                     train=train, gen=gen, mixup_lambda=mixup_lambda,
                                     remat_policy=remat_policy)
    with span("dgsct.model.heads"):
        out = heads(params, feats["f_v"].reshape(B, T, -1), feats["f_a"].reshape(B, T, -1),
                    video_st, cfg, train=train, gen=gen, gelu=gelu)
    return (out, new_state) if train else out
