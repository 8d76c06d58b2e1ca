"""AVE model, eval: (wave (B, T, L), frames (B, T, H, W, 3)) ->
is_event_scores (B, T), event_scores (B, 28), av_gate (B, T), av_score (B, 28).

Parameters and state are nested dicts and lists of tensors with the JAX
package's tree and shapes (`dg_sct_tpu/models/ave.py`).
"""
from __future__ import annotations

import torch

from ..configs import AVEModelConfig
from ..device import resolve_device
from ..ops.basic import GELU_MODES, Init
from . import htsat as H
from . import interleave as I
from . import swinv2 as S
from .heads import ave as heads

TRAIN_TODO = ("training is not ported yet: see ROADMAP.md, queue 1, "
              "'AVE training with backward versions of the kernels'")


def init_ave_model(cfg: AVEModelConfig, *, seed: int = 0, device=None):
    """Random float32 (params, state) from a torch.Generator seeded with
    `seed`, on `device` (None: the card). On device "meta" it builds shapes
    only."""
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    init = Init(gen, device)
    htsat_params, htsat_state = H.init_htsat(init, cfg.htsat)
    adapter_params, adapter_state = I.init_adapters(init, cfg)
    params = {
        "swin": S.init_swinv2(init, cfg.swin),
        "htsat": htsat_params,
        "adapters": adapter_params,
        "temporal_attn": heads.init_temporal_attention(init, cfg.swin.num_features,
                                                       cfg.htsat.num_features),
        "CMBS": heads.init_cmbs(init, cfg.num_classes),
    }
    return params, {"htsat": htsat_state, "adapters": adapter_state}


def forward(params, state, wave, images, cfg: AVEModelConfig, *, train=False, kernels=True,
            gelu="exact", device=None):
    """wave: (B, T, L); images: (B, T, H, W, 3) channels-last frames, both
    tensors or arrays, moved to `device` (None: the card), where `params`
    must lie. `kernels` runs K1-K3 where the JAX package's three Pallas
    flags would; `gelu` is "exact" or "tanh". Frames fold into the batch
    axis as (b t)."""
    if train:
        raise NotImplementedError(TRAIN_TODO)
    if gelu not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu!r} not in {GELU_MODES}")
    device = resolve_device(device)
    wave = torch.as_tensor(wave, device=device)
    images = torch.as_tensor(images, device=device)
    images = images.to(params["swin"]["patch_embed"]["kernel"].dtype)
    B, T = wave.shape[0], wave.shape[1]
    feats = I.forward(params, state, wave.reshape(B * T, -1),
                      images.reshape((B * T,) + tuple(images.shape[2:])), cfg,
                      kernels=kernels, gelu=gelu)
    f_v = feats["f_v"].reshape(B, T, -1)
    f_a = feats["f_a"].reshape(B, T, -1)
    video_q, audio_q, av_gate = heads.temporal_attention(params["temporal_attn"], f_v, f_a)
    is_event_scores, event_scores, av_score = heads.cmbs(params["CMBS"], video_q, audio_q)
    return {"is_event_scores": is_event_scores[..., 0].transpose(0, 1),
            "event_scores": event_scores,
            "av_gate": av_gate[..., 0].transpose(0, 1),
            "av_score": av_score}
