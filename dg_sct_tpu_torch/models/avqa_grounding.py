"""AVQA's stage-1 grounding generator (`dg_sct_tpu/models/avqa_grounding.py`,
DG-SCT's `AVQA_AVatt_Grounding`): a positive/negative audio-visual match
classifier over (segment 0's audio, frame 0 of the positive clip, frame 0 of
a negative clip).

HTS-AT runs alone on segment 0 (no adapters), its tokens averaged; the
frozen Swin-V2 runs alone on both frames; the grounding and the match
classifier are the AVQA model's (`models.avqa`), whose heads of the same
names take these weights over in stage 2. Neither tower trains, so both run
without gradients in eval-form blocks, K1 and K2 where they apply; in
training HTS-AT's frontend still normalizes with the batch's statistics and
draws SpecAugment, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..configs import AVQAModelConfig
from ..device import resolve_device
from ..ops.basic import GELU_MODES, seeded_init
from . import htsat as H
from . import swinv2 as S
from .avqa import _grounding, audio_features, init_grounding_heads


def init_grounding_model(cfg: AVQAModelConfig, *, seed: int = 0, device=None):
    """Random float32 (params, state) with the JAX package's tree, from a
    torch.Generator seeded with `seed`, on `device` (None: the card). On
    device "meta" it builds shapes only."""
    init = seeded_init(seed, device)
    htsat_params, htsat_state = H.init_htsat(init, cfg.htsat)
    params = {"swin": S.init_swinv2(init, cfg.swin), "htsat": htsat_params,
              **init_grounding_heads(init, cfg)}
    return params, {"htsat": htsat_state}


def forward(params, state, wave, visual, cfg: AVQAModelConfig, *, train=False, kernels=True,
            gelu="exact", device=None, gen=None, mixup_lambda=None):
    """wave (B, T, L), of which segment 0 is heard; visual (B, 2, H, W, 3),
    frame 0 positive and frame 1 negative; tensors or arrays, moved to
    `device` (None: the card), where `params` must lie. -> match logits
    (2B, 2), rows [positive, negative] per clip. `kernels` and `gelu` as
    `models.ave.forward` takes them, for both towers.

    Eval returns the logits. `train=True` returns (logits, new state): bn0
    on the batch's statistics, SpecAugment from `gen` (a torch.Generator on
    `device`; None: none), mixup with `mixup_lambda` (B,)."""
    if gelu not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu!r} not in {GELU_MODES}")
    device = resolve_device(device)
    wave = torch.as_tensor(wave, device=device)
    B = wave.shape[0]
    dtype = params["swin"]["patch_embed"]["kernel"].dtype
    frames = torch.as_tensor(visual, device=device).to(dtype)
    frames = frames.reshape((B * 2,) + tuple(frames.shape[2:]))
    if mixup_lambda is not None:
        mixup_lambda = torch.as_tensor(mixup_lambda, device=device)
    mel, new_state = H.mel_features(params["htsat"], state["htsat"], wave[:, 0], cfg.htsat,
                                    train=train, gen=gen if train else None,
                                    mixup_lambda=mixup_lambda)
    with torch.no_grad():
        tokens = H.run_tower(params["htsat"], H.tokens_from_mel(params["htsat"], mel, cfg.htsat),
                             cfg.htsat, kernels=kernels, gelu=gelu)
        vis_tokens = S.forward_features(params["swin"], frames, cfg.swin, kernels=kernels,
                                        gelu=gelu)
    f_a = tokens.mean(1)                                             # (B, 768)
    audio = audio_features(params, f_a.repeat_interleave(2, dim=0))  # (2B, d)
    logits = _grounding(params, audio, vis_tokens)[0]
    return (logits, {"htsat": new_state}) if train else logits
