"""AVS segmentation model (`dg_sct_tpu/models/avs.py`, DG-SCT's
`Pred_endecoder`): (images (B, T, 224, 224, 3), wave (B, T, L)) -> mask
logits (B*T, 224, 224, 1).

224x224 frames are resized bicubically to 192 on the device, the
interleaved towers return one visual tap a stage, each tap goes to
`channel` by a linear and onto the decoder's grid (56/28/14/7) by a bicubic
resize, the 4-scale temporal head gates the maps, TPAVI attends each map to
the audio, and an FPN of residual 3x3 convolutions with 2x bilinear
upsampling decodes the mask. Channels-last throughout. DG-SCT's PVT-v2 and
VGGish towers are bypassed on this path and not built.
"""
from __future__ import annotations

import torch

from ..configs import AVSModelConfig
from ..device import resolve_device
from ..ops import dsp
from ..ops.basic import GELU_MODES, Init, conv2d, conv2d_init, linear, linear_init, seeded_init
from ..utils.profiling import span
from . import htsat as H
from . import interleave as I
from . import swinv2 as S
from . import tpavi as TP
from .ave import cast_for_compute
from .heads import avs as avs_head


def init_residual_conv_unit(init: Init, ch):
    return {"conv1": conv2d_init(init, 3, 3, ch, ch), "conv2": conv2d_init(init, 3, 3, ch, ch)}


def residual_conv_unit(params, x):
    out = conv2d(params["conv1"], torch.relu(x))
    return conv2d(params["conv2"], torch.relu(out)) + x


def init_feature_fusion_block(init: Init, ch):
    return {"res1": init_residual_conv_unit(init, ch), "res2": init_residual_conv_unit(init, ch)}


def feature_fusion_block(params, x, skip=None):
    """Optional skip through a residual unit added, a residual unit, then
    2x bilinear upsampling with align_corners=True."""
    out = x if skip is None else x + residual_conv_unit(params["res1"], skip)
    out = residual_conv_unit(params["res2"], out)
    return dsp.resize_2d(out, 2 * out.shape[1], 2 * out.shape[2], kernel="linear",
                         align_corners=True)


def init_avs_model(cfg: AVSModelConfig, *, seed: int = 0, device=None):
    """Random float32 (params, state) with the JAX package's tree, from a
    torch.Generator seeded with `seed`, on `device` (None: the card). On
    device "meta" it builds shapes only."""
    init = seeded_init(seed, device)
    htsat_params, htsat_state = H.init_htsat(init, cfg.htsat)
    adapter_params, adapter_state = I.init_adapters(init, cfg)
    ch = cfg.channel
    params = {
        "swin": S.init_swinv2(init, cfg.swin),
        "htsat": htsat_params,
        "adapters": adapter_params,
        "scale_linears": [linear_init(init, cfg.swin.stage_dim(i), ch) for i in range(4)],
        "audio_linear": linear_init(init, cfg.htsat.num_features, ch // 2),
        "temporal_attn": avs_head.init_avs_temporal_attention(init, ch),
        "paths": [init_feature_fusion_block(init, ch) for _ in range(4)],
        "out_conv1": conv2d_init(init, 3, 3, ch, 128),
        "out_conv2": conv2d_init(init, 3, 3, 128, 32),
        "out_conv3": conv2d_init(init, 1, 1, 32, 1),
        "tpavi": {},
    }
    state = {"htsat": htsat_state, "adapters": adapter_state, "tpavi": {}}
    for i in cfg.tpavi_stages:
        name = f"tpavi_b{i + 1}"
        params["tpavi"][name], state["tpavi"][name] = TP.init_tpavi(init, ch)
    return params, state


def forward(params, state, images, wave, cfg: AVSModelConfig, *, train=False, kernels=True,
            int8_attn=False, gelu="exact", device=None, gen=None, mixup_lambda=None,
            remat_policy="full", group=None):
    """images: (B, T, H, W, 3) at `mask_size`; wave: (B, T, L); tensors or
    arrays, moved to `device` (None: the card), where `params` must lie.
    `kernels`, `int8_attn` and `gelu` as `models.ave.forward` takes them (the
    AVS-variant adapters never run K3, as in the JAX package). Outputs:
    {"pred" (B*T, mask_size, mask_size, 1) logits, "feature_map_list" (the 4
    maps after TPAVI), "a_fea_list" (the aligned audio (B, T, channel) of
    each TPAVI stage, else None)}.

    Eval returns the outputs. `train=True` returns (outputs, new state): bn0
    and each TPAVI BN on the batch's statistics, their new running stats in
    the new state, and no kernel, whatever `kernels` says; `gen`, a
    torch.Generator on `device`, draws SpecAugment, drop_path and the head's
    dropout (None: none of them); `mixup_lambda` (B*T,) mixes the log-mel
    maps; `remat_policy` is the interleave's checkpointing ("full", "dots"
    or "none"); TPAVI and the decoder keep their activations, as in the JAX
    package; `group`, data parallelism over this rank's rows of the global
    batch (`models.ave.forward`), TPAVI's BNs included."""
    if gelu not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu!r} not in {GELU_MODES}")
    device = resolve_device(device)
    params = cast_for_compute(params, cfg.compute_dtype)
    dtype = params["swin"]["patch_embed"]["kernel"].dtype
    images = torch.as_tensor(images, device=device).to(dtype)
    wave = torch.as_tensor(wave, device=device)
    if cfg.compute_dtype != torch.float32:
        wave = wave.to(cfg.compute_dtype)
    if mixup_lambda is not None:
        mixup_lambda = torch.as_tensor(mixup_lambda, device=device)
    gen = gen if train else None
    B, T = images.shape[0], images.shape[1]
    with span("dgsct.model.towers"):
        imgs = dsp.resize_2d(images.reshape((B * T,) + tuple(images.shape[2:])),
                             cfg.swin.img_size, cfg.swin.img_size, kernel="cubic",
                             align_corners=False)
        feats, new_state = I.forward(params, state, wave.reshape(B * T, -1), imgs, cfg,
                                     kernels=kernels and not train, int8_attn=int8_attn, gelu=gelu,
                                     train=train, gen=gen, mixup_lambda=mixup_lambda,
                                     remat_policy=remat_policy, return_stage_taps=True,
                                     group=group)

    with span("dgsct.model.heads"):
        audio_feature = linear(params["audio_linear"], feats["f_a"][:, 0, :].reshape(B, T, -1))
        maps = []
        for i, tap in enumerate(feats["stage_taps"]):
            r = cfg.swin.stage_resolution(i)[0]
            x = linear(params["scale_linears"][i], tap.reshape(tap.shape[0], r, r, -1))
            sz = cfg.scale_sizes[i]
            maps.append(dsp.resize_2d(x, sz, sz, kernel="cubic", align_corners=False))
        maps, audio_flat = avs_head.avs_temporal_attention(params["temporal_attn"], maps,
                                                           audio_feature, num_frames=T,
                                                           train=train, gen=gen)

        a_fea_list = [None] * 4
        new_state["tpavi"] = dict(state["tpavi"])
        for i in cfg.tpavi_stages:
            name = f"tpavi_b{i + 1}"
            x5 = maps[i].reshape((B, T) + tuple(maps[i].shape[1:]))
            acc, count = torch.zeros_like(maps[i]), 0
            # with both flags, each call starts from the old BN state and the
            # audio one's update is kept, as in the JAX package
            if cfg.tpavi_vv_flag:
                z, _, new_state["tpavi"][name] = TP.tpavi(params["tpavi"][name],
                                                          state["tpavi"][name], x5, None,
                                                          train=train, group=group)
                acc, count = acc + z.reshape(maps[i].shape), count + 1
            if cfg.tpavi_va_flag:
                z, a_fea_list[i], new_state["tpavi"][name] = TP.tpavi(
                    params["tpavi"][name], state["tpavi"][name], x5, audio_flat.reshape(B, T, -1),
                    train=train, group=group)
                acc, count = acc + z.reshape(maps[i].shape), count + 1
            maps[i] = acc / count

        paths = params["paths"]  # path4 (7 -> 14) first, path1 (56 -> 112) last
        y = feature_fusion_block(paths[3], maps[3])
        y = feature_fusion_block(paths[2], y, maps[2])
        y = feature_fusion_block(paths[1], y, maps[1])
        y = feature_fusion_block(paths[0], y, maps[0])
        y = conv2d(params["out_conv1"], y)
        y = dsp.resize_2d(y, cfg.mask_size, cfg.mask_size, kernel="linear", align_corners=False)
        y = torch.relu(conv2d(params["out_conv2"], y))
        pred = conv2d(params["out_conv3"], y)
    out = {"pred": pred, "feature_map_list": maps, "a_fea_list": a_fea_list}
    return (out, new_state) if train else out
