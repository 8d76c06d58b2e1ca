"""HF `transformers` checkpoints onto the port's trees, in numpy: Swin-V2
(`swinv2_from_transformers`, e.g. microsoft/swinv2-large-patch4-window12-192-22k),
CLIP (`clip_from_transformers`, e.g. openai/clip-vit-base-patch32) and PVT-v2
(`pvt_v2_from_transformers`). Each takes a state dict (a mapping of numpy
arrays or tensors) or a model with `.state_dict()`; none imports
`transformers`. `weights.from_jax_tree` (or `from_jax` for a whole model)
carries the result onto the device.
"""
from __future__ import annotations

import numpy as np

from .torch_convert import convert_conv2d as _conv
from .torch_convert import convert_layernorm as _ln
from .torch_convert import convert_linear as _lin
from .torch_convert import numpy_state


def _npify(hf):
    return numpy_state(hf.state_dict() if hasattr(hf, "state_dict") else hf)


def swinv2_from_transformers(hf, cfg):
    """A `transformers.Swinv2Model` -> the `models/swinv2.py` tree; `cfg`,
    the port's SwinV2Config, matches HF's (image, patch, depths, heads,
    window)."""
    sd = _npify(hf)
    p = {"patch_embed": dict(_conv(sd, "embeddings.patch_embeddings.projection"),
                             norm=_ln(sd, "embeddings.norm")),
         "norm": _ln(sd, "layernorm"),
         "layers": []}
    for s in range(cfg.num_layers):
        blocks = []
        for d in range(cfg.depths[s]):
            b = f"encoder.layers.{s}.blocks.{d}."
            a = b + "attention.self."
            qkv = np.concatenate([sd[a + f"{n}.weight"].T for n in ("query", "key", "value")],
                                 axis=1)
            blocks.append({
                "attn": {"qkv": {"kernel": qkv},
                         "q_bias": sd[a + "query.bias"],
                         "v_bias": sd[a + "value.bias"],
                         "logit_scale": sd[a + "logit_scale"],
                         "cpb_fc1": _lin(sd, a + "continuous_position_bias_mlp.0"),
                         "cpb_fc2": _lin(sd, a + "continuous_position_bias_mlp.2"),
                         "proj": _lin(sd, b + "attention.output.dense")},
                "norm1": _ln(sd, b + "layernorm_before"),
                "mlp": {"fc1": _lin(sd, b + "intermediate.dense"),
                        "fc2": _lin(sd, b + "output.dense")},
                "norm2": _ln(sd, b + "layernorm_after")})
        stage = {"blocks": blocks}
        dkey = f"encoder.layers.{s}.downsample."
        if dkey + "reduction.weight" in sd:
            stage["downsample"] = {"reduction": _lin(sd, dkey + "reduction"),
                                   "norm": _ln(sd, dkey + "norm")}
        p["layers"].append(stage)
    return p


def _clip_resblock(sd, pre):
    att = pre + "self_attn."
    names = ("q_proj", "k_proj", "v_proj")
    return {"ln_1": _ln(sd, pre + "layer_norm1"),
            "attn": {"in_proj": {"kernel": np.concatenate([sd[f"{att}{n}.weight"].T
                                                           for n in names], axis=1),
                                 "bias": np.concatenate([sd[f"{att}{n}.bias"] for n in names])},
                     "out_proj": _lin(sd, att + "out_proj")},
            "ln_2": _ln(sd, pre + "layer_norm2"),
            "mlp": {"c_fc": _lin(sd, pre + "mlp.fc1"), "c_proj": _lin(sd, pre + "mlp.fc2")}}


def clip_from_transformers(hf, cfg):
    """A `transformers.CLIPModel` -> (visual params, text params) of
    `models/clip.py`; `cfg`, the port's CLIPConfig, matches HF's."""
    sd = _npify(hf)
    vp = {"conv1": _conv(sd, "vision_model.embeddings.patch_embedding"),
          "class_embedding": sd["vision_model.embeddings.class_embedding"],
          "positional_embedding": sd["vision_model.embeddings.position_embedding.weight"],
          "ln_pre": _ln(sd, "vision_model.pre_layrnorm"),
          "resblocks": [_clip_resblock(sd, f"vision_model.encoder.layers.{i}.")
                        for i in range(cfg.vision_layers)],
          "ln_post": _ln(sd, "vision_model.post_layernorm"),
          "proj": np.ascontiguousarray(sd["visual_projection.weight"].T)}
    tp = {"token_embedding": sd["text_model.embeddings.token_embedding.weight"],
          "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
          "resblocks": [_clip_resblock(sd, f"text_model.encoder.layers.{i}.")
                        for i in range(cfg.text_layers)],
          "ln_final": _ln(sd, "text_model.final_layer_norm"),
          "text_projection": np.ascontiguousarray(sd["text_projection.weight"].T),
          "logit_scale": np.float32(sd["logit_scale"])}
    return vp, tp


def pvt_v2_from_transformers(hf, depths):
    """A `transformers.PvtV2Model` -> the `models/pvt.py` tree. HF splits
    the reference's fused `kv` projection into key and value linears; the
    fused columns are [key | value]."""
    sd = _npify(hf)

    stages = []
    for s in range(len(depths)):
        lpre = f"encoder.layers.{s}"
        blocks = []
        for b in range(depths[s]):
            bpre = f"{lpre}.blocks.{b}"
            a = bpre + ".attention"
            p = {"norm1": _ln(sd, bpre + ".layer_norm_1"),
                 "q": _lin(sd, a + ".query"),
                 "kv": {"kernel": np.concatenate([sd[a + ".key.weight"].T,
                                                  sd[a + ".value.weight"].T], axis=1),
                        "bias": np.concatenate([sd[a + ".key.bias"], sd[a + ".value.bias"]])},
                 "proj": _lin(sd, a + ".proj"),
                 "norm2": _ln(sd, bpre + ".layer_norm_2"),
                 "fc1": _lin(sd, bpre + ".mlp.dense1"),
                 "dwconv": _conv(sd, bpre + ".mlp.dwconv.dwconv"),
                 "fc2": _lin(sd, bpre + ".mlp.dense2")}
            if a + ".spatial_reduction.weight" in sd:
                p["sr"] = _conv(sd, a + ".spatial_reduction")
                p["sr_norm"] = _ln(sd, a + ".layer_norm")
            blocks.append(p)
        stages.append({"patch_embed": {"proj": _conv(sd, lpre + ".patch_embedding.proj"),
                                       "norm": _ln(sd, lpre + ".patch_embedding.layer_norm")},
                       "blocks": blocks,
                       "norm": _ln(sd, lpre + ".layer_norm")})
    return {"stages": stages}
