"""DG-SCT PyTorch checkpoint -> the port's AVE or AVS parameter tree, in numpy.

The AVE and AVS parts of `dg_sct_tpu/utils/torch_convert.py`: a flat
`{name: np.ndarray}` state dict (`load_torch_file`) of the full AVE
`best_82.18.pt` MMIL_Net (timm swinv2 tower under `swin.`, HTS-AT under
`htsat.`, adapters and heads), of `HTSAT_AudioSet_Saved_1.ckpt` with its
`sed_model.` prefix stripped, or of the AVS S4 `Pred_endecoder`
(`convert_avs_model`, with its bypassed PVT-v2-b5 tower as a numpy tree
only) becomes the nested (params, state) tree of numpy arrays that
`weights.from_jax` carries onto the device and checks leaf by leaf. A
leading `module.` (nn.DataParallel) is stripped. `track` and
`census_report` account for every checkpoint key: consumed, ignored by
`AVE_CKPT_IGNORED_PATTERNS` (or `AVS_CKPT_IGNORED_PATTERNS`), or
unexplained.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def _t(x):  # torch Linear weight (out, in) -> (in, out)
    return np.ascontiguousarray(np.asarray(x).T)


class TrackedSD(dict):
    """State dict that records which ORIGINAL checkpoint keys the converters
    read, through `strip_prefix`/`subdict` renames: after a conversion,
    `accessed` holds every source key that was read, so `census_report` can
    hold the unread keys against the documented ignore-list."""

    def __init__(self, data, accessed=None, alias=None):
        super().__init__(data)
        self.accessed = accessed if accessed is not None else set()
        self.alias = alias or {}

    def _mark(self, k):
        self.accessed.add(self.alias.get(k, k))

    def __getitem__(self, k):
        self._mark(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if super().__contains__(k):
            return self[k]
        return default


def track(sd: Dict[str, np.ndarray]) -> TrackedSD:
    return sd if isinstance(sd, TrackedSD) else TrackedSD(sd)


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    out, alias = {}, {}
    for k, v in sd.items():
        nk = k[len(prefix):] if k.startswith(prefix) else k
        out[nk] = v
        if isinstance(sd, TrackedSD):
            alias[nk] = sd.alias.get(k, k)
    if isinstance(sd, TrackedSD):
        return TrackedSD(out, accessed=sd.accessed, alias=alias)
    return out


def subdict(sd, prefix: str):
    """Keys under `prefix`, with the prefix stripped (tracking preserved)."""
    out, alias = {}, {}
    for k, v in sd.items():
        if k.startswith(prefix):
            nk = k[len(prefix):]
            out[nk] = v
            if isinstance(sd, TrackedSD):
                alias[nk] = sd.alias.get(k, k)
    if isinstance(sd, TrackedSD):
        return TrackedSD(out, accessed=sd.accessed, alias=alias)
    return out


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    obj = torch.load(path, map_location="cpu")
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def convert_linear(sd, name):
    p = {"kernel": _t(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        p["bias"] = np.asarray(sd[f"{name}.bias"])
    return p


def convert_layernorm(sd, name):
    return {"scale": np.asarray(sd[f"{name}.weight"]), "bias": np.asarray(sd[f"{name}.bias"])}


def convert_batchnorm(sd, name):
    params = {"scale": np.asarray(sd[f"{name}.weight"]), "bias": np.asarray(sd[f"{name}.bias"])}
    state = {"mean": np.asarray(sd[f"{name}.running_mean"]),
             "var": np.asarray(sd[f"{name}.running_var"]),
             "count": np.asarray(sd.get(f"{name}.num_batches_tracked", 0), np.int32)}
    return params, state


def convert_patch_embed(sd, name):
    w = np.asarray(sd[f"{name}.proj.weight"])       # (E, C, P, P)
    p = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
         "bias": np.asarray(sd[f"{name}.proj.bias"])}
    if f"{name}.norm.weight" in sd:
        p["norm"] = convert_layernorm(sd, f"{name}.norm")
    return p


def convert_grouped_conv1x1(sd, name, groups):
    """torch Conv2d(C_in, C_out, 1, groups=g).weight (C_out, C_in/g, 1, 1)
    -> our (g, C_in/g, C_out/g)."""
    w = np.asarray(sd[f"{name}.weight"])[:, :, 0, 0]   # (C_out, C_in/g)
    c_out, gi = w.shape
    go = c_out // groups
    k = np.stack([w[g * go:(g + 1) * go].T for g in range(groups)])  # (g, gi, go)
    p = {"kernel": np.ascontiguousarray(k)}
    if f"{name}.bias" in sd:
        p["bias"] = np.asarray(sd[f"{name}.bias"])
    return p


def convert_mha(sd, name):
    return {"in_proj": {"kernel": _t(sd[f"{name}.in_proj_weight"]),
                        "bias": np.asarray(sd[f"{name}.in_proj_bias"])},
            "out_proj": convert_linear(sd, f"{name}.out_proj")}


def convert_lstm_dir(sd, name, suffix=""):
    return {"wi": _t(sd[f"{name}.weight_ih_l0{suffix}"]),
            "wh": _t(sd[f"{name}.weight_hh_l0{suffix}"]),
            "bi": np.asarray(sd[f"{name}.bias_ih_l0{suffix}"]),
            "bh": np.asarray(sd[f"{name}.bias_hh_l0{suffix}"])}


def convert_bilstm(sd, name):
    return {"fwd": convert_lstm_dir(sd, name),
            "bwd": convert_lstm_dir(sd, name, "_reverse")}


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

def infer_depths(sd) -> tuple:
    """Scan `layers.{s}.blocks.{b}.` keys to recover per-stage depths."""
    found: Dict[int, int] = {}
    for k in sd:
        m = re.match(r"layers\.(\d+)\.blocks\.(\d+)\.", k)
        if m:
            s, b = int(m.group(1)), int(m.group(2))
            found[s] = max(found.get(s, 0), b + 1)
    return tuple(found[s] for s in sorted(found))


def convert_swinv2(sd, depths=None):
    """timm swinv2 state dict (keys relative to the model root)."""
    depths = depths or infer_depths(sd)
    p = {"patch_embed": convert_patch_embed(sd, "patch_embed")}
    layers = []
    for s, depth in enumerate(depths):
        blocks = []
        for b in range(depth):
            pre = f"layers.{s}.blocks.{b}"
            blocks.append({
                "attn": {
                    "qkv": {"kernel": _t(sd[f"{pre}.attn.qkv.weight"])},
                    "q_bias": np.asarray(sd[f"{pre}.attn.q_bias"]),
                    "v_bias": np.asarray(sd[f"{pre}.attn.v_bias"]),
                    "logit_scale": np.asarray(sd[f"{pre}.attn.logit_scale"]),
                    "cpb_fc1": convert_linear(sd, f"{pre}.attn.cpb_mlp.0"),
                    "cpb_fc2": {"kernel": _t(sd[f"{pre}.attn.cpb_mlp.2.weight"])},
                    "proj": convert_linear(sd, f"{pre}.attn.proj"),
                },
                "norm1": convert_layernorm(sd, f"{pre}.norm1"),
                "mlp": {"fc1": convert_linear(sd, f"{pre}.mlp.fc1"),
                        "fc2": convert_linear(sd, f"{pre}.mlp.fc2")},
                "norm2": convert_layernorm(sd, f"{pre}.norm2"),
            })
        stage = {"blocks": blocks}
        if f"layers.{s}.downsample.reduction.weight" in sd:
            stage["downsample"] = {
                "reduction": {"kernel": _t(sd[f"layers.{s}.downsample.reduction.weight"])},
                "norm": convert_layernorm(sd, f"layers.{s}.downsample.norm"),
            }
        layers.append(stage)
    p["layers"] = layers
    p["norm"] = convert_layernorm(sd, "norm")
    return p


def convert_htsat(sd, depths=None):
    """HTSAT state dict (keys relative to the model root). Returns (params, state)."""
    depths = depths or infer_depths(sd)
    p = {"patch_embed": convert_patch_embed(sd, "patch_embed")}
    bn0_p, bn0_s = convert_batchnorm(sd, "bn0")
    p["bn0"] = bn0_p
    state = {"bn0": bn0_s}
    layers = []
    for s, depth in enumerate(depths):
        blocks = []
        for b in range(depth):
            pre = f"layers.{s}.blocks.{b}"
            blocks.append({
                "norm1": convert_layernorm(sd, f"{pre}.norm1"),
                "attn": {
                    "qkv": convert_linear(sd, f"{pre}.attn.qkv"),
                    "proj": convert_linear(sd, f"{pre}.attn.proj"),
                    "rpb_table": np.asarray(sd[f"{pre}.attn.relative_position_bias_table"]),
                },
                "norm2": convert_layernorm(sd, f"{pre}.norm2"),
                "mlp": {"fc1": convert_linear(sd, f"{pre}.mlp.fc1"),
                        "fc2": convert_linear(sd, f"{pre}.mlp.fc2")},
            })
        stage = {"blocks": blocks}
        if f"layers.{s}.downsample.reduction.weight" in sd:
            stage["downsample"] = {
                "norm": convert_layernorm(sd, f"layers.{s}.downsample.norm"),
                "reduction": {"kernel": _t(sd[f"layers.{s}.downsample.reduction.weight"])},
            }
        layers.append(stage)
    p["layers"] = layers
    p["norm"] = convert_layernorm(sd, "norm")
    if "tscam_conv.weight" in sd:
        w = np.asarray(sd["tscam_conv.weight"])  # (cls, C, SF, 3)
        p["tscam_conv"] = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                           "bias": np.asarray(sd["tscam_conv.bias"])}
        p["head"] = convert_linear(sd, "head")
    return p, state


def convert_adapter(sd, pre, groups=2):
    """One `VisualAdapter` (net_trans.py:433-550). Returns (params, state)."""
    w = np.asarray(sd[f"{pre}.conv_adapter.weight"])[:, :, 0, 0]  # (N_out, N_in)
    p = {
        "token_resample": {"kernel": _t(w), "bias": np.asarray(sd[f"{pre}.conv_adapter.bias"])},
        "chan_align": convert_linear(sd, f"{pre}.fc"),
        "latent_tokens": np.asarray(sd[f"{pre}.my_tokens"]),
        "gate_av": np.asarray(sd[f"{pre}.gate_av"]),
        "aff_audio_1": convert_linear(sd, f"{pre}.fc_affine_audio_1"),
        "aff_video_1": convert_linear(sd, f"{pre}.fc_affine_video_1"),
        "aff_bottleneck": convert_linear(sd, f"{pre}.fc_affine_bottleneck"),
        "aff_video_2": convert_linear(sd, f"{pre}.fc_affine_video_2"),
        "aff_audio_2": convert_linear(sd, f"{pre}.fc_affine_audio_2"),
        "aff_v_s_att": convert_linear(sd, f"{pre}.fc_affine_v_s_att"),
        "aff_v_c_att": convert_linear(sd, f"{pre}.fc_affine_v_c_att"),
        "down": convert_grouped_conv1x1(sd, f"{pre}.down_sampler", groups),
        "up": convert_grouped_conv1x1(sd, f"{pre}.up_sampler", groups),
    }
    if f"{pre}.gate" in sd:
        p["gate"] = np.asarray(sd[f"{pre}.gate"])
    state = {}
    if f"{pre}.bn1.weight" in sd:
        p["bn1"], state["bn1"] = convert_batchnorm(sd, f"{pre}.bn1")
        p["bn2"], state["bn2"] = convert_batchnorm(sd, f"{pre}.bn2")
    if f"{pre}.ln_before.weight" in sd:
        p["ln_before"] = convert_layernorm(sd, f"{pre}.ln_before")
    if f"{pre}.ln_post.weight" in sd:
        p["ln_post"] = convert_layernorm(sd, f"{pre}.ln_post")
    return p, state


def _enc_layer(sd, lp):
    return {"self_attn": convert_mha(sd, f"{lp}.self_attn"),
            "linear1": convert_linear(sd, f"{lp}.linear1"),
            "linear2": convert_linear(sd, f"{lp}.linear2"),
            "norm1": convert_layernorm(sd, f"{lp}.norm1"),
            "norm2": convert_layernorm(sd, f"{lp}.norm2")}


def _dec_layer(sd, lp):
    return {"self_attn": convert_mha(sd, f"{lp}.self_attn"),
            "multihead_attn": convert_mha(sd, f"{lp}.multihead_attn"),
            "linear1": convert_linear(sd, f"{lp}.linear1"),
            "linear2": convert_linear(sd, f"{lp}.linear2"),
            "norm1": convert_layernorm(sd, f"{lp}.norm1"),
            "norm2": convert_layernorm(sd, f"{lp}.norm2")}


def convert_temporal_attention(sd, pre="temporal_attn"):
    def enc(name, n_layers):
        return {"affine": convert_linear(sd, f"{pre}.{name}.affine_matrix"),
                "layers": [_enc_layer(sd, f"{pre}.{name}.encoder.layers.{i}")
                           for i in range(n_layers)]}

    def dec(name):
        return {"affine": convert_linear(sd, f"{pre}.{name}.affine_matrix"),
                "layers": [_dec_layer(sd, f"{pre}.{name}.decoder.layers.0")]}

    return {
        "v_fc": convert_linear(sd, f"{pre}.v_fc"),
        "a_fc": convert_linear(sd, f"{pre}.a_fc"),
        "audio_rnn": convert_bilstm(sd, f"{pre}.audio_visual_rnn_layer.audio_rnn"),
        "visual_rnn": convert_bilstm(sd, f"{pre}.audio_visual_rnn_layer.visual_rnn"),
        "video_encoder": enc("video_encoder", 2),
        "audio_encoder": enc("audio_encoder", 2),
        "video_decoder": dec("video_decoder"),
        "audio_decoder": dec("audio_decoder"),
        "audio_gated": convert_linear(sd, f"{pre}.audio_gated.0"),
        "video_gated": convert_linear(sd, f"{pre}.video_gated.0"),
    }


def convert_cmbs(sd, pre="CMBS"):
    def inter(name):
        return {"mha": convert_mha(sd, f"{pre}.{name}.video_multihead"),
                "norm1": convert_layernorm(sd, f"{pre}.{name}.norm1")}

    return {
        "AVInter": inter("AVInter"),
        "VAInter": inter("VAInter"),
        "video_cas": convert_linear(sd, f"{pre}.video_cas"),
        "audio_cas": convert_linear(sd, f"{pre}.audio_cas"),
        "localize_classifier": convert_linear(sd, f"{pre}.localize_module.classifier"),
        "localize_event": convert_linear(sd, f"{pre}.localize_module.event_classifier"),
    }


def convert_adapter_lists(sd, num_adapters=12, groups=2):
    """The four `{audio,vis}_adapter_blocks_p{1,2}` ModuleLists shared by
    every DG-SCT task tree. Returns (params, state) dicts of lists."""
    names = {"a_p1": "audio_adapter_blocks_p1", "v_p1": "vis_adapter_blocks_p1",
             "a_p2": "audio_adapter_blocks_p2", "v_p2": "vis_adapter_blocks_p2"}
    adapters, adapter_state = {}, {}
    for ours, theirs in names.items():
        ps, ss = [], []
        for i in range(num_adapters):
            p, s = convert_adapter(sd, f"{theirs}.{i}", groups)
            ps.append(p)
            ss.append(s)
        adapters[ours] = ps
        adapter_state[ours] = ss
    return adapters, adapter_state


def convert_ave_model(sd, num_adapters=12, groups=2):
    """Full MMIL_Net state dict -> (params, state)."""
    sd = strip_prefix(sd, "module.")
    swin = convert_swinv2(subdict(sd, "swin."))
    htsat, htsat_state = convert_htsat(subdict(sd, "htsat."))
    adapters, adapter_state = convert_adapter_lists(sd, num_adapters, groups)
    params = {
        "swin": swin,
        "htsat": htsat,
        "adapters": adapters,
        "temporal_attn": convert_temporal_attention(sd),
        "CMBS": convert_cmbs(sd),
    }
    state = {"htsat": htsat_state, "adapters": adapter_state}
    return params, state


# ---------------------------------------------------------------------------
# AVS: Pred_endecoder (`avs_s4/model/PVT_AVSModel.py:584-988`)
# ---------------------------------------------------------------------------

def convert_conv2d(sd, name):
    """torch Conv2d weight (O, I, kh, kw) -> (kh, kw, I, O); a depthwise one
    (C, 1, kh, kw) -> (kh, kw, 1, C)."""
    w = np.asarray(sd[f"{name}.weight"])
    p = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
    if f"{name}.bias" in sd:
        p["bias"] = np.asarray(sd[f"{name}.bias"])
    return p


def convert_conv3d_1x1(sd, name):
    """TPAVI's 1x1x1 Conv3d, a channel matmul -> linear params."""
    w = np.asarray(sd[f"{name}.weight"])[:, :, 0, 0, 0]
    return {"kernel": _t(w), "bias": np.asarray(sd[f"{name}.bias"])}


def convert_tpavi(sd, pre):
    """TPAVIModule ('dot', bn_layer=True; `avs_s4/model/TPAVI.py`). Returns
    (params, state)."""
    params = {
        "align_channel": convert_linear(sd, f"{pre}.align_channel"),
        "norm_layer": convert_layernorm(sd, f"{pre}.norm_layer"),
        "g": convert_conv3d_1x1(sd, f"{pre}.g"),
        "theta": convert_conv3d_1x1(sd, f"{pre}.theta"),
        "phi": convert_conv3d_1x1(sd, f"{pre}.phi"),
        # W_z = Sequential(Conv3d 1x1x1, BatchNorm3d)
        "W_z": convert_conv3d_1x1(sd, f"{pre}.W_z.0"),
    }
    params["bn"], bn_state = convert_batchnorm(sd, f"{pre}.W_z.1")
    return params, {"bn": bn_state}


def convert_avs_temporal_attention(sd, pre="temporal_attn", num_scales=4):
    """AVS 4-scale TemporalAttention: every sub-module a per-scale ModuleList."""
    def enc(name, i):
        return {"affine": convert_linear(sd, f"{pre}.{name}.{i}.affine_matrix"),
                "layers": [_enc_layer(sd, f"{pre}.{name}.{i}.encoder.layers.{j}")
                           for j in range(2)]}

    def dec(name, i):
        return {"affine": convert_linear(sd, f"{pre}.{name}.{i}.affine_matrix"),
                "layers": [_dec_layer(sd, f"{pre}.{name}.{i}.decoder.layers.0")]}

    scales = []
    for i in range(num_scales):
        rnn = f"{pre}.audio_visual_rnn_layer.{i}"
        scales.append({
            "v_fc": convert_linear(sd, f"{pre}.v_fc.{i}"),
            "audio_rnn": convert_bilstm(sd, f"{rnn}.audio_rnn"),
            "visual_rnn": convert_bilstm(sd, f"{rnn}.visual_rnn"),
            "video_encoder": enc("video_encoder", i),
            "audio_encoder": enc("audio_encoder", i),
            "video_decoder": dec("video_decoder", i),
            "audio_decoder": dec("audio_decoder", i),
            "audio_gated": convert_linear(sd, f"{pre}.audio_gated.{i}.0"),
            "video_gated": convert_linear(sd, f"{pre}.video_gated.{i}.0"),
        })
    return {"scales": scales}


def convert_pvt_v2(sd, depths=(3, 6, 40, 3)):
    """PVT-v2-b5 (`avs_s4/model/pvt.py`) -> the JAX package's `models/pvt.py`
    tree, in numpy only: the AVS checkpoint carries it under
    `encoder_backbone.`, and its forward is bypassed on the live path."""
    stages = []
    for s in range(len(depths)):
        blocks = []
        for b in range(depths[s]):
            pre = f"block{s + 1}.{b}"
            p = {"norm1": convert_layernorm(sd, f"{pre}.norm1"),
                 "q": convert_linear(sd, f"{pre}.attn.q"),
                 "kv": convert_linear(sd, f"{pre}.attn.kv"),
                 "proj": convert_linear(sd, f"{pre}.attn.proj"),
                 "norm2": convert_layernorm(sd, f"{pre}.norm2"),
                 "fc1": convert_linear(sd, f"{pre}.mlp.fc1"),
                 "dwconv": convert_conv2d(sd, f"{pre}.mlp.dwconv.dwconv"),
                 "fc2": convert_linear(sd, f"{pre}.mlp.fc2")}
            if f"{pre}.attn.sr.weight" in sd:
                p["sr"] = convert_conv2d(sd, f"{pre}.attn.sr")
                p["sr_norm"] = convert_layernorm(sd, f"{pre}.attn.norm")
            blocks.append(p)
        stages.append({
            "patch_embed": {"proj": convert_conv2d(sd, f"patch_embed{s + 1}.proj"),
                            "norm": convert_layernorm(sd, f"patch_embed{s + 1}.norm")},
            "blocks": blocks,
            "norm": convert_layernorm(sd, f"norm{s + 1}"),
        })
    return {"stages": stages}


def convert_avs_model(sd, num_adapters=12, groups=2, tpavi_stages=(0, 1, 2, 3)):
    """Full Pred_endecoder state dict -> (params, state, pvt): `pvt` is the
    bypassed `encoder_backbone.` PVT-v2-b5 tree, or None if the checkpoint
    lacks it."""
    sd = strip_prefix(sd, "module.")
    swin = convert_swinv2(subdict(sd, "swin."))
    htsat, htsat_state = convert_htsat(subdict(sd, "htsat."))
    adapters, adapter_state = convert_adapter_lists(sd, num_adapters, groups)
    conv_unit = lambda pre: {"conv1": convert_conv2d(sd, f"{pre}.conv1"),
                             "conv2": convert_conv2d(sd, f"{pre}.conv2")}
    params = {
        "swin": swin,
        "htsat": htsat,
        "adapters": adapters,
        # x{i}_linear_ are the live per-stage aligners; x{i}_linear are dead
        "scale_linears": [convert_linear(sd, f"x{i + 1}_linear_") for i in range(4)],
        "audio_linear": convert_linear(sd, "audio_linear"),
        "temporal_attn": convert_avs_temporal_attention(sd),
        "paths": [{"res1": conv_unit(f"path{i + 1}.resConfUnit1"),
                   "res2": conv_unit(f"path{i + 1}.resConfUnit2")} for i in range(4)],
        "out_conv1": convert_conv2d(sd, "output_conv.0"),
        "out_conv2": convert_conv2d(sd, "output_conv.2"),
        "out_conv3": convert_conv2d(sd, "output_conv.4"),
        "tpavi": {},
    }
    state = {"htsat": htsat_state, "adapters": adapter_state, "tpavi": {}}
    for i in tpavi_stages:
        name = f"tpavi_b{i + 1}"
        params["tpavi"][name], state["tpavi"][name] = convert_tpavi(sd, name)
    pvt = None
    if any(k.startswith("encoder_backbone.") for k in sd):
        pvt = convert_pvt_v2(subdict(sd, "encoder_backbone."))
    return params, state, pvt


# ---------------------------------------------------------------------------
# Census accounting: every key of the reference checkpoints is either
# consumed by the converters above or matches one of these documented
# ignore patterns (held against the key census of best_82.18.pt and
# HTSAT_AudioSet_Saved_1.ckpt in tests/golden/).
# ---------------------------------------------------------------------------

_SHARED_TOWER_IGNORED = (
    # deterministic coordinate/index grids, recomputed in ops/windows.py
    r"\.attn\.relative_coords_table$",
    r"\.attn\.relative_position_index$",
    # the 21841-class IN22k classifier head of the timm swin; DG-SCT drives
    # only the blocks (net_trans.py:894-914), never swin.forward/head
    r"^swin\.head\.",
    # frozen DSP bases (torchlibrosa): DFT conv weights and the slaney mel
    # filterbank, built exactly in ops/dsp.py
    r"spectrogram_extractor\.stft\.conv_(real|imag)\.weight$",
    r"logmel_extractor\.melW$",
    # adapter gate registered per VisualAdapter but unused in every task's
    # forward
    r"\.gate_tk$",
    # HTS-AT registers each block's shift mask as a buffer
    # (htsat.py:203-208); we recompute masks from (res, ws, shift)
    r"\.attn_mask$",
)

AVE_CKPT_IGNORED_PATTERNS = _SHARED_TOWER_IGNORED + (
    # registered in MMIL_Net.__init__ (net_trans.py:800-803) but never
    # called in any forward — dead trainable params in the checkpoint
    r"^adapter_token_downsampler\.",
    # CMBS registers LayerNorms it never calls (net_trans.py:264-265 defined,
    # absent from CMBS.forward 272-292)
    r"^CMBS\.(video|audio)_norm\.",
    # Encoder/Decoder keep the prototype layer as a registered attribute;
    # forward runs the deepcopy clones in `.layers` (models.py:24-37,54-66,
    # `self.layers = _get_clones(encoder_layer, N)`), so the prototype's
    # params are dead weight in the checkpoint
    r"^temporal_attn\.\w+\.(encoder_layer|decoder_layer)\.",
)

AVS_CKPT_IGNORED_PATTERNS = _SHARED_TOWER_IGNORED + (
    # the dead PVT-dim aligners and ASPP classifiers: the live path uses
    # x{i}_linear_ only (PVT_AVSModel.py:903,920 commented out)
    r"^x[1-4]_linear\.",
    r"^conv[1-4]\.conv2d_list\.",
    # temporal_gated is computed but its modulation is commented out
    r"\.temporal_gated\.",
    # per-scale Encoder/Decoder prototype layers (the clones run instead)
    r"^temporal_attn\.\w+\.\d+\.(encoder_layer|decoder_layer)\.",
)


def census_report(sd: TrackedSD, ignored=AVE_CKPT_IGNORED_PATTERNS):
    """After conversion from a `track()`-wrapped dict: classify every source
    key as consumed / ignored-by-doc / UNEXPLAINED. Returns a dict of lists;
    `unexplained` must be empty for a clean import."""
    pats = [re.compile(p) for p in ignored]
    consumed, ignored_keys, unexplained = [], [], []
    for k in sd:
        if k in sd.accessed:
            consumed.append(k)
        elif any(p.search(k) for p in pats):
            ignored_keys.append(k)
        else:
            unexplained.append(k)
    return {"consumed": consumed, "ignored": ignored_keys,
            "unexplained": unexplained}
