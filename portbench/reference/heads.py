"""The plain float32 heads in eval: DG-SCT's AVE head (the temporal
attention of BiLSTMs and a small cross-modal transformer, then CMBS) and
its AVS decoder (the 4-scale temporal attention, TPAVI, the FPN of
residual convolutions), with the whole forward of each model."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import params as P
from .towers import (batch_norm, encoder, frames_in, init_adapters, init_htsat, init_swin,
                     interpolate, layer_norm, linear, wave_in)

D_MODEL, V_FC, A_FC, FFN = 256, 512, 128, 1024


def _encoder_layer(init, d):
    return {"self_attn": P.mha(init, d), "linear1": P.linear(init, d, FFN),
            "linear2": P.linear(init, FFN, d), "norm1": P.layer_norm(init, d),
            "norm2": P.layer_norm(init, d)}


def _decoder_layer(init, d):
    return {"self_attn": P.mha(init, d), "multihead_attn": P.mha(init, d),
            "linear1": P.linear(init, d, FFN), "linear2": P.linear(init, FFN, d),
            "norm1": P.layer_norm(init, d), "norm2": P.layer_norm(init, d)}


def init_ave(init, cfg):
    """(params, state) of the AVE model, in the release's tree."""
    htsat, htsat_state = init_htsat(init, cfg.htsat)
    adapters, adapter_state = init_adapters(init, cfg)
    enc = lambda i: {"affine": P.linear(init, i, D_MODEL),
                     "layers": [_encoder_layer(init, D_MODEL) for _ in range(2)]}
    dec = lambda i: {"affine": P.linear(init, i, D_MODEL),
                     "layers": [_decoder_layer(init, D_MODEL)]}
    ta = {"v_fc": P.linear(init, cfg.swin.num_features, V_FC),
          "a_fc": P.linear(init, cfg.htsat.num_features, A_FC),
          "audio_rnn": P.lstm(init, A_FC, D_MODEL // 2),
          "visual_rnn": P.lstm(init, V_FC, D_MODEL),
          "video_encoder": enc(V_FC), "audio_encoder": enc(D_MODEL),
          "video_decoder": dec(V_FC), "audio_decoder": dec(D_MODEL),
          "audio_gated": P.linear(init, D_MODEL, 1), "video_gated": P.linear(init, D_MODEL, 1)}
    inter = lambda: {"mha": P.mha(init, D_MODEL), "norm1": P.layer_norm(init, D_MODEL)}
    cmbs = {"AVInter": inter(), "VAInter": inter(),
            "video_cas": P.linear(init, D_MODEL, cfg.num_classes),
            "audio_cas": P.linear(init, D_MODEL, cfg.num_classes),
            "localize_classifier": P.linear(init, D_MODEL, 1),
            "localize_event": P.linear(init, D_MODEL, cfg.num_classes)}
    params = {"swin": init_swin(init, cfg.swin), "htsat": htsat, "adapters": adapters,
              "temporal_attn": ta, "CMBS": cmbs}
    return params, {"htsat": htsat_state, "adapters": adapter_state}


# ---------------------------------------------------------------------------
# sequence ops, time-major (T, B, E) as torch's nn.Transformer layers
# ---------------------------------------------------------------------------

def lstm(p, x, reverse=False):
    """torch's LSTM cell (gates i, f, g, o) over x (B, T, D) -> (B, T, H)."""
    H = p["wh"].shape[0]
    xp = x @ p["wi"] + p["bi"] + p["bh"]
    h = c = x.new_zeros(x.shape[0], H)
    out = [None] * x.shape[1]
    for t in reversed(range(x.shape[1])) if reverse else range(x.shape[1]):
        i, f, g, o = (xp[:, t] + h @ p["wh"]).split(H, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out, 1)


def bilstm(p, x):
    return torch.cat([lstm(p["fwd"], x), lstm(p["bwd"], x, reverse=True)], -1)


def mha(p, q, k, v, heads=4):
    Tq, B, E = q.shape
    w, b = p["in_proj"]["kernel"], p["in_proj"]["bias"]
    proj = lambda x, i: (x @ w[:, i * E:(i + 1) * E] + b[i * E:(i + 1) * E]).reshape(
        x.shape[0], B, heads, E // heads).permute(1, 2, 0, 3)
    att = torch.softmax(proj(q, 0) @ proj(k, 1).transpose(-1, -2) / math.sqrt(E // heads), -1)
    out = att @ proj(v, 2)
    return linear(p["out_proj"], out.permute(2, 0, 1, 3).reshape(Tq, B, E))


def encoder_layer(p, x):
    x = layer_norm(p["norm1"], x + mha(p["self_attn"], x, x, x))
    return layer_norm(p["norm2"], x + linear(p["linear2"], torch.relu(linear(p["linear1"], x))))


def decoder_layer(p, tgt, memory):
    """The release's decoder layer: cross-attention over cat(memory, tgt)."""
    mem = torch.cat([memory, tgt], 0)
    x = layer_norm(p["norm1"], tgt + mha(p["multihead_attn"], tgt, mem, mem))
    return layer_norm(p["norm2"], x + linear(p["linear2"], torch.relu(linear(p["linear1"], x))))


def _encode(p, x):
    x = linear(p["affine"], x)
    for lp in p["layers"]:
        x = encoder_layer(lp, x)
    return x


def _decode(p, tgt, memory):
    tgt = linear(p["affine"], tgt)
    for lp in p["layers"]:
        tgt = decoder_layer(lp, tgt, memory)
    return tgt


# ---------------------------------------------------------------------------
# AVE
# ---------------------------------------------------------------------------

def ave_forward(params, state, wave_i16, frames_u8, cfg):
    """wave (B, T, L) int16, frames (B, T, H, W, 3) uint8 ->
    {"event_scores" (B, classes), "is_event_scores" (B, T)}."""
    B, T = wave_i16.shape[:2]
    feats = encoder(params, state, wave_in(wave_i16).flatten(0, 1),
                    frames_in(frames_u8).flatten(0, 1), cfg)
    f_v, f_a = feats["f_v"].reshape(B, T, -1), feats["f_a"].reshape(B, T, -1)
    ta, cm = params["temporal_attn"], params["CMBS"]
    a = linear(ta["a_fc"], f_a)
    v = torch.relu(linear(ta["v_fc"], f_v))
    a_seq = bilstm(ta["audio_rnn"], a).transpose(0, 1)
    v_seq = bilstm(ta["visual_rnn"], v).transpose(0, 1)
    video_kv = _encode(ta["video_encoder"], v_seq)
    audio_q = _decode(ta["audio_decoder"], a_seq, video_kv)
    audio_kv = _encode(ta["audio_encoder"], a_seq)
    video_q = _decode(ta["video_decoder"], v_seq, audio_kv)
    audio_gate = torch.sigmoid(linear(ta["audio_gated"], audio_kv))
    video_gate = torch.sigmoid(linear(ta["video_gated"], video_kv))
    video_q = video_q + audio_gate * video_q * 0.1
    audio_q = audio_q + video_gate * audio_q * 0.1

    k = min(4, T)
    score_v = torch.topk(linear(cm["video_cas"], video_q).permute(1, 2, 0), k, -1).values.mean(-1)
    score_a = torch.topk(linear(cm["audio_cas"], audio_q).permute(1, 2, 0), k, -1).values.mean(-1)
    fused = 0.5 * (video_q + audio_q)
    is_event = linear(cm["localize_classifier"], fused)[..., 0].transpose(0, 1)
    event = linear(cm["localize_event"], fused.amax(0)) + 0.3 * 0.5 * (score_v + score_a)
    return {"event_scores": event, "is_event_scores": is_event}


# ---------------------------------------------------------------------------
# AVS
# ---------------------------------------------------------------------------

def init_avs(init, cfg):
    """(params, state) of the AVS model, in the release's tree."""
    htsat, htsat_state = init_htsat(init, cfg.htsat)
    adapters, adapter_state = init_adapters(init, cfg)
    ch = cfg.channel
    enc = lambda i: {"affine": P.linear(init, i, ch),
                     "layers": [_encoder_layer(init, ch) for _ in range(2)]}
    dec = lambda i: {"affine": P.linear(init, i, ch), "layers": [_decoder_layer(init, ch)]}
    scale = lambda: {"v_fc": P.linear(init, ch, ch), "audio_rnn": P.lstm(init, ch // 2, ch // 2),
                     "visual_rnn": P.lstm(init, ch, ch), "video_encoder": enc(2 * ch),
                     "audio_encoder": enc(ch), "video_decoder": dec(2 * ch),
                     "audio_decoder": dec(ch), "audio_gated": P.linear(init, ch, 1),
                     "video_gated": P.linear(init, ch, 1)}
    rcu = lambda: {"conv1": P.conv(init, 3, ch, ch), "conv2": P.conv(init, 3, ch, ch)}
    if cfg.tpavi_vv_flag or not cfg.tpavi_va_flag:
        raise ValueError("the reference runs TPAVI with audio keys only (va on, vv off)")
    params = {"swin": init_swin(init, cfg.swin), "htsat": htsat, "adapters": adapters,
              "scale_linears": [P.linear(init, cfg.swin.stage_dim(i), ch) for i in range(4)],
              "audio_linear": P.linear(init, cfg.htsat.num_features, ch // 2),
              "temporal_attn": {"scales": [scale() for _ in range(4)]},
              "paths": [{"res1": rcu(), "res2": rcu()} for _ in range(4)],
              "out_conv1": P.conv(init, 3, ch, 128), "out_conv2": P.conv(init, 3, 128, 32),
              "out_conv3": P.conv(init, 1, 32, 1), "tpavi": {}}
    state = {"htsat": htsat_state, "adapters": adapter_state, "tpavi": {}}
    for i in cfg.tpavi_stages:
        inter = ch // 2
        bn, bn_state = P.batch_norm(init, ch, scale=(0.5, 1.5))
        params["tpavi"][f"tpavi_b{i + 1}"] = {
            "align_channel": P.linear(init, ch // 2, ch), "norm_layer": P.layer_norm(init, ch),
            "g": P.linear(init, ch, inter), "theta": P.linear(init, ch, inter),
            "phi": P.linear(init, ch, inter), "W_z": P.linear(init, inter, ch), "bn": bn}
        state["tpavi"][f"tpavi_b{i + 1}"] = {"bn": bn_state}
    return params, state


def conv(p, x):
    """A stride-1 convolution with 'same' padding on (N, H, W, C)."""
    w = p["kernel"].permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["bias"], padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def _rcu(p, x):
    return conv(p["conv2"], torch.relu(conv(p["conv1"], torch.relu(x)))) + x


def _fusion(p, x, skip=None):
    if skip is not None:
        x = x + _rcu(p["res1"], skip)
    x = _rcu(p["res2"], x)
    return interpolate(x, (2 * x.shape[1], 2 * x.shape[2]), "bilinear", True)


def tpavi(p, s, x, audio):
    """TPAVI in 'dot' mode with audio keys: x (B, T, H, W, C), audio
    (B, T, C/2) -> LN(x + BN(W_z(softmax-free attention)))."""
    B, T, H, W, C = x.shape
    n = T * H * W
    a = linear(p["align_channel"], audio)
    phi = linear(p["phi"], a)[:, :, None, None].expand(B, T, H, W, -1).reshape(B, n, -1)
    theta = linear(p["theta"], x).reshape(B, n, -1)
    g = linear(p["g"], x).reshape(B, n, -1)
    y = ((theta @ phi.transpose(1, 2)) / n) @ g
    z = linear(p["W_z"], y.reshape(B, T, H, W, -1))
    z = batch_norm(p["bn"], s["bn"], z)
    return layer_norm(p["norm_layer"], z + x)


def avs_forward(params, state, wave_i16, frames_u8, cfg):
    """wave (B, T, L) int16, frames (B, T, 224, 224, 3) uint8 ->
    {"masks": (B, T, 224, 224) logits}."""
    B, T = frames_u8.shape[:2]
    imgs = interpolate(frames_in(frames_u8).flatten(0, 1), (cfg.swin.img_size,) * 2, "bicubic",
                       False)
    feats = encoder(params, state, wave_in(wave_i16).flatten(0, 1), imgs, cfg, taps=True)
    audio = linear(params["audio_linear"], feats["f_a"][:, 0].reshape(B, T, -1))
    maps = []
    for i, tap in enumerate(feats["taps"]):
        r = cfg.swin.stage_resolution(i)[0]
        x = linear(params["scale_linears"][i], tap.reshape(-1, r, r, tap.shape[-1]))
        maps.append(interpolate(x, (cfg.scale_sizes[i],) * 2, "bicubic", False))

    gated, video_gates = [], []
    for p, fm in zip(params["temporal_attn"]["scales"], maps):
        v = torch.relu(linear(p["v_fc"], fm.mean((1, 2)).reshape(B, T, -1)))
        a_seq = bilstm(p["audio_rnn"], audio).transpose(0, 1)
        v_seq = bilstm(p["visual_rnn"], v).transpose(0, 1)
        ag = torch.sigmoid(linear(p["audio_gated"], _encode(p["audio_encoder"], a_seq)))
        vg = torch.sigmoid(linear(p["video_gated"], _encode(p["video_encoder"], v_seq)))
        gated.append(fm + ag.transpose(0, 1).reshape(B * T, 1, 1, 1) * fm * 0.05)
        video_gates.append(vg.transpose(0, 1).reshape(B * T, 1))
    audio = audio.reshape(B * T, -1)
    audio = audio + sum(video_gates) / 4.0 * audio * 0.05
    maps = gated
    for i in cfg.tpavi_stages:
        name = f"tpavi_b{i + 1}"
        x5 = maps[i].reshape((B, T) + tuple(maps[i].shape[1:]))
        maps[i] = tpavi(params["tpavi"][name], state["tpavi"][name], x5,
                        audio.reshape(B, T, -1)).reshape(maps[i].shape)

    paths = params["paths"]
    y = _fusion(paths[3], maps[3])
    y = _fusion(paths[2], y, maps[2])
    y = _fusion(paths[1], y, maps[1])
    y = _fusion(paths[0], y, maps[0])
    y = conv(params["out_conv1"], y)
    y = interpolate(y, (cfg.mask_size,) * 2, "bilinear", False)
    y = conv(params["out_conv3"], torch.relu(conv(params["out_conv2"], y)))
    return {"masks": y[..., 0].reshape(B, T, cfg.mask_size, cfg.mask_size)}


MODELS = {"ave": (init_ave, ave_forward), "avs": (init_avs, avs_forward)}
