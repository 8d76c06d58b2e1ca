"""AVS 4-scale TemporalAttention head (`dg_sct_tpu/models/heads/avs.py`).

Each of the 4 scales (56, 28, 14, 7 at full width) pools its feature map,
runs per-scale BiLSTMs and two transformer encoders; a sigmoid audio gate
scales the map, and the mean of the 4 video gates scales the audio
feature. Dims generalize as channel / channel // 2 / channel, so tiny
configurations shrink coherently. The per-scale decoders are built (they
are in the checkpoint) and never called, as in the JAX package.

In training, each scale's `v` goes through dropout (0.2, as AVE's after
v_fc) drawn from an explicit generator; the encoder layers draw none, as
in the JAX package, whose AVS head passes them no rng.
"""
from __future__ import annotations

import torch

from ...ops.basic import Init, dropout, linear, linear_init
from ...ops.rnn import bilstm, bilstm_init
from . import ave as ave_heads

FFN = 1024
NUM_SCALES = 4


def _scale_params(init: Init, channel):
    d_model, audio_dim = channel, channel // 2
    enc = lambda in_dim: {"affine": linear_init(init, in_dim, d_model),
                          "layers": [ave_heads.init_encoder_layer(init, d_model, FFN)
                                     for _ in range(2)]}
    dec = lambda in_dim: {"affine": linear_init(init, in_dim, d_model),
                          "layers": [ave_heads.init_decoder_layer(init, d_model, FFN)]}
    return {
        "v_fc": linear_init(init, channel, channel),
        "audio_rnn": bilstm_init(init, audio_dim, audio_dim),
        "visual_rnn": bilstm_init(init, channel, channel),
        "video_encoder": enc(2 * channel),
        "audio_encoder": enc(2 * audio_dim),
        "video_decoder": dec(2 * channel),
        "audio_decoder": dec(2 * audio_dim),
        "audio_gated": linear_init(init, d_model, 1),
        "video_gated": linear_init(init, d_model, 1),
    }


def init_avs_temporal_attention(init: Init, channel=256):
    return {"scales": [_scale_params(init, channel) for _ in range(NUM_SCALES)]}


def _encode(p, x):
    x = linear(p["affine"], x)
    for lp in p["layers"]:
        x = ave_heads.encoder_layer(lp, x, nhead=4)
    return x


def avs_temporal_attention(params, feature_maps, audio_feature, *, num_frames=5, gamma=0.05,
                           train=False, gen=None):
    """feature_maps: 4 maps (B*T, H_i, W_i, C); audio_feature (B, T, C/2).
    Training with `gen`, a torch.Generator: dropout on each scale's `v`,
    scale by scale; without it, the eval computation. Returns (the gated
    maps, the gated audio (B*T, C/2))."""
    B, T = audio_feature.shape[0], num_frames
    new_maps, video_gates = [], []
    for p, fm in zip(params["scales"], feature_maps):
        v = torch.relu(linear(p["v_fc"], fm.mean((1, 2)).reshape(B, T, -1)))
        if gen is not None:
            v = dropout(gen, v, ave_heads.V_DROP, train)
        a_seq = bilstm(p["audio_rnn"], audio_feature).transpose(0, 1)     # (T, B, C)
        v_seq = bilstm(p["visual_rnn"], v).transpose(0, 1)                 # (T, B, 2C)
        audio_gate = torch.sigmoid(linear(p["audio_gated"], _encode(p["audio_encoder"], a_seq)))
        video_gate = torch.sigmoid(linear(p["video_gated"], _encode(p["video_encoder"], v_seq)))
        ag = audio_gate.transpose(0, 1).reshape(B * T, 1, 1, 1)
        new_maps.append(fm + ag * fm * gamma)
        video_gates.append(video_gate.transpose(0, 1).reshape(B * T, 1))
    vg = sum(video_gates) / 4.0
    audio_flat = audio_feature.reshape(B * T, -1)
    return new_maps, audio_flat + vg * audio_flat * gamma
