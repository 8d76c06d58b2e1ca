"""The reference's dormant AVE modules (no live call site) over the JAX
package's trees (`dg_sct_tpu/models/legacy.py`):

  * CAS_Module, a 1x1 convolution classifier over time;
  * WeaklyLocalizationModule;
  * AudioVisualContrastive, the cross-batch audio-visual match scorer, its
    nested per-pair loop as einsums;
  * AudioVisualAdapter;
  * New_Audio_Guided_Attention.

Built on the AVE head's encoder layer (`heads/ave.encoder_layer`) and
`ops/rnn.bilstm`. Where the dead torch code would fail if it ran
(AudioVisualAdapter), the port runs what the JAX package runs: the evident
intent, described at the function.
"""
from __future__ import annotations

import torch

from ..ops.basic import Init, dropout, layer_norm, layer_norm_init, linear, linear_init
from ..ops.rnn import bilstm, bilstm_init
from .heads.ave import encoder_layer, init_encoder_layer


# ---------------------------------------------------------------------------
# CAS_Module
# ---------------------------------------------------------------------------

def init_cas_module(init: Init, d_model, num_class=28):
    """Conv1d(d_model -> num_class + 1, k=1, no bias), a pointwise linear."""
    return {"classifier": linear_init(init, d_model, num_class + 1, bias=False)}


def cas_module(params, content):
    """content (B, T, d_model) -> (B, T, num_class + 1)."""
    return linear(params["classifier"], content)


# ---------------------------------------------------------------------------
# WeaklyLocalizationModule
# ---------------------------------------------------------------------------

def init_weakly_localization(init: Init, input_dim):
    return {"classifier": linear_init(init, input_dim, 1),
            "event_classifier": linear_init(init, input_dim, 29)}


def weakly_localization(params, fused_content):
    """fused_content time-major (T, B, D), as the reference feeds it ->
    (is_event_scores (B, T), raw_logits (B, 29), event_scores (B, 29))."""
    x = fused_content.transpose(0, 1)
    is_event_scores = linear(params["classifier"], x)[..., 0]
    raw_logits = linear(params["event_classifier"], x.amax(1))
    fused = torch.sigmoid(is_event_scores)[..., None] * raw_logits[:, None, :]
    return is_event_scores, raw_logits, torch.softmax(fused.amax(1), dim=-1)


# ---------------------------------------------------------------------------
# AudioVisualContrastive
# ---------------------------------------------------------------------------

def init_audio_visual_contrastive(init: Init):
    return {"fc_v1": linear_init(init, 1536, 512), "fc_a1": linear_init(init, 768, 512),
            "fc_gl": linear_init(init, 1024, 512), "fc1": linear_init(init, 1024, 512),
            "fc2": linear_init(init, 512, 256), "fc3": linear_init(init, 256, 128),
            "fc4": linear_init(init, 128, 1)}


def audio_visual_contrastive(params, video, audio, f_v_spatial_att_maps, T=10):
    """video (B*T, 36, 1536), audio (B*T, 1, 768) or (B*T, 768), spatial
    maps (B*T, 1, 36) -> (B*B, T, 1) match scores of every (audio i, video
    j) pair."""
    if audio.ndim == 3:
        audio = audio[:, 0]
    bs = video.shape[0] // T
    v = linear(params["fc_v1"], video)                    # (B*T, 36, 512)
    a = linear(params["fc_a1"], audio)                    # (B*T, 512)
    v_before = torch.einsum("bon,bnc->boc", f_v_spatial_att_maps, v)[:, 0]
    v_norm = v / torch.clamp(torch.linalg.norm(v, dim=2, keepdim=True), min=1e-12)
    a_norm = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=1e-12)
    v_before = v_before.reshape(bs, T, 512)
    v_norm = v_norm.reshape(bs, T, -1, 512)
    a_norm = a_norm.reshape(bs, T, 512)
    p = torch.softmax(torch.einsum("jtnc,itc->ijtn", v_norm, a_norm), dim=-1)
    grounded = torch.einsum("ijtn,jtnc->ijtc", p, v_norm)  # (i, j, T, 512)
    gl = torch.tanh(torch.cat([v_before[None].expand_as(grounded), grounded], dim=-1))
    v_grd = linear(params["fc_gl"], gl)
    a_rep = a.reshape(bs, T, 512)[:, None].expand_as(v_grd)
    feat = torch.cat([a_rep, v_grd], dim=-1)
    for name in ("fc1", "fc2", "fc3"):
        feat = torch.relu(linear(params[name], feat))
    return linear(params["fc4"], feat).reshape(bs * bs, T, 1)


# ---------------------------------------------------------------------------
# AudioVisualAdapter
# ---------------------------------------------------------------------------

ADAPTER_D = 256


def init_audio_visual_adapter(init: Init):
    d = ADAPTER_D
    enc = lambda d_in: {"affine": linear_init(init, d_in, d),
                        "layers": [init_encoder_layer(init, d, 1024) for _ in range(2)]}
    return {"fc_v": linear_init(init, 1536, 512), "fc_a": linear_init(init, 768, 128),
            "rnn_audio": bilstm_init(init, 128, d // 2), "rnn_video": bilstm_init(init, 512, d),
            "audio_encoder": enc(d), "video_encoder": enc(512),
            "audio_gated": linear_init(init, d, 1), "video_gated": linear_init(init, d, 1)}


def _itr_encoder(params, x, *, train=False, gen=None):
    """InternalTemporalRelationModule: affine and ReLU, then two post-norm
    encoder layers, time-major."""
    h = torch.relu(linear(params["affine"], x))
    for lp in params["layers"]:
        h = encoder_layer(lp, h, nhead=4, train=train, gen=gen)
    return h


def audio_visual_adapter(params, x, audio, *, alpha=0.6, train=False, gen=None):
    """x (B*10, 1536) pooled visual, audio (B*10, 768) -> (x gated, audio
    gated). The torch original assigns `self.fc_a` twice (the 768 -> 128
    projection is lost), calls an undefined `self.fc_v` and feeds the raw
    1536 / 768 features to LSTMs built for 512 / 128; it would fail if it
    ran. As the JAX package does, this runs the evident intent: project,
    BiLSTM, encode, and gate each modality by the other."""
    bs = x.shape[0] // 10
    xv, au = x.reshape(bs, 10, -1), audio.reshape(bs, 10, -1)
    a_rnn = bilstm(params["rnn_audio"], linear(params["fc_a"], au))   # (B, 10, 256)
    v_rnn = bilstm(params["rnn_video"], linear(params["fc_v"], xv))   # (B, 10, 512)
    a_kv = _itr_encoder(params["audio_encoder"], a_rnn.transpose(0, 1), train=train, gen=gen)
    v_kv = _itr_encoder(params["video_encoder"], v_rnn.transpose(0, 1), train=train, gen=gen)
    audio_gate = torch.sigmoid(linear(params["audio_gated"], a_kv)).transpose(0, 1)
    video_gate = torch.sigmoid(linear(params["video_gated"], v_kv)).transpose(0, 1)
    xv = xv + audio_gate * xv * alpha
    au = au + video_gate * au * alpha
    return xv.reshape(bs * 10, -1), au.reshape(bs * 10, -1)


# ---------------------------------------------------------------------------
# New_Audio_Guided_Attention
# ---------------------------------------------------------------------------

def init_new_audio_guided_attention(init: Init):
    vd, ad, hd = 512, 128, 256
    shapes = (("affine_video_1", vd, vd), ("affine_audio_1", ad, vd),
              ("affine_bottleneck", vd, hd), ("affine_v_c_att", hd, vd),
              ("affine_video_2", vd, hd), ("affine_audio_2", ad, hd),
              ("affine_v_s_att", hd, 1), ("video_query", vd, vd // 4),
              ("video_key", vd, vd // 4), ("video_value", vd, vd),
              ("affine_video_ave", vd, hd), ("affine_video_3", vd, hd), ("ave_v_att", hd, 1))
    p = {name: linear_init(init, i, o) for name, i, o in shapes}
    p["norm"] = layer_norm_init(init, vd)
    return p


def new_audio_guided_attention(params, video, audio, *, beta=0.4, train=False, gen=None):
    """video (B, T, H, W, 512), audio time-major (T, B, 128) as the
    reference receives it -> (B, T, 512)."""
    B, T, H, W, vd = video.shape
    a = audio.transpose(0, 1).reshape(B * T, -1)
    v = video.reshape(B * T, H * W, vd)
    raw_v = v
    # self-attention over the spatial positions
    q, k = linear(params["video_query"], v), linear(params["video_key"], v)
    attn = torch.softmax(torch.einsum("bnc,bmc->bnm", q, k), dim=-1)
    out = torch.einsum("bnm,bmc->bnc", attn, linear(params["video_value"], v))
    if train and gen is not None:
        out = dropout(gen, out, 0.2, train)
    v = layer_norm(params["norm"], v + out)
    # video self spatial attention
    v_avg = torch.relu(linear(params["affine_video_ave"], v.mean(1)))
    self_q = torch.relu(linear(params["affine_video_3"], v)) * v_avg[:, None]
    self_maps = torch.softmax(torch.tanh(linear(params["ave_v_att"], self_q))[..., 0], dim=-1)
    self_att = torch.einsum("bn,bnc->bc", self_maps, v).reshape(B, T, vd)
    # audio-guided channel attention
    aq1 = torch.relu(linear(params["affine_audio_1"], a))[:, None]
    vq1 = torch.relu(linear(params["affine_video_1"], v))
    avq = torch.relu(linear(params["affine_bottleneck"], (aq1 * vq1).mean(1)))
    c_maps = torch.sigmoid(linear(params["affine_v_c_att"], avq))
    c_att = raw_v * (c_maps[:, None] + 1.0)
    # audio-guided spatial attention
    cq = torch.relu(linear(params["affine_video_2"], c_att))
    aq2 = torch.relu(linear(params["affine_audio_2"], a))[:, None]
    s_maps = torch.softmax(torch.tanh(linear(params["affine_v_s_att"], cq * aq2))[..., 0], dim=-1)
    cs = torch.einsum("bn,bnc->bc", s_maps, c_att).reshape(B, T, vd)
    return cs + beta * torch.sigmoid(self_att) * cs
