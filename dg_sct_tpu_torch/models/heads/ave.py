"""AVE task head: TemporalAttention (BiLSTMs, a small cross-modal
transformer encoder/decoder, sigmoid gates) and CMBS (top-k class activation
scores and the localize module). Sequences are time-major (T, B, E).
"""
from __future__ import annotations

import torch

from ...ops.basic import Init, dropout, layer_norm, layer_norm_init, linear, linear_init
from ...ops.mha import mha, mha_init
from ...ops.rnn import bilstm, bilstm_init

D_MODEL = 256
V_FC_DIM = 512
A_FC_DIM = 128
FFN = 1024
P_DROP = 0.1   # dropout of the encoder and decoder layers and their attention
V_DROP = 0.2   # dropout after v_fc


def init_encoder_layer(init: Init, d_model, ffn):
    return {"self_attn": mha_init(init, d_model),
            "linear1": linear_init(init, d_model, ffn),
            "linear2": linear_init(init, ffn, d_model),
            "norm1": layer_norm_init(init, d_model),
            "norm2": layer_norm_init(init, d_model)}


def init_decoder_layer(init: Init, d_model, ffn):
    # self_attn is kept for checkpoint parity; the forward never runs it
    return {"self_attn": mha_init(init, d_model),
            "multihead_attn": mha_init(init, d_model),
            "linear1": linear_init(init, d_model, ffn),
            "linear2": linear_init(init, ffn, d_model),
            "norm1": layer_norm_init(init, d_model),
            "norm2": layer_norm_init(init, d_model)}


def _dropper(gen, train, rate, batch_axis=0):
    """Dropout at `rate` from `gen` in training; the identity without `gen`.
    `batch_axis`: the batch axis of what it drops (1 for time-major)."""
    return lambda t: t if gen is None else dropout(gen, t, rate, train, batch_axis)


def encoder_layer(params, src, *, nhead, train=False, gen=None, p_drop=P_DROP):
    drop = _dropper(gen, train, p_drop, batch_axis=1)
    s2 = mha(params["self_attn"], src, src, src, num_heads=nhead, gen=gen,
             dropout_rate=p_drop, train=train)
    src = layer_norm(params["norm1"], src + drop(s2))
    h = drop(torch.relu(linear(params["linear1"], src)))
    return layer_norm(params["norm2"], src + drop(linear(params["linear2"], h)))


def decoder_layer(params, tgt, memory, *, nhead, train=False, gen=None, p_drop=P_DROP):
    """memory = cat([memory, tgt]); cross-attention only."""
    drop = _dropper(gen, train, p_drop, batch_axis=1)
    mem = torch.cat([memory, tgt], dim=0)
    t2 = mha(params["multihead_attn"], tgt, mem, mem, num_heads=nhead, gen=gen,
             dropout_rate=p_drop, train=train)
    tgt = layer_norm(params["norm1"], tgt + drop(t2))
    h = drop(torch.relu(linear(params["linear1"], tgt)))
    return layer_norm(params["norm2"], tgt + drop(linear(params["linear2"], h)))


def init_temporal_attention(init: Init, v_dim=1536, a_dim=768):
    enc = lambda n: [init_encoder_layer(init, D_MODEL, FFN) for _ in range(n)]
    return {
        "v_fc": linear_init(init, v_dim, V_FC_DIM),
        "a_fc": linear_init(init, a_dim, A_FC_DIM),
        "audio_rnn": bilstm_init(init, A_FC_DIM, D_MODEL // 2),
        "visual_rnn": bilstm_init(init, V_FC_DIM, D_MODEL),
        "video_encoder": {"affine": linear_init(init, V_FC_DIM, D_MODEL), "layers": enc(2)},
        "audio_encoder": {"affine": linear_init(init, D_MODEL, D_MODEL), "layers": enc(2)},
        "video_decoder": {"affine": linear_init(init, V_FC_DIM, D_MODEL),
                          "layers": [init_decoder_layer(init, D_MODEL, FFN)]},
        "audio_decoder": {"affine": linear_init(init, D_MODEL, D_MODEL),
                          "layers": [init_decoder_layer(init, D_MODEL, FFN)]},
        "audio_gated": linear_init(init, D_MODEL, 1),
        "video_gated": linear_init(init, D_MODEL, 1),
    }


def temporal_attention(params, f_v, f_a, *, gamma=0.1, train=False, gen=None):
    """f_v: (B, T, 1536), f_a: (B, T, 768) -> time-major (video_out,
    audio_out, av_gate): (T, B, 256) x2, (T, B, 1). Training with `gen`:
    dropout 0.2 after v_fc and P_DROP in the encoder and decoder layers."""
    a = linear(params["a_fc"], f_a)
    v = _dropper(gen, train, V_DROP)(torch.relu(linear(params["v_fc"], f_v)))
    a_seq = bilstm(params["audio_rnn"], a).transpose(0, 1)
    v_seq = bilstm(params["visual_rnn"], v).transpose(0, 1)

    def run_encoder(p, x):
        x = linear(p["affine"], x)
        for lp in p["layers"]:
            x = encoder_layer(lp, x, nhead=4, train=train, gen=gen)
        return x

    def run_decoder(p, tgt, memory):
        tgt = linear(p["affine"], tgt)
        for lp in p["layers"]:
            tgt = decoder_layer(lp, tgt, memory, nhead=4, train=train, gen=gen)
        return tgt

    video_kv = run_encoder(params["video_encoder"], v_seq)
    audio_query_out = run_decoder(params["audio_decoder"], a_seq, video_kv)
    audio_kv = run_encoder(params["audio_encoder"], a_seq)
    video_query_out = run_decoder(params["video_decoder"], v_seq, audio_kv)

    audio_gate = torch.sigmoid(linear(params["audio_gated"], audio_kv))
    video_gate = torch.sigmoid(linear(params["video_gated"], video_kv))
    video_query_out = video_query_out + audio_gate * video_query_out * gamma
    audio_query_out = audio_query_out + video_gate * audio_query_out * gamma
    return video_query_out, audio_query_out, audio_gate * video_gate


def init_av_inter(init: Init, d_model):
    return {"mha": mha_init(init, d_model), "norm1": layer_norm_init(init, d_model)}


def init_cmbs(init: Init, num_classes=28):
    # AVInter / VAInter weights are kept for checkpoint parity; their outputs
    # are unused in the reference, so the forward skips them
    return {"AVInter": init_av_inter(init, D_MODEL),
            "VAInter": init_av_inter(init, D_MODEL),
            "video_cas": linear_init(init, D_MODEL, num_classes),
            "audio_cas": linear_init(init, D_MODEL, num_classes),
            "localize_classifier": linear_init(init, D_MODEL, 1),
            "localize_event": linear_init(init, D_MODEL, num_classes)}


def cmbs(params, video_feat, audio_feat, *, gamma=0.3, topk=4):
    """video/audio_feat: (T, B, 256) -> (is_event_scores (T, B, 1),
    event_scores (B, n_cls), av_score (B, n_cls))."""
    topk = min(topk, video_feat.shape[0])
    video_cas = linear(params["video_cas"], video_feat).transpose(0, 1)   # (B, T, n_cls)
    audio_cas = linear(params["audio_cas"], audio_feat).transpose(0, 1)
    score_v = torch.topk(video_cas.transpose(1, 2), topk, dim=-1).values.mean(-1)
    score_a = torch.topk(audio_cas.transpose(1, 2), topk, dim=-1).values.mean(-1)
    av_score = 0.5 * (score_v + score_a)
    fused = 0.5 * (video_feat + audio_feat)
    is_event_scores = linear(params["localize_classifier"], fused)
    event_scores = linear(params["localize_event"], fused.amax(0)) + gamma * av_score
    return is_event_scores, event_scores, av_score
