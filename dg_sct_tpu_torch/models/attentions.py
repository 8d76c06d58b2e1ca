"""The attention-variant library the reference vendors (sooftware's
`attentions`, no live call site) over the JAX package's trees
(`dg_sct_tpu/models/attentions.py`): eight variants, each an `init_*(init,
...) -> params` and a function `(params, ...) -> (context, attn)` (the
relative one returns its projected context). Linears are {"w" (in, out),
"b"}; the trees keep the JAX package's non-array leaves (`num_heads`,
`smoothing`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.basic import Init, apply_keep_mask, keep_mask


def _linear(init: Init, d_in, d_out, *, bias=True):
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": init.uniform((d_in, d_out), -bound, bound)}
    if bias:
        p["b"] = init.uniform((d_out,), -bound, bound)
    return p


def _apply(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def scaled_dot_product_attention(query, key, value, mask=None):
    """softmax(Q K^T / sqrt(d)) V over (B, L, d); `mask` True where a score
    is dropped."""
    score = torch.einsum("bqd,bkd->bqk", query, key) / math.sqrt(query.shape[-1])
    if mask is not None:
        score = score.masked_fill(mask.reshape(score.shape), -math.inf)
    attn = torch.softmax(score, dim=-1)
    return torch.einsum("bqk,bkd->bqd", attn, value), attn


def dot_product_attention(query, value):
    """Unscaled Q V^T softmax over the values."""
    attn = torch.softmax(torch.einsum("bqd,bkd->bqk", query, value), dim=-1)
    return torch.einsum("bqk,bkd->bqd", attn, value), attn


def init_additive(init: Init, hidden_dim):
    return {"query_proj": _linear(init, hidden_dim, hidden_dim, bias=False),
            "key_proj": _linear(init, hidden_dim, hidden_dim, bias=False),
            "score_proj": _linear(init, hidden_dim, 1),
            "bias": init.uniform((hidden_dim,), -0.1, 0.1)}


def additive_attention(params, query, key, value):
    """Bahdanau attention; `query` broadcasts against `key` as torch's `+`
    does (q_len == k_len or 1)."""
    energy = torch.tanh(_apply(params["key_proj"], key) + _apply(params["query_proj"], query)
                        + params["bias"])
    attn = torch.softmax(_apply(params["score_proj"], energy)[..., 0], dim=-1)
    return torch.einsum("bk,bkd->bd", attn, value)[:, None, :], attn


def _conv1d_same(x, w, b):
    """x (B, L, Cin), w (K, Cin, Cout): stride 1, "SAME" -> (B, L, Cout)."""
    return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding="same").transpose(1, 2)


def init_location_aware(init: Init, hidden_dim, *, smoothing=True):
    bound = 1.0 / math.sqrt(3 * 1)
    return {"conv_w": init.uniform((3, 1, hidden_dim), -bound, bound),
            "conv_b": init.uniform((hidden_dim,), -bound, bound),
            "query_proj": _linear(init, hidden_dim, hidden_dim, bias=False),
            "value_proj": _linear(init, hidden_dim, hidden_dim, bias=False),
            "score_proj": _linear(init, hidden_dim, 1),
            "bias": init.uniform((hidden_dim,), -0.1, 0.1),
            "smoothing": smoothing}


def location_aware_attention(params, query, value, last_attn=None):
    """The previous alignment (B, L) through a convolution into the energy."""
    B, L, _ = value.shape
    if last_attn is None:
        last_attn = value.new_zeros((B, L))
    conv_attn = _conv1d_same(last_attn[:, :, None], params["conv_w"], params["conv_b"])
    energy = torch.tanh(_apply(params["query_proj"], query) + _apply(params["value_proj"], value)
                        + conv_attn + params["bias"])
    score = _apply(params["score_proj"], energy)[..., 0]
    if params["smoothing"]:
        score = torch.sigmoid(score)
        attn = score / score.sum(-1, keepdim=True)
    else:
        attn = torch.softmax(score, dim=-1)
    return torch.einsum("bk,bkd->bd", attn, value), attn


def init_multi_head_location_aware(init: Init, hidden_dim, num_heads=8, conv_out_channel=10):
    d = hidden_dim // num_heads
    bound = 1.0 / math.sqrt(3 * num_heads)
    return {"conv_w": init.uniform((3, num_heads, conv_out_channel), -bound, bound),
            "conv_b": init.uniform((conv_out_channel,), -bound, bound),
            "loc_proj": _linear(init, conv_out_channel, d, bias=False),
            "query_proj": _linear(init, hidden_dim, d * num_heads, bias=False),
            "value_proj": _linear(init, hidden_dim, d * num_heads, bias=False),
            "score_proj": _linear(init, d, 1),
            "bias": init.uniform((d,), -0.1, 0.1),
            "num_heads": num_heads}


def multi_head_location_aware_attention(params, query, value, last_attn=None):
    """query (B, 1, D), value (B, L, D), last_attn (B, heads, L)."""
    H = params["num_heads"]
    B, L, D = value.shape
    d = D // H
    if last_attn is None:
        last_attn = value.new_zeros((B, H, L))
    loc = _conv1d_same(last_attn.transpose(1, 2), params["conv_w"], params["conv_b"])
    loc_energy = torch.tanh(_apply(params["loc_proj"], loc))[:, None]       # (B, 1, L, d)
    q = _apply(params["query_proj"], query).reshape(B, -1, H, d).transpose(1, 2)
    v = _apply(params["value_proj"], value).reshape(B, L, H, d).transpose(1, 2)
    energy = torch.tanh(v + q + loc_energy + params["bias"])                 # (B, H, L, d)
    attn = torch.softmax(_apply(params["score_proj"], energy)[..., 0], dim=-1)
    return torch.einsum("bhk,bhkd->bhd", attn, v).reshape(B, 1, H * d), attn


def init_multi_head(init: Init, d_model=512, num_heads=8):
    return {"query_proj": _linear(init, d_model, d_model),
            "key_proj": _linear(init, d_model, d_model),
            "value_proj": _linear(init, d_model, d_model),
            "num_heads": num_heads}


def multi_head_attention(params, query, key, value, mask=None):
    """Heads concatenated, no output projection; `mask` (B, Lq, Lk) True
    where a score is dropped."""
    H = params["num_heads"]
    B = value.shape[0]
    d = query.shape[-1] // H
    split = lambda p, x: _apply(p, x).reshape(B, -1, H, d).transpose(1, 2)
    q, k, v = (split(params[n], x) for n, x in
               (("query_proj", query), ("key_proj", key), ("value_proj", value)))
    score = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if mask is not None:
        score = score.masked_fill(mask[:, None], -math.inf)
    attn = torch.softmax(score, dim=-1)
    context = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(B, -1, H * d)
    return context, attn


def init_relative_multi_head(init: Init, d_model=512, num_heads=16):
    d = d_model // num_heads
    xav = math.sqrt(6.0 / (num_heads + d))
    return {"query_proj": _linear(init, d_model, d_model),
            "key_proj": _linear(init, d_model, d_model),
            "value_proj": _linear(init, d_model, d_model),
            "pos_proj": _linear(init, d_model, d_model, bias=False),
            "out_proj": _linear(init, d_model, d_model),
            "u_bias": init.uniform((num_heads, d), -xav, xav),
            "v_bias": init.uniform((num_heads, d), -xav, xav),
            "num_heads": num_heads}


def _rel_shift(pos_score):
    """Transformer-XL's relative shift: a zero column prepended, the scores
    folded to (L2 + 1, L1), the first row dropped, unfolded."""
    B, H, L1, L2 = pos_score.shape
    padded = torch.cat([pos_score.new_zeros((B, H, L1, 1)), pos_score], dim=-1)
    return padded.reshape(B, H, L2 + 1, L1)[:, :, 1:].reshape(B, H, L1, L2)


def relative_multi_head_attention(params, query, key, value, pos_embedding, mask=None, *,
                                  train=False, gen=None, dropout_p=0.1):
    """Transformer-XL content and position scores -> the output projection
    of the context (B, L, D). Training with `gen`: dropout on the attention
    weights."""
    H = params["num_heads"]
    B, L, D = value.shape
    d = D // H
    q = _apply(params["query_proj"], query).reshape(B, -1, H, d)
    k = _apply(params["key_proj"], key).reshape(B, -1, H, d).transpose(1, 2)
    v = _apply(params["value_proj"], value).reshape(B, -1, H, d).transpose(1, 2)
    pos = _apply(params["pos_proj"], pos_embedding).reshape(B, -1, H, d)
    content = torch.einsum("bqhd,bhkd->bhqk", q + params["u_bias"], k)
    pos_score = torch.einsum("bqhd,bkhd->bhqk", q + params["v_bias"], pos)
    score = (content + _rel_shift(pos_score)) / math.sqrt(D)
    if mask is not None:
        score = score.masked_fill(mask[:, None], -1e9)
    attn = torch.softmax(score, dim=-1)
    if train and gen is not None and dropout_p > 0:
        attn = apply_keep_mask(attn, keep_mask(gen, attn.shape, dropout_p, attn.device), dropout_p)
    context = torch.einsum("bhqk,bhkd->bqhd", attn, v).reshape(B, -1, D)
    return _apply(params["out_proj"], context)


def init_customizing(init: Init, hidden_dim, num_heads=4, conv_out_channel=10):
    d = hidden_dim // num_heads
    bound = 1.0 / math.sqrt(3 * 1)
    return {"conv_w": init.uniform((3, 1, conv_out_channel), -bound, bound),
            "conv_b": init.uniform((conv_out_channel,), -bound, bound),
            "query_proj": _linear(init, hidden_dim, d * num_heads),
            "value_proj": _linear(init, hidden_dim, d * num_heads, bias=False),
            "loc_proj": _linear(init, conv_out_channel, d, bias=False),
            "bias": init.uniform((d * num_heads,), -0.1, 0.1),
            "num_heads": num_heads}


def customizing_attention(params, query, value, last_attn=None):
    """Multi-head location-aware hybrid. The vendored torch code calls its
    scaled dot-product attention with two arguments, which would fail if it
    ran; as the JAX package does, this runs the evident intent,
    `scaled_dot_product_attention(q, v, v)`."""
    H = params["num_heads"]
    B, Lq = query.shape[:2]
    Lv, D = value.shape[1], value.shape[2]
    d = D // H
    if last_attn is None:
        last_attn = value.new_zeros((B * H, Lv))
    conv = _conv1d_same(last_attn[:, :, None], params["conv_w"], params["conv_b"])
    loc_energy = _apply(params["loc_proj"], conv.reshape(B, H, Lv, -1))      # (B, H, Lv, d)
    loc_energy = loc_energy.transpose(1, 2).reshape(B, Lv, H * d)
    q = _apply(params["query_proj"], query)
    v = _apply(params["value_proj"], value) + loc_energy + params["bias"]
    q = q.reshape(B, Lq, H, d).transpose(1, 2).reshape(B * H, Lq, d)
    v = v.reshape(B, Lv, H, d).transpose(1, 2).reshape(B * H, Lv, d)
    context, attn = scaled_dot_product_attention(q, v, v)
    return context.reshape(B, H, Lq, d).transpose(1, 2).reshape(B, Lq, -1), attn
