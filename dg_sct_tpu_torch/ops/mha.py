"""Multi-head attention in torch `nn.MultiheadAttention`'s weight layout
(in_proj (E, 3E) with bias, out_proj), time-major (T, B, E) inputs."""
from __future__ import annotations

import math

import torch

from .basic import Init, dropout, linear, linear_init


def mha_init(init: Init, embed_dim):
    bound = 1.0 / math.sqrt(embed_dim)
    return {"in_proj": {"kernel": init.uniform((embed_dim, 3 * embed_dim), -bound, bound),
                        "bias": init.zeros((3 * embed_dim,))},
            "out_proj": linear_init(init, embed_dim, embed_dim)}


def mha(params, query, key, value, *, num_heads, gen=None, dropout_rate=0.0, train=False):
    """query/key/value: (Tq/Tk/Tk, B, E) time-major. Returns (Tq, B, E).
    Training with `gen`: dropout on the attention weights."""
    Tq, B, E = query.shape
    Tk = key.shape[0]
    hd = E // num_heads
    wq, wk, wv = torch.split(params["in_proj"]["kernel"], E, dim=1)
    bq, bk, bv = torch.split(params["in_proj"]["bias"], E)
    q = (query @ wq + bq).transpose(0, 1).reshape(B, Tq, num_heads, hd)
    k = (key @ wk + bk).transpose(0, 1).reshape(B, Tk, num_heads, hd)
    v = (value @ wv + bv).transpose(0, 1).reshape(B, Tk, num_heads, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
    attn = torch.softmax(attn.to(torch.promote_types(attn.dtype, torch.float32)),
                         dim=-1).to(query.dtype)
    if gen is not None:
        attn = dropout(gen, attn, dropout_rate, train)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, Tq, E)
    return linear(params["out_proj"], out).transpose(0, 1)
