"""GroupViT-style token grouping of the AVVP model (`dg_sct_tpu/models/grouping.py`,
DG-SCT's `AVVP/nets/grouping.py`): assignment attention (soft, hard or
Gumbel, straight-through), the grouping block, the pre-norm attention block
and `modality_trans` (self-attention over [tokens ; group tokens], the
optional HAN cross-modal encoder, then grouping down to the class tokens).

Everything is batch-major (B, N, C) products at the heads' width (128), in
plain PyTorch. The attention scores of `attention` and `attn_block` are
float32 and their softmax goes back to the query's type, as JAX computes
them (`preferred_element_type=float32`). Gumbel noise is drawn from an
explicit generator (`gumbel_noise`) apart from its apply
(`gumbel_softmax`), so a test can hand both packages the same noise.
"""
from __future__ import annotations

import torch

from ..ops.basic import Init, layer_norm, layer_norm_init, linear, linear_init, mlp, mlp_init
from ..ops.draws import draw


# ---------------------------------------------------------------------------
# attention primitives
# ---------------------------------------------------------------------------

def attention_init(init: Init, dim, out_dim=None, qkv_bias=False):
    return {"q_proj": linear_init(init, dim, dim, bias=qkv_bias),
            "k_proj": linear_init(init, dim, dim, bias=qkv_bias),
            "v_proj": linear_init(init, dim, dim, bias=qkv_bias),
            "proj": linear_init(init, dim, out_dim or dim)}


def _mha_core(q, k, v, dtype):
    """(B, N, h, d) x (B, S, h, d) -> (B, N, h, d): float32 scores of the
    scaled q (rounded to its type first), softmax back to `dtype`."""
    hd = q.shape[-1]
    scores = torch.einsum("bnhd,bshd->bhns", (q * hd ** -0.5).float(), k.float())
    attn = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhns,bshd->bnhd", attn, v)


def attention(params, query, key=None, value=None, *, num_heads):
    """(B, N, C) x (B, S, C) -> (B, N, C) softmax cross-attention; key
    defaults to the query and value to the key."""
    key = query if key is None else key
    value = key if value is None else value
    B, N, C = query.shape
    hd = C // num_heads
    q = linear(params["q_proj"], query).reshape(B, N, num_heads, hd)
    k = linear(params["k_proj"], key).reshape(B, -1, num_heads, hd)
    v = linear(params["v_proj"], value).reshape(B, -1, num_heads, hd)
    return linear(params["proj"], _mha_core(q, k, v, query.dtype).reshape(B, N, C))


def _onehot_argmax(y, axis):
    idx = y.argmax(dim=axis, keepdim=True)
    return torch.zeros_like(y).scatter_(axis, idx, 1.0)


def hard_softmax(logits, axis):
    """Straight-through argmax: the one-hot of softmax's argmax forward,
    softmax's gradient back; `onehot - y_soft.detach() + y_soft` in JAX's
    order, so the forward's ones round as JAX's do."""
    y_soft = torch.softmax(logits, dim=axis)
    return _onehot_argmax(y_soft, axis) - y_soft.detach() + y_soft


def gumbel_noise(gen, shape, device, dtype=torch.float32):
    """Standard Gumbel draws -log(-log(U)), U uniform in [tiny, 1), from `gen`."""
    u = draw(gen, lambda s, g: torch.rand(s, generator=g, device=device, dtype=torch.float32),
             shape)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def gumbel_softmax(logits, noise, tau=1.0, hard=False, axis=-1):
    """softmax((logits + noise) / tau) over `axis`; with `hard` its
    straight-through one-hot."""
    y_soft = torch.softmax((logits + noise) / tau, dim=axis)
    if hard:
        return _onehot_argmax(y_soft, axis) - y_soft.detach() + y_soft
    return y_soft


def assign_attention_init(init: Init, dim):
    return attention_init(init, dim, qkv_bias=True)


def assign_attention(params, query, key_, *, hard, gumbel, train=False, gen=None,
                     gumbel_tau=1.0, assign_eps=1.0, return_attn=False):
    """Single-head assignment of tokens to groups. query (B, S2, C) groups,
    key_ (B, S, C) tokens; the value is the key tensor. Softmax over the
    GROUP axis (-2) (Gumbel with `gumbel` when training with `gen`; the
    straight-through one-hot with `hard`), then each group's row divided by
    its sum plus `assign_eps`. -> (out (B, S2, C), attn dict or None): with
    `return_attn`, {"hard": the assignment before the row division, "soft":
    1 + softmax(softmax(raw, -2), -1)}."""
    C = query.shape[-1]
    q = linear(params["q_proj"], query)
    k = linear(params["k_proj"], key_)
    v = linear(params["v_proj"], key_)
    raw = torch.einsum("bnc,bsc->bns", q, k) * (C ** -0.5)
    if gumbel and train and gen is not None:
        noise = gumbel_noise(gen, raw.shape, raw.device, raw.dtype)
        attn = gumbel_softmax(raw, noise, tau=gumbel_tau, hard=hard, axis=-2)
    elif hard:
        attn = hard_softmax(raw, axis=-2)
    else:
        attn = torch.softmax(raw, dim=-2)
    attn_dict = None
    if return_attn:
        soft = 1.0 + torch.softmax(torch.softmax(raw, dim=-2), dim=-1)
        attn_dict = {"hard": attn, "soft": soft}
    attn = attn / (attn.sum(-1, keepdim=True) + assign_eps)
    out = torch.einsum("bns,bsc->bnc", attn, v)
    return linear(params["proj"], out), attn_dict


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def attn_block_init(init: Init, dim, mlp_ratio=4.0):
    return {"norm1": layer_norm_init(init, dim),
            "qkv": linear_init(init, dim, dim * 3),
            "proj": linear_init(init, dim, dim),
            "norm2": layer_norm_init(init, dim),
            "mlp": mlp_init(init, dim, int(dim * mlp_ratio))}


def attn_block(params, x, *, num_heads, gelu="exact"):
    """Pre-norm self-attention block with a fused qkv."""
    B, N, C = x.shape
    qkv = linear(params["qkv"], layer_norm(params["norm1"], x))
    qkv = qkv.reshape(B, N, 3, num_heads, C // num_heads)
    out = _mha_core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], x.dtype).reshape(B, N, C)
    x = x + linear(params["proj"], out)
    return x + mlp(params["mlp"], layer_norm(params["norm2"], x), gelu)


def cross_attn_block_init(init: Init, dim, mlp_ratio=4.0):
    return {"attn": attention_init(init, dim, qkv_bias=True),
            "norm2": layer_norm_init(init, dim),
            "mlp": mlp_init(init, dim, int(dim * mlp_ratio)),
            "norm_post": layer_norm_init(init, dim)}


def cross_attn_block(params, query, key_, *, num_heads, gelu="exact"):
    """The post-norm cross-attention block in front of the assignment."""
    x = query + attention(params["attn"], query, key_, num_heads=num_heads)
    x = x + mlp(params["mlp"], layer_norm(params["norm2"], x), gelu)
    return layer_norm(params["norm_post"], x)


def grouping_block_init(init: Init, dim, out_dim, num_group_token, num_output_group,
                        mlp_ratio=(0.5, 4.0)):
    return {
        "norm_tokens": layer_norm_init(init, dim),
        "mlp_inter": mlp_init(init, num_group_token, int(mlp_ratio[0] * dim),
                              out=num_output_group),
        "norm_post_tokens": layer_norm_init(init, dim),
        "norm_x": layer_norm_init(init, dim),
        "pre_assign_attn": cross_attn_block_init(init, dim),
        "assign": assign_attention_init(init, dim),
        "norm_new_x": layer_norm_init(init, dim),
        "mlp_channels": mlp_init(init, dim, int(mlp_ratio[1] * dim), out=out_dim),
    }


def grouping_block(params, x, group_tokens, *, num_heads, hard, gumbel, train=False, gen=None,
                   return_attn=False, gelu="exact"):
    """(tokens (B, L, C), group tokens (B, S1, C)) -> (groups (B, S2, C),
    attn dict or None): the S1 group tokens become S2 by an MLP over the
    token axis, attend to the tokens, then take their assignment."""
    group_tokens = layer_norm(params["norm_tokens"], group_tokens)
    x = layer_norm(params["norm_x"], x)
    proj = mlp(params["mlp_inter"], group_tokens.transpose(1, 2), gelu).transpose(1, 2)
    proj = layer_norm(params["norm_post_tokens"], proj)
    proj = cross_attn_block(params["pre_assign_attn"], proj, x, num_heads=num_heads, gelu=gelu)
    new_x, attn_dict = assign_attention(params["assign"], proj, x, hard=hard, gumbel=gumbel,
                                        train=train, gen=gen, return_attn=return_attn)
    new_x = new_x + proj
    new_x = new_x + mlp(params["mlp_channels"], layer_norm(params["norm_new_x"], new_x), gelu)
    return new_x, attn_dict


def modality_trans_init(init: Init, dim, *, depth, num_group_tokens=25, num_output_groups=25,
                        use_han=False, han_tokens=10, mlp_ratio=4.0):
    """`han_tokens`: the length of the HAN's cross-modal input (the 10
    segments)."""
    p = {"blocks": [attn_block_init(init, dim, mlp_ratio) for _ in range(depth)],
         "grouping": grouping_block_init(init, dim, dim, num_group_tokens, num_output_groups)}
    if use_han:
        p["han_encoder"] = grouping_block_init(init, dim, dim, han_tokens, han_tokens)
    return p


def modality_trans(params, x, group_token, *, num_heads=8, x_other=None, hard=False,
                   gumbel=False, train=False, gen=None, return_attn=False, gelu="exact"):
    """x (B, L, C); group_token (S1, C) or (B, S1, C) -> (groups (B, S1, C),
    attn dict or None, x_attn (B, L, C)). With a HAN encoder and `x_other`,
    the tokens first take x_other's grouping in the inverted assignment
    mode (hard and Gumbel when the model's assignment is soft), as DG-SCT
    builds it."""
    B = x.shape[0]
    if group_token.ndim == 2:
        group_token = group_token[None].expand((B,) + tuple(group_token.shape))
    S1 = group_token.shape[1]
    cat = torch.cat([x, group_token], dim=1)
    for bp in params["blocks"]:
        cat = attn_block(bp, cat, num_heads=num_heads, gelu=gelu)
    x_attn, group_token = cat[:, :-S1], cat[:, -S1:]
    if "han_encoder" in params and x_other is not None:
        x_attn, _ = grouping_block(params["han_encoder"], x_attn, x_other, num_heads=8,
                                   hard=not hard, gumbel=not hard, train=train, gen=gen,
                                   gelu=gelu)
    out, attn_dict = grouping_block(params["grouping"], x_attn, group_token, num_heads=num_heads,
                                    hard=hard, gumbel=gumbel, train=train, gen=gen,
                                    return_attn=return_attn, gelu=gelu)
    return out, attn_dict, x_attn
