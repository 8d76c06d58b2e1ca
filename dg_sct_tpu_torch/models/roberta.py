"""RoBERTa-base, the CLAP text tower (`dg_sct_tpu/models/roberta.py`), and
CLAP's `text_projection` MLP (768 -> 512 -> 512).

The eval forward of `transformers.RobertaModel`: position ids counted past
the pad id over the attention mask, post-LN encoder layers with exact GELU,
a tanh pooler on the first token. Linears are {"kernel" (in, out), "bias"},
the port's one layout; `roberta_from_torch` and `projection_from_torch`
transpose an HF-format state dict's (out, in) weights into it.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..ops.basic import Init, gelu, layer_norm, layer_norm_init, linear, linear_init

VOCAB = 50265
HIDDEN = 768
LAYERS = 12
HEADS = 12
INTERMEDIATE = 3072
MAX_POS = 514
PAD_ID = 1
LN_EPS = 1e-5
EMBED = 512   # CLAP's joint embedding


def init_roberta(init: Init):
    """RoBERTa-base from the initialiser."""
    lin = lambda i, o: linear_init(init, i, o)
    p = {"word_emb": init.normal((VOCAB, HIDDEN), 0.02),
         "pos_emb": init.normal((MAX_POS, HIDDEN), 0.02),
         "type_emb": init.normal((1, HIDDEN), 0.02),
         "emb_ln": layer_norm_init(init, HIDDEN),
         "pooler": lin(HIDDEN, HIDDEN),
         "layers": []}
    for _ in range(LAYERS):
        p["layers"].append({
            "q": lin(HIDDEN, HIDDEN), "k": lin(HIDDEN, HIDDEN), "v": lin(HIDDEN, HIDDEN),
            "attn_out": lin(HIDDEN, HIDDEN), "attn_ln": layer_norm_init(init, HIDDEN),
            "inter": lin(HIDDEN, INTERMEDIATE), "out": lin(INTERMEDIATE, HIDDEN),
            "out_ln": layer_norm_init(init, HIDDEN),
        })
    return p


def _t(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _lin(state, prefix, device):
    return {"kernel": _t(state[prefix + ".weight"], device).T.contiguous(),
            "bias": _t(state[prefix + ".bias"], device)}


def roberta_from_torch(state: Dict[str, object], *, device="cpu"):
    """An HF `RobertaModel` state dict (the CLAP checkpoint's `text_branch.*`
    keys, prefix stripped; tensors or arrays) -> the params tree."""
    ln = lambda prefix: {"scale": _t(state[prefix + ".weight"], device),
                         "bias": _t(state[prefix + ".bias"], device)}
    p = {"word_emb": _t(state["embeddings.word_embeddings.weight"], device),
         "pos_emb": _t(state["embeddings.position_embeddings.weight"], device),
         "type_emb": _t(state["embeddings.token_type_embeddings.weight"], device),
         "emb_ln": ln("embeddings.LayerNorm"),
         "pooler": _lin(state, "pooler.dense", device),
         "layers": []}
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in state:
        b = f"encoder.layer.{i}"
        p["layers"].append({
            "q": _lin(state, f"{b}.attention.self.query", device),
            "k": _lin(state, f"{b}.attention.self.key", device),
            "v": _lin(state, f"{b}.attention.self.value", device),
            "attn_out": _lin(state, f"{b}.attention.output.dense", device),
            "attn_ln": ln(f"{b}.attention.output.LayerNorm"),
            "inter": _lin(state, f"{b}.intermediate.dense", device),
            "out": _lin(state, f"{b}.output.dense", device),
            "out_ln": ln(f"{b}.output.LayerNorm"),
        })
        i += 1
    return p


def roberta_encode(params, input_ids, attention_mask):
    """input_ids, attention_mask (B, L) int -> (last hidden (B, L, H),
    pooled (B, H)), over HEADS heads whatever the width."""
    dev = params["word_emb"].device
    ids = torch.as_tensor(input_ids, device=dev).long()
    mask = torch.as_tensor(attention_mask, device=dev).long()
    pos_ids = torch.cumsum(mask, dim=1) * mask + PAD_ID
    h = params["word_emb"][ids] + params["pos_emb"][pos_ids] + params["type_emb"][0]
    h = layer_norm(params["emb_ln"], h, eps=LN_EPS)
    B, L, H = h.shape
    heads = HEADS
    d = H // heads
    bias = (1.0 - mask.to(h.dtype))[:, None, None, :] * -1e9
    for lp in params["layers"]:
        split = lambda p: linear(p, h).reshape(B, L, heads, d).transpose(1, 2)
        q, k, v = split(lp["q"]), split(lp["k"]), split(lp["v"])
        attn = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d) + bias, dim=-1)
        ctx = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(B, L, H)
        h = layer_norm(lp["attn_ln"], h + linear(lp["attn_out"], ctx), eps=LN_EPS)
        ffn = linear(lp["out"], gelu(linear(lp["inter"], h), "exact"))
        h = layer_norm(lp["out_ln"], h + ffn, eps=LN_EPS)
    return h, torch.tanh(linear(params["pooler"], h[:, 0]))


def init_text_projection(init: Init):
    return {"fc1": linear_init(init, HIDDEN, EMBED), "fc2": linear_init(init, EMBED, EMBED)}


def projection_from_torch(state: Dict[str, object], *, device="cpu"):
    """CLAP's text_projection, Sequential(Linear, ReLU, Linear): keys "0.*"
    and "2.*"."""
    return {"fc1": _lin(state, "0", device), "fc2": _lin(state, "2", device)}


def text_projection(params, pooled):
    return linear(params["fc2"], torch.relu(linear(params["fc1"], pooled)))
