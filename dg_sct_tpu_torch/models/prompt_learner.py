"""Prompt learning for the pretrain, few-shot and zero-shot suite
(`dg_sct_tpu/models/prompt_learner.py`): CoOp context vectors initialised
from the words of `ctx_init`, the class token at the end, middle or front
of each prompt, and the `ClipAdapter` bottleneck.

The prompt buffers come from the class names and the frozen CLIP token
embedding, once at build: the tokenized prompts "<ctx_init> <name>." and the
embeddings around the context slots. They are not leaves of the parameter
tree (they are numpy arrays in the JAX package), so a model carried across
rebuilds them from its own token embedding. Only `ctx` trains; `meta_net`
(CoCoOp's) is kept for checkpoint parity and the forward never reads it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..configs import CLIPConfig, PromptConfig
from ..ops import bpe
from ..ops.basic import Init, linear_init


def init_clip_adapter(init: Init, c_in, reduction=4):
    return {"fc1": {"kernel": init.normal((c_in, c_in // reduction), 0.02)},
            "fc2": {"kernel": init.normal((c_in // reduction, c_in), 0.02)}}


def clip_adapter(params, x):
    h = torch.relu(x @ params["fc1"]["kernel"])
    return torch.relu(h @ params["fc2"]["kernel"])


def build_prompt_buffers(classnames: Sequence[str], token_embedding, pcfg: PromptConfig,
                         ccfg: CLIPConfig):
    """Tokenize "<ctx_init> <name>." per class ("_" as a space; a trailing
    "background" class unless `pcfg.weak`) and split the frozen
    embeddings (rows of `token_embedding`, a (vocab, width) tensor) around
    the context slots. Returns, on the embedding's device: ctx_init (n_ctx,
    w), token_prefix (n_cls, 1, w) (SOT), token_suffix (n_cls, 77 - 1 -
    n_ctx, w) (the name, ".", EOT and padding), all float32; tokenized
    (n_cls, 77) int64; name_lens (each name's token count) and n_ctx."""
    names = [n.replace("_", " ") for n in classnames] + ([] if pcfg.weak else ["background"])
    ctx_init = pcfg.ctx_init.replace("_", " ")
    n_ctx = len(ctx_init.split(" ")) if ctx_init else pcfg.n_ctx
    dev = token_embedding.device
    rows = lambda ids: token_embedding[torch.as_tensor(np.asarray(ids, np.int64), device=dev)]
    if ctx_init:
        ctx_vectors = rows(bpe.tokenize(ctx_init)[0][1:1 + n_ctx])
        prompt_prefix = ctx_init
    else:
        ctx_vectors = torch.as_tensor(
            0.02 * np.random.RandomState(0).randn(n_ctx, ccfg.text_width), device=dev)
        prompt_prefix = " ".join(["X"] * n_ctx)
    tok = bpe.get_tokenizer()
    tokenized = bpe.tokenize([f"{prompt_prefix} {n}." for n in names])
    embedding = rows(tokenized).float()
    return {
        "ctx_init": ctx_vectors.float(),
        "token_prefix": embedding[:, :1],
        "token_suffix": embedding[:, 1 + n_ctx:],
        "tokenized": torch.as_tensor(tokenized.astype(np.int64), device=dev),
        "name_lens": [len(tok.encode(n)) for n in names],
        "n_ctx": n_ctx,
    }


def init_prompt_learner(init: Init, buffers, vis_dim, ctx_dim):
    return {
        "ctx": buffers["ctx_init"].to(init.device, init.dtype).clone(),
        "meta_net": {"linear1": linear_init(init, vis_dim, vis_dim // 16),
                     "linear2": linear_init(init, vis_dim // 16, ctx_dim)},
    }


def build_prompts(params, buffers, *, class_token_position="end"):
    """(n_cls, 77, width) prompt embeddings with the learned ctx, in ctx's
    type."""
    ctx = params["ctx"]
    prefix = buffers["token_prefix"].to(ctx.dtype)
    suffix = buffers["token_suffix"].to(ctx.dtype)
    n_cls = prefix.shape[0]
    ctx = ctx[None].expand((n_cls,) + tuple(ctx.shape))
    if class_token_position == "end":
        return torch.cat([prefix, ctx, suffix], dim=1)
    half = buffers["n_ctx"] // 2
    rows = []
    for i in range(n_cls):
        nl = buffers["name_lens"][i]
        cls_i, rest = suffix[i:i + 1, :nl], suffix[i:i + 1, nl:]
        if class_token_position == "middle":
            row = [prefix[i:i + 1], ctx[i:i + 1, :half], cls_i, ctx[i:i + 1, half:], rest]
        elif class_token_position == "front":
            row = [prefix[i:i + 1], cls_i, ctx[i:i + 1], rest]
        else:
            raise ValueError(class_token_position)
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0)
