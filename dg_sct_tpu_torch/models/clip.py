"""CLIP ViT-B/32 visual and text towers (`dg_sct_tpu/models/clip.py`, a
rebuild of OpenAI CLIP's `model.py`).

Pre-norm residual blocks with QuickGELU; the visual tower's blocks are
exposed as their two halves (`attention_part`, `mlp_part`), because the
pretrain interleave injects adapters between them. Attention scores are
float32 (products of the inputs' values summed in float32), masked and
softmaxed in float32, then cast to the input's type, as the JAX package
orders it. This attention runs in no Pallas kernel there, so it stays plain
PyTorch here. The text tower masks causally and reads the features at the
EOT token (the argmax of the ids).
"""
from __future__ import annotations

import torch

from ..configs import CLIPConfig
from ..ops.basic import Init, layer_norm, layer_norm_init, linear, linear_init
from ..ops.mha import mha_init


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def init_resblock(init: Init, d_model):
    return {"ln_1": layer_norm_init(init, d_model),
            "attn": mha_init(init, d_model),
            "ln_2": layer_norm_init(init, d_model),
            "mlp": {"c_fc": linear_init(init, d_model, 4 * d_model),
                    "c_proj": linear_init(init, 4 * d_model, d_model)}}


def _self_attention(params, x, *, num_heads, mask=None):
    """Batch-major self-attention in torch MHA's weight layout. x: (B, L, D)."""
    B, L, D = x.shape
    hd = D // num_heads
    wq, wk, wv = torch.split(params["in_proj"]["kernel"], D, dim=1)
    bq, bk, bv = torch.split(params["in_proj"]["bias"], D)
    q = (x @ wq + bq).reshape(B, L, num_heads, hd)
    k = (x @ wk + bk).reshape(B, L, num_heads, hd)
    v = (x @ wv + bv).reshape(B, L, num_heads, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", (q * hd ** -0.5).float(), k.float())
    if mask is not None:
        attn = attn + mask.float()
    attn = torch.softmax(attn, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, L, D)
    return linear(params["out_proj"], out)


def attention_part(params, x, *, num_heads, mask=None):
    """ln_1, then attention: the residual of a block's first half."""
    return _self_attention(params["attn"], layer_norm(params["ln_1"], x), num_heads=num_heads,
                           mask=mask)


def mlp_part(params, x):
    """ln_2, then the QuickGELU MLP: the residual of a block's second half."""
    h = layer_norm(params["ln_2"], x)
    return linear(params["mlp"]["c_proj"], quick_gelu(linear(params["mlp"]["c_fc"], h)))


def resblock(params, x, *, num_heads, mask=None):
    x = x + attention_part(params, x, num_heads=num_heads, mask=mask)
    return x + mlp_part(params, x)


# ---------------------------------------------------------------------------
# visual tower
# ---------------------------------------------------------------------------

def init_visual(init: Init, cfg: CLIPConfig):
    grid = cfg.image_size // cfg.vision_patch
    width = cfg.vision_width
    return {
        "conv1": {"kernel": init.normal((cfg.vision_patch, cfg.vision_patch, 3, width), 0.02)},
        "class_embedding": init.normal((width,), width ** -0.5),
        "positional_embedding": init.normal((grid * grid + 1, width), width ** -0.5),
        "ln_pre": layer_norm_init(init, width),
        "resblocks": [init_resblock(init, width) for _ in range(cfg.vision_layers)],
        "ln_post": layer_norm_init(init, width),
        "proj": init.normal((width, cfg.embed_dim), width ** -0.5),
    }


def visual_embed(params, images, cfg: CLIPConfig):
    """(N, H, W, 3) -> (N, grid^2 + 1, width) tokens after ln_pre: the
    stride-p patch conv (no bias) as space-to-depth and one GEMM, the class
    token first, the positional embedding."""
    p = cfg.vision_patch
    N, H, W, _ = images.shape
    gh, gw = H // p, W // p
    x = images.reshape(N, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(N, gh * gw, p * p * 3) @ params["conv1"]["kernel"].reshape(p * p * 3, -1)
    cls = params["class_embedding"].to(x.dtype).expand(N, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + params["positional_embedding"]
    return layer_norm(params["ln_pre"], x)


def visual_project(params, x):
    """ln_post on the class token, then the projection -> (N, embed_dim)."""
    return layer_norm(params["ln_post"], x[:, 0]) @ params["proj"]


def visual_forward(params, images, cfg: CLIPConfig):
    x = visual_embed(params, images, cfg)
    for bp in params["resblocks"]:
        x = resblock(bp, x, num_heads=cfg.vision_heads)
    return visual_project(params, x)


# ---------------------------------------------------------------------------
# text tower
# ---------------------------------------------------------------------------

def init_text(init: Init, cfg: CLIPConfig):
    w = cfg.text_width
    return {
        "token_embedding": init.normal((cfg.vocab_size, w), 0.02),
        "positional_embedding": init.normal((cfg.context_length, w), 0.01),
        "resblocks": [init_resblock(init, w) for _ in range(cfg.text_layers)],
        "ln_final": layer_norm_init(init, w),
        "text_projection": init.normal((w, cfg.embed_dim), w ** -0.5),
        "logit_scale": init.full((), float(torch.log(torch.tensor(1.0 / 0.07)))),
    }


def causal_mask(L, *, device, dtype=torch.float32):
    """(L, L): 0 on and below the diagonal, -inf above it."""
    return torch.full((L, L), float("-inf"), device=device, dtype=dtype).triu(1)


def encode_text_embeddings(params, prompt_embeds, tokenized, cfg: CLIPConfig):
    """The text tower over prompt embeddings (n, 77, width) already built
    (the prompt learner's path); `tokenized` (n, 77) int ids place each
    row's EOT token, their argmax. -> (n, embed_dim)."""
    x = prompt_embeds + params["positional_embedding"]
    mask = causal_mask(x.shape[1], device=x.device)
    for bp in params["resblocks"]:
        x = resblock(bp, x, num_heads=cfg.text_heads, mask=mask)
    x = layer_norm(params["ln_final"], x)
    eot = torch.as_tensor(tokenized, device=x.device).argmax(-1)
    return x[torch.arange(x.shape[0], device=x.device), eot] @ params["text_projection"]


def encode_text(params, tokenized, cfg: CLIPConfig):
    tokenized = torch.as_tensor(tokenized, device=params["token_embedding"].device).long()
    return encode_text_embeddings(params, params["token_embedding"][tokenized], tokenized, cfg)
