"""The reference's dormant alternate backbones (no live call site) over the
JAX package's trees (`dg_sct_tpu/models/legacy_backbones.py`):

  * the AST (audio spectrogram transformer): a DeiT-style ViT over mel
    spectrograms with cls and distillation tokens and overlapping 16x16
    patches at (fstride, tstride);
  * CLIP's ModifiedResNet: a 3-convolution stem, anti-aliased (average
    pool) downsampling and an attention-pool head;
  * AVENet: a 1-channel ResNet-18 VGGSound audio classifier.

Channels-last, BN with explicit state, the convolutions padded as torch
pads them (a 7x7/2 stem's pad 3 is not XLA's "SAME") through
`ops.basic.conv2d`. The trees keep the JAX package's non-array leaves
(`stride`, `heads`, `fstride`, `tstride`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.basic import (Init, avg_pool2d, batch_norm, batch_norm_init, conv2d, conv2d_init,
                         layer_norm, layer_norm_init, linear, linear_init, max_pool2d, mlp,
                         mlp_init)
from ..ops.mha import mha, mha_init

PAD1 = ((1, 1), (1, 1))


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

def ast_grid(input_fdim, input_tdim, fstride, tstride):
    """The patch grid of the 16x16 "VALID" convolution at (fstride, tstride)."""
    return (input_fdim - 16) // fstride + 1, (input_tdim - 16) // tstride + 1


def _resize_axis(g, axis, n):
    """Linear resize of one axis of g (a grid (H, W, D)) to n samples,
    half-pixel centres, upsampling only (no antialias)."""
    x = g.movedim(axis, -1)
    lead = x.shape[:-1]
    y = F.interpolate(x.reshape(1, -1, x.shape[-1]), size=n, mode="linear", align_corners=False)
    return y.reshape(lead + (n,)).movedim(-1, axis)


def adapt_pos_embed(pos_embed, old_hw, f_dim, t_dim):
    """DeiT's 2-D position embedding adapted to an (f_dim, t_dim) grid: the
    two special tokens kept, each grid axis centre-cropped when it shrinks
    and linearly resized (half-pixel) when it grows."""
    D = pos_embed.shape[-1]
    g = pos_embed[2:].reshape(old_hw, old_hw, D)
    if t_dim <= old_hw:
        s = old_hw // 2 - t_dim // 2
        g = g[:, s:s + t_dim]
    else:
        g = _resize_axis(g, 1, t_dim)
    if f_dim <= old_hw:
        s = old_hw // 2 - f_dim // 2
        g = g[s:s + f_dim]
    else:
        g = _resize_axis(g, 0, f_dim)
    return torch.cat([pos_embed[:2], g.reshape(f_dim * t_dim, D)], dim=0)


def init_ast(init: Init, *, label_dim=527, fstride=10, tstride=10, input_fdim=128,
             input_tdim=1024, embed_dim=768, depth=12, num_heads=12):
    f_dim, t_dim = ast_grid(input_fdim, input_tdim, fstride, tstride)
    blocks = [{"attn": mha_init(init, embed_dim),
               "mlp": mlp_init(init, embed_dim, 4 * embed_dim),
               "norm1": layer_norm_init(init, embed_dim),
               "norm2": layer_norm_init(init, embed_dim)} for _ in range(depth)]
    return {"patch_proj": conv2d_init(init, 16, 16, 1, embed_dim),
            "cls_token": init.trunc_normal((1, embed_dim)),
            "dist_token": init.trunc_normal((1, embed_dim)),
            "pos_embed": init.trunc_normal((f_dim * t_dim + 2, embed_dim)),
            "blocks": blocks,
            "norm": layer_norm_init(init, embed_dim),
            "mlp_head": {"norm": layer_norm_init(init, embed_dim),
                         "fc": linear_init(init, embed_dim, label_dim)},
            "fstride": fstride, "tstride": tstride}


def ast_forward(params, x, *, num_heads=12, additional_patch=None, apply_head=False):
    """x (B, time frames, freq bins), e.g. (12, 1024, 128) -> the mean of the
    cls and distillation embeddings (B, E); `apply_head` runs the mlp_head
    the reference leaves out."""
    B = x.shape[0]
    patches = conv2d(params["patch_proj"], x.transpose(1, 2)[..., None],
                     stride=(params["fstride"], params["tstride"]), padding="VALID")
    tok = patches.reshape(B, -1, patches.shape[-1])
    E = tok.shape[-1]
    h = torch.cat([params["cls_token"].expand(B, 1, E), params["dist_token"].expand(B, 1, E),
                   tok], dim=1) + params["pos_embed"]
    if additional_patch is not None:
        h = torch.cat([h, additional_patch], dim=1)
    h = h.transpose(0, 1)                                 # time-major for mha
    for blk in params["blocks"]:
        hn = layer_norm(blk["norm1"], h)
        h = h + mha(blk["attn"], hn, hn, hn, num_heads=num_heads)
        h = h + mlp(blk["mlp"], layer_norm(blk["norm2"], h))
    h = layer_norm(params["norm"], h.transpose(0, 1))
    out = (h[:, 0] + h[:, 1]) / 2.0
    if apply_head:
        out = linear(params["mlp_head"]["fc"], layer_norm(params["mlp_head"]["norm"], out))
    return out


# ---------------------------------------------------------------------------
# ModifiedResNet
# ---------------------------------------------------------------------------

def init_bottleneck(init: Init, inplanes, planes, stride=1):
    p = {"conv1": conv2d_init(init, 1, 1, inplanes, planes, bias=False),
         "conv2": conv2d_init(init, 3, 3, planes, planes, bias=False),
         "conv3": conv2d_init(init, 1, 1, planes, planes * 4, bias=False),
         "stride": stride}
    st = {}
    for name, d in (("bn1", planes), ("bn2", planes), ("bn3", planes * 4)):
        p[name], st[name] = batch_norm_init(init, d)
    if stride > 1 or inplanes != planes * 4:
        p["down_conv"] = conv2d_init(init, 1, 1, inplanes, planes * 4, bias=False)
        p["down_bn"], st["down_bn"] = batch_norm_init(init, planes * 4)
    return p, st


def bottleneck(p, st, x, *, train=False):
    new = {}
    out, new["bn1"] = batch_norm(p["bn1"], st["bn1"], conv2d(p["conv1"], x), train=train)
    out, new["bn2"] = batch_norm(p["bn2"], st["bn2"],
                                 conv2d(p["conv2"], torch.relu(out), padding=PAD1), train=train)
    out = torch.relu(out)
    if p["stride"] > 1:
        out = avg_pool2d(out, p["stride"])
    out, new["bn3"] = batch_norm(p["bn3"], st["bn3"], conv2d(p["conv3"], out), train=train)
    identity = x
    if "down_conv" in p:
        identity = x if p["stride"] == 1 else avg_pool2d(x, p["stride"])
        identity, new["down_bn"] = batch_norm(p["down_bn"], st["down_bn"],
                                              conv2d(p["down_conv"], identity), train=train)
    return torch.relu(out + identity), new


def init_attention_pool(init: Init, spacial_dim, embed_dim, output_dim=None):
    return {"pos": init.normal((spacial_dim ** 2 + 1, embed_dim), 1.0 / embed_dim ** 0.5),
            "q": linear_init(init, embed_dim, embed_dim),
            "k": linear_init(init, embed_dim, embed_dim),
            "v": linear_init(init, embed_dim, embed_dim),
            "c": linear_init(init, embed_dim, output_dim or embed_dim)}


def attention_pool(p, x, *, num_heads):
    """x (B, H, W, C) -> (B, out): the mean token prepended, position
    embeddings added, the mean token's query against every position."""
    B, H, W, C = x.shape
    t = x.reshape(B, H * W, C)
    t = torch.cat([t.mean(1, keepdim=True), t], dim=1) + p["pos"]
    d = C // num_heads
    split = lambda pp, z: linear(pp, z).reshape(B, -1, num_heads, d).transpose(1, 2)
    q, k, v = split(p["q"], t[:, :1]), split(p["k"], t), split(p["v"], t)
    attn = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d), dim=-1)
    ctx = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(B, C)
    return linear(p["c"], ctx)


def init_modified_resnet(init: Init, layers=(3, 4, 6, 3), output_dim=1024, heads=32,
                         input_resolution=224, width=64):
    """RN50 by default. Returns (params, state)."""
    p = {"conv1": conv2d_init(init, 3, 3, 3, width // 2, bias=False),
         "conv2": conv2d_init(init, 3, 3, width // 2, width // 2, bias=False),
         "conv3": conv2d_init(init, 3, 3, width // 2, width, bias=False)}
    st = {}
    for name, d in (("bn1", width // 2), ("bn2", width // 2), ("bn3", width)):
        p[name], st[name] = batch_norm_init(init, d)
    inplanes = width
    for li, (n_blocks, planes, stride) in enumerate(
            zip(layers, (width, width * 2, width * 4, width * 8), (1, 2, 2, 2))):
        blocks, bstates = [], []
        for b in range(n_blocks):
            bp, bs = init_bottleneck(init, inplanes, planes, stride if b == 0 else 1)
            inplanes = planes * 4
            blocks.append(bp)
            bstates.append(bs)
        p[f"layer{li + 1}"], st[f"layer{li + 1}"] = blocks, bstates
    p["attnpool"] = init_attention_pool(init, input_resolution // 32, width * 32, output_dim)
    p["heads"] = heads
    return p, st


def modified_resnet(p, st, x, *, train=False):
    """x (B, H, W, 3) -> ((B, output_dim), new state)."""
    new = {}
    for cn, bn, s in (("conv1", "bn1", 2), ("conv2", "bn2", 1), ("conv3", "bn3", 1)):
        x, new[bn] = batch_norm(p[bn], st[bn], conv2d(p[cn], x, stride=s, padding=PAD1),
                                train=train)
        x = torch.relu(x)
    x = avg_pool2d(x, 2)
    for li in range(1, 5):
        new[f"layer{li}"] = []
        for bp, bs in zip(p[f"layer{li}"], st[f"layer{li}"]):
            x, nb = bottleneck(bp, bs, x, train=train)
            new[f"layer{li}"].append(nb)
    return attention_pool(p["attnpool"], x, num_heads=p["heads"]), new


# ---------------------------------------------------------------------------
# AVENet (1-channel ResNet-18)
# ---------------------------------------------------------------------------

def init_basic_block(init: Init, inplanes, planes, stride=1):
    p = {"conv1": conv2d_init(init, 3, 3, inplanes, planes, bias=False),
         "conv2": conv2d_init(init, 3, 3, planes, planes, bias=False),
         "stride": stride}
    st = {}
    p["bn1"], st["bn1"] = batch_norm_init(init, planes)
    p["bn2"], st["bn2"] = batch_norm_init(init, planes)
    if stride != 1 or inplanes != planes:
        p["down_conv"] = conv2d_init(init, 1, 1, inplanes, planes, bias=False)
        p["down_bn"], st["down_bn"] = batch_norm_init(init, planes)
    return p, st


def basic_block(p, st, x, *, train=False):
    new = {}
    out, new["bn1"] = batch_norm(p["bn1"], st["bn1"],
                                 conv2d(p["conv1"], x, stride=p["stride"], padding=PAD1),
                                 train=train)
    out, new["bn2"] = batch_norm(p["bn2"], st["bn2"],
                                 conv2d(p["conv2"], torch.relu(out), padding=PAD1), train=train)
    identity = x
    if "down_conv" in p:
        identity, new["down_bn"] = batch_norm(p["down_bn"], st["down_bn"],
                                              conv2d(p["down_conv"], x, stride=p["stride"]),
                                              train=train)
    return torch.relu(out + identity), new


def init_avenet(init: Init, num_classes=309):
    """resnet18(num_classes=309, pool="avgpool") over 1-channel
    spectrograms. Returns (params, state)."""
    p = {"conv1": conv2d_init(init, 7, 7, 1, 64, bias=False)}
    st = {}
    p["bn1"], st["bn1"] = batch_norm_init(init, 64)
    inplanes = 64
    for li, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
        blocks, bstates = [], []
        for b in range(2):
            bp, bs = init_basic_block(init, inplanes, planes, stride if b == 0 else 1)
            inplanes = planes
            blocks.append(bp)
            bstates.append(bs)
        p[f"layer{li + 1}"], st[f"layer{li + 1}"] = blocks, bstates
    p["fc"] = linear_init(init, 512, num_classes)
    return p, st


def avenet(p, st, audio, *, train=False):
    """audio (B, F, T) or (B, F, T, 1) log-mel -> ((B, num_classes), new
    state)."""
    x = audio if audio.ndim == 4 else audio[..., None]
    new = {}
    x, new["bn1"] = batch_norm(p["bn1"], st["bn1"],
                               conv2d(p["conv1"], x, stride=2, padding=((3, 3), (3, 3))),
                               train=train)
    x = max_pool2d(torch.relu(x), 3, 2, PAD1)
    for li in range(1, 5):
        new[f"layer{li}"] = []
        for bp, bs in zip(p[f"layer{li}"], st[f"layer{li}"]):
            x, nb = basic_block(bp, bs, x, train=train)
            new[f"layer{li}"].append(nb)
    return linear(p["fc"], x.mean((1, 2))), new
