"""TPAVI: temporal pixel-wise audio-visual non-local attention of the AVS
model, 'dot' mode with a BN'd output projection (DG-SCT's `TPAVIModule`,
as `dg_sct_tpu/models/tpavi.py` rebuilds it). Channels-last (B, T, H, W, C)
throughout; every 1x1x1 convolution is a channel matmul.
"""
from __future__ import annotations

import torch

from ..ops.basic import (Init, batch_norm, batch_norm_init, layer_norm, layer_norm_init,
                         linear, linear_init)


def init_tpavi(init: Init, in_channels):
    inter = in_channels // 2
    params = {
        "align_channel": linear_init(init, in_channels // 2, in_channels),
        "norm_layer": layer_norm_init(init, in_channels),
        "g": linear_init(init, in_channels, inter),
        "theta": linear_init(init, in_channels, inter),
        "phi": linear_init(init, in_channels, inter),
        "W_z": linear_init(init, inter, in_channels),
    }
    bn_p, bn_s = batch_norm_init(init, in_channels)
    # the reference zero-inits the BN scale and bias: the block starts as LN(x)
    params["bn"] = {"scale": init.zeros((in_channels,)), "bias": bn_p["bias"]}
    return params, {"bn": bn_s}


def tpavi(params, state, x, audio=None, *, train=False, group=None):
    """x (B, T, H, W, C); audio (B, T, C/2), or None for video self-attention.
    Returns (z (B, T, H, W, C), the aligned audio (B, T, C) or None, new
    state). f = theta(x) phi(kv)^T / THW in float32 (JAX's
    `preferred_element_type`), cast to x's type before y = f g(x). `group`:
    data parallelism, the BN's training statistics over the global batch."""
    B, T, H, W, C = x.shape
    thw = T * H * W
    audio_aligned = None
    if audio is not None:
        audio_aligned = linear(params["align_channel"], audio)            # (B, T, C)
        # the keys are the aligned audio broadcast over H, W: phi of each
        # frame's one row, broadcast (phi acts row by row, so this is exact)
        phi_x = linear(params["phi"], audio_aligned)[:, :, None, None, :].expand(
            B, T, H, W, -1)
    else:
        phi_x = linear(params["phi"], x)
    phi_x = phi_x.reshape(B, thw, -1)
    g_x = linear(params["g"], x).reshape(B, thw, -1)
    theta_x = linear(params["theta"], x).reshape(B, thw, -1)
    f = torch.bmm(theta_x.float(), phi_x.float().transpose(1, 2)) / thw
    y = torch.bmm(f.to(x.dtype), g_x).reshape(B, T, H, W, -1)
    w_y, bn_state = batch_norm(params["bn"], state["bn"], linear(params["W_z"], y),
                               train=train, axis=-1, group=group)
    z = layer_norm(params["norm_layer"], w_y + x)
    return z, audio_aligned, {"bn": bn_state}
