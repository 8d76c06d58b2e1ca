"""DG-SCT cross-modal prompt adapter (`VisualAdapter`), AVE and AVS variants.

Tokens stay in (B, N, C) layout and every 1x1 conv is a matmul. Stages:
  1. resample the other modality's tokens to (N, C): token map + channel map,
     in whichever order costs fewer FLOPs (an exact reorder); the AVS
     variant aligns channels first, then resizes the tokens bicubically on
     the sqrt(M) -> sqrt(N) grid (its token map is dead weight);
  2. latent-token two-hop cross attention, gated by `gate_av`;
  3. channel attention (query: the other modality's mean token);
  4. spatial attention; its softmax(tanh) map is also the tower's pooling map;
  5. LN -> grouped bottleneck down/BN/ReLU/up/BN -> LN -> gate. After
     `fold_eval` this stage runs as K3 when kernels are on. The AVS variant
     has no LN before, gates before the last LN and never runs K3, as the
     JAX package routes it.
Every 2-D linear of stages 1-4 goes through `ops.basic.linear`, so a tree
quantized by `ops.quant` runs them in int8 (K4 when kernels are on).
Only stage 5's output is the residual added to the tower stream.
"""
from __future__ import annotations

import functools

import torch

from ..configs import AdapterConfig
from ..ops import dsp
from ..ops.basic import (Init, batch_norm, batch_norm_init, grouped_linear,
                         grouped_linear_init, layer_norm, layer_norm_init, linear,
                         linear_init)
from ..ops.kernels.adapter_bottleneck import fused_bottleneck


def init_adapter(init: Init, *, dim, other_dim, num_tokens_self, num_tokens_other,
                 cfg: AdapterConfig):
    """One adapter: `dim`/`num_tokens_self` describe this tower's stream x,
    `other_dim`/`num_tokens_other` the prompting modality."""
    down = dim // cfg.reduction_factor
    d_model = dim // 2
    params = {
        "token_resample": linear_init(init, num_tokens_other, num_tokens_self),
        "chan_align": linear_init(init, other_dim, dim),
        "latent_tokens": init.uniform((cfg.num_tokens, dim)),
        "gate_av": init.zeros((1,)),
        "aff_audio_1": linear_init(init, dim, dim),
        "aff_video_1": linear_init(init, dim, dim),
        "aff_bottleneck": linear_init(init, dim, d_model),
        "aff_video_2": linear_init(init, dim, d_model),
        "aff_audio_2": linear_init(init, dim, d_model),
        "aff_v_s_att": linear_init(init, d_model, 1),
        "aff_v_c_att": linear_init(init, d_model, dim),
        "down": grouped_linear_init(init, dim, down, cfg.num_conv_group),
        "up": grouped_linear_init(init, down, dim, cfg.num_conv_group),
    }
    if cfg.use_gate:
        params["gate"] = init.zeros((1,))
    state = {}
    if cfg.use_bn:
        params["bn1"], state["bn1"] = batch_norm_init(init, down)
        params["bn2"], state["bn2"] = batch_norm_init(init, dim)
    if cfg.is_before_layernorm:
        params["ln_before"] = layer_norm_init(init, dim)
    if cfg.is_post_layernorm:
        params["ln_post"] = layer_norm_init(init, dim)
    return params, state


def fold_eval(params, state, cfg: AdapterConfig):
    """Serving-time transform, exact in eval: the BN affines go into the
    bottleneck kernels and biases, the scalar gate into ln_post. Returns
    (params, state) with the folded leaves removed."""
    p, s = dict(params), dict(state)
    if cfg.use_bn and "bn1" in p:
        for bn_name, gemm in (("bn1", "down"), ("bn2", "up")):
            bp, bs = p.pop(bn_name), s.pop(bn_name)
            rs = bp["scale"] / torch.sqrt(bs["var"] + 1e-5)
            gp = dict(p[gemm])
            g, _, go = gp["kernel"].shape
            inv = rs.to(gp["kernel"].dtype)
            gp["kernel"] = gp["kernel"] * inv.reshape(g, 1, go)
            bias = bp["bias"] - bs["mean"] * rs
            if "bias" in gp:
                bias = bias + gp["bias"] * inv
            gp["bias"] = bias.to(gp["kernel"].dtype)
            p[gemm] = gp
    # gate * ln_post(x) == ln_post with (scale * g, bias * g): AVE epilogue order
    if cfg.use_gate and "gate" in p and cfg.is_post_layernorm and not cfg.avs_variant:
        g = p.pop("gate")
        p["ln_post"] = {"scale": p["ln_post"]["scale"] * g, "bias": p["ln_post"]["bias"] * g}
    return p, s


def _token_linear(p, x, *, with_bias=True, kernels=True):
    """Apply a (M, N) token-axis map to x (B, M, D) -> (B, N, D) through
    `linear`, so a quantized map runs int8 with its rows over the token axis
    (`dg_sct_tpu/models/adapter.py:130`)."""
    if not with_bias and "bias" in p:
        p = {k: v for k, v in p.items() if k != "bias"}
    return linear(p, x.transpose(-1, -2), kernels=kernels).transpose(-1, -2)


def _kernel_f32(p):
    """The kernel of a float or a quantized linear: "kernel" itself, or
    kernel_q * kscale in float32."""
    if "kernel_q" in p:
        return p["kernel_q"].to(torch.float32) * p["kscale"][None, :]
    return p["kernel"]


def _channels(p, sl):
    """A BN's or a grouped linear's bias cut to the channels `sl`; a grouped
    kernel is kept (it is this rank's groups already)."""
    return {k: (v if k == "kernel" or k == "count" else v[sl]) for k, v in p.items()}


def _split_bottleneck(params, state, z, cfg: AdapterConfig, tp):
    """Stage 5's products on this rank's groups of a tensor-parallel split
    (eval): its input channels through its down and up kernels and their BN
    channels, then the channels of every rank gathered (before LN_post)."""
    C = z.shape[-1]
    cin = tp.share(C)
    dsl = tp.share(params["down"]["kernel"].shape[2] * cfg.num_conv_group)
    h = grouped_linear(_channels(params["down"], dsl), z[..., cin])
    if cfg.use_bn and "bn1" in params:
        h, _ = batch_norm(_channels(params["bn1"], dsl), _channels(state["bn1"], dsl), h)
    out = grouped_linear(_channels(params["up"], cin), torch.relu(h))
    if cfg.use_bn and "bn2" in params:
        out, _ = batch_norm(_channels(params["bn2"], cin), _channels(state["bn2"], cin), out)
    return tp.gather_channels(out)


def adapter(params, state, x, other, cfg: AdapterConfig, *, kernels=True, train=False,
            group=None, tp=None):
    """x: (B, N, C) this tower's tokens; other: (B, M, D) prompting tokens.
    Returns (residual (B, N, C), spatial maps (B, 1, N), new state); in
    training bn1 and bn2 normalize with the batch's statistics (the global
    batch's under data parallelism over `group`) and the new state holds
    their updated running stats. `tp`: an eval forward whose bottleneck
    kernels are this rank's groups (`parallel.tp`)."""
    B, N, C = x.shape
    M, D = other.shape[1], other.shape[2]

    # ---- stage 1: resample prompts to (B, N, C), cheaper order first ------------
    lin = functools.partial(linear, kernels=kernels)
    if cfg.avs_variant:
        s_in, s_out = int(M ** 0.5), int(N ** 0.5)
        aligned = lin(params["chan_align"], other).reshape(B, s_in, s_in, C)
        prompts = dsp.resize_2d(aligned, s_out, s_out, kernel="cubic",
                                align_corners=False).reshape(B, N, C)
    elif M * N * D + N * D * C <= M * D * C + M * N * C:
        prompts = lin(params["chan_align"],
                      _token_linear(params["token_resample"], other, kernels=kernels))
    else:
        # exact reorder: align(resample(x) + bias_n) =
        #   resample(x @ W) + bias_n * colsum(W) + b_c
        ca = params["chan_align"]
        aligned = lin({k: v for k, v in ca.items() if k != "bias"}, other)
        prompts = _token_linear(params["token_resample"], aligned, with_bias=False,
                                kernels=kernels)
        wsum = _kernel_f32(ca).sum(0).to(x.dtype)
        prompts = (prompts + params["token_resample"]["bias"][None, :, None] * wsum[None, None, :]
                   + ca["bias"])

    # ---- stage 2: latent-token two-hop attention -----------------------------------
    tok = params["latent_tokens"]                                          # (T, C)
    att_v2tk = torch.softmax(torch.einsum("tc,bnc->btn", tok, prompts), dim=-1)
    rep = tok[None] + torch.einsum("btn,bnc->btc", att_v2tk, prompts)
    att_tk2x = torch.softmax(torch.einsum("bnc,btc->bnt", x, rep), dim=-1)
    x = x + params["gate_av"] * torch.einsum("bnt,btc->bnc", att_tk2x, rep)

    # ---- stage 3: channel attention -------------------------------------------------
    other_mean = prompts.mean(1)                                           # (B, C)
    q_a = torch.relu(lin(params["aff_audio_1"], other_mean))[:, None, :]
    q_v = torch.relu(lin(params["aff_video_1"], x))
    joint = torch.relu(lin(params["aff_bottleneck"], (q_a * q_v).mean(1)))
    ch_map = torch.sigmoid(lin(params["aff_v_c_att"], joint))[:, None, :]  # (B, 1, C)
    x_ch = x * (ch_map + 1.0)

    # ---- stage 4: spatial attention -------------------------------------------------
    q_v2 = torch.relu(lin(params["aff_video_2"], x_ch))
    q_a2 = torch.relu(lin(params["aff_audio_2"], other_mean))[:, None, :]
    sp_logits = lin(params["aff_v_s_att"], q_v2 * q_a2)                   # (B, N, 1)
    sp_maps = torch.softmax(torch.tanh(sp_logits).transpose(1, 2), dim=-1)  # (B, 1, N)
    x = x * (cfg.alpha * ch_map + cfg.beta * torch.sigmoid(sp_logits) + 1.0 - cfg.alpha)

    # ---- stage 5: bottleneck --------------------------------------------------------
    folded = "bn1" not in params and "bn2" not in params and "gate" not in params
    split = tp is not None and tp.splits(cfg.num_conv_group)
    if (kernels and not train and folded and not split and cfg.is_post_layernorm
            and not cfg.avs_variant):
        return fused_bottleneck(params, x, has_ln1=cfg.is_before_layernorm), sp_maps, state
    ln_before = cfg.is_before_layernorm and not cfg.avs_variant
    z = layer_norm(params["ln_before"], x) if ln_before else x
    new_state = dict(state)
    if split:
        out = _split_bottleneck(params, state, z, cfg, tp)
    else:
        h = grouped_linear(params["down"], z)
        if cfg.use_bn and "bn1" in params:
            h, new_state["bn1"] = batch_norm(params["bn1"], state["bn1"], h, train=train,
                                             axis=-1, group=group)
        out = grouped_linear(params["up"], torch.relu(h))
        if cfg.use_bn and "bn2" in params:
            out, new_state["bn2"] = batch_norm(params["bn2"], state["bn2"], out, train=train,
                                               axis=-1, group=group)
    gate = cfg.use_gate and "gate" in params
    if gate and cfg.avs_variant:
        out = params["gate"] * out
    if cfg.is_post_layernorm:
        out = layer_norm(params["ln_post"], out)
    if gate and not cfg.avs_variant:
        out = params["gate"] * out
    return out, sp_maps, new_state
