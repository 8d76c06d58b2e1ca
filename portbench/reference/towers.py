"""The plain float32 forward of DG-SCT's encoder, in eval: the audio
frontend, Swin-V2-L (timm 0.6.12 `swinv2_large_window12_192_22k`),
HTS-AT, the cross-modal `VisualAdapter`s between paired blocks, and the
spatial pooling by the last adapters' maps.

Written from the releases' definitions, not from the program: torch's own
STFT, `F.interpolate`, `F.layer_norm`, `F.conv2d` and `F.normalize` where
the releases call them, BatchNorm in eval from its running statistics (no
fold), the adapters' prompts resampled in the releases' order, GELU as the
configuration states. Every tensor is float32; `bench` turns TF32 off.
Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import params as P
from .config import paired_layout

ADKEYS = ("a_p1", "v_p1", "a_p2", "v_p2")


# ---------------------------------------------------------------------------
# weights: the trees both sides are given
# ---------------------------------------------------------------------------

def _swin_block(init, dim, heads, hidden, v2):
    if v2:
        attn = {"qkv": {"kernel": init.fan_in((dim, 3 * dim), dim)},
                "q_bias": init.sym((dim,), 0.02), "v_bias": init.sym((dim,), 0.02),
                "logit_scale": init.uniform((heads, 1, 1), math.log(8.0), math.log(12.0)),
                "cpb_fc1": P.linear(init, 2, 512),
                "cpb_fc2": {"kernel": init.fan_in((512, heads), 512)},
                "proj": P.linear(init, dim, dim)}
        return {"attn": attn, "norm1": P.layer_norm(init, dim), "mlp": P.mlp(init, dim, hidden),
                "norm2": P.layer_norm(init, dim)}
    return {"norm1": P.layer_norm(init, dim), "attn": None, "norm2": P.layer_norm(init, dim),
            "mlp": P.mlp(init, dim, hidden)}


def init_swin(init, c):
    out = {"patch_embed": P.patch_embed(init, c.patch_size, 3, c.embed_dim)}
    layers = []
    for s, stage in enumerate(c.plan()):
        st = {"blocks": [_swin_block(init, m["dim"], m["heads"], m["hidden"], True)
                         for m in stage]}
        if s < c.num_layers - 1:
            d = c.stage_dim(s)
            st["downsample"] = {"reduction": {"kernel": init.sym((4 * d, 2 * d), 0.02 * 3 ** 0.5)},
                                "norm": P.layer_norm(init, 2 * d)}
        layers.append(st)
    out["layers"] = layers
    out["norm"] = P.layer_norm(init, c.num_features)
    return out


def init_htsat(init, c):
    """(params, state). The token-semantic head's leaves are kept so the
    tree is the release's; no forward here reads them."""
    out = {"patch_embed": P.patch_embed(init, c.patch_size, 1, c.embed_dim)}
    bn0, bn0_state = P.batch_norm(init, c.frontend.mel_bins)
    out["bn0"] = bn0
    bn0_state["mean"] = init.uniform((c.frontend.mel_bins,), -40.0, -20.0)
    bn0_state["var"] = init.uniform((c.frontend.mel_bins,), 100.0, 400.0)
    layers = []
    for s, stage in enumerate(c.plan()):
        blocks = []
        for m in stage:
            b = _swin_block(init, m["dim"], m["heads"], m["hidden"], False)
            b["attn"] = {"qkv": P.linear(init, m["dim"], 3 * m["dim"]),
                         "proj": P.linear(init, m["dim"], m["dim"]),
                         "rpb_table": init.sym(((2 * m["ws"] - 1) ** 2, m["heads"]),
                                               0.02 * 3 ** 0.5)}
            blocks.append({k: b[k] for k in ("norm1", "attn", "norm2", "mlp")})
        st = {"blocks": blocks}
        if s < c.num_layers - 1:
            d = c.stage_dim(s)
            st["downsample"] = {"norm": P.layer_norm(init, 4 * d),
                                "reduction": {"kernel": init.sym((4 * d, 2 * d), 0.02 * 3 ** 0.5)}}
        layers.append(st)
    out["layers"] = layers
    out["norm"] = P.layer_norm(init, c.num_features)
    last = c.spec_size // c.patch_size // 2 ** (c.num_layers - 1)
    bins = max(last // c.patch_stride[0] // c.frontend.freq_ratio, 1)
    out["tscam_conv"] = {"kernel": init.sym((bins, 3, c.num_features, c.num_classes), 0.02),
                         "bias": init.sym((c.num_classes,), 0.02)}
    out["head"] = P.linear(init, c.num_classes, c.num_classes)
    return out, {"bn0": bn0_state}


def init_adapter(init, dim, other_dim, n_self, n_other, a):
    down = dim // a.reduction_factor
    d_model = dim // 2
    p = {"token_resample": P.linear(init, n_other, n_self),
         "chan_align": P.linear(init, other_dim, dim),
         "latent_tokens": init.uniform((a.num_tokens, dim), 0.0, 1.0),
         "gate_av": init.uniform((1,), 0.2, 0.6),
         "aff_audio_1": P.linear(init, dim, dim),
         "aff_video_1": P.linear(init, dim, dim),
         "aff_bottleneck": P.linear(init, dim, d_model),
         "aff_video_2": P.linear(init, dim, d_model),
         "aff_audio_2": P.linear(init, dim, d_model),
         "aff_v_s_att": P.linear(init, d_model, 1),
         "aff_v_c_att": P.linear(init, d_model, dim),
         "down": P.grouped(init, dim, down, a.num_conv_group),
         "up": P.grouped(init, down, dim, a.num_conv_group)}
    if a.use_gate:
        p["gate"] = init.uniform((1,), 0.2, 0.6)
    s = {}
    if a.use_bn:
        p["bn1"], s["bn1"] = P.batch_norm(init, down)
        p["bn2"], s["bn2"] = P.batch_norm(init, dim)
    if a.is_before_layernorm:
        p["ln_before"] = P.layer_norm(init, dim)
    if a.is_post_layernorm:
        p["ln_post"] = P.layer_norm(init, dim)
    return p, s


def init_adapters(init, cfg):
    params = {k: [] for k in ADKEYS}
    state = {k: [] for k in ADKEYS}
    for s, stage in enumerate(paired_layout(cfg)):
        vd, ad = cfg.swin.stage_dim(s), cfg.htsat.stage_dim(s)
        vn = math.prod(cfg.swin.stage_resolution(s))
        an = math.prod(cfg.htsat.stage_resolution(s))
        for _ in (e for e in stage if e[2] is not None):
            for k in ("a_p1", "a_p2"):
                p, st = init_adapter(init, ad, vd, an, vn, cfg.adapter)
                params[k].append(p)
                state[k].append(st)
            for k in ("v_p1", "v_p2"):
                p, st = init_adapter(init, vd, ad, vn, an, cfg.adapter_vis)
                params[k].append(p)
                state[k].append(st)
    return params, state


# ---------------------------------------------------------------------------
# plain ops
# ---------------------------------------------------------------------------

def linear(p, x):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def batch_norm(p, s, x, eps=1e-5):
    """Eval BatchNorm over the last axis, from the running statistics."""
    return (x - s["mean"]) / torch.sqrt(s["var"] + eps) * p["scale"] + p["bias"]


def gelu(x, mode):
    return F.gelu(x, approximate="tanh" if mode == "tanh" else "none")


def mlp(p, x, mode):
    return linear(p["fc2"], gelu(linear(p["fc1"], x), mode))


def grouped(p, x):
    """A 1x1 convolution with `g` groups over the last axis."""
    g, gi, go = p["kernel"].shape
    y = torch.einsum("...gi,gio->...go", x.unflatten(-1, (g, gi)), p["kernel"])
    return y.flatten(-2)


def patch_embed(p, x):
    """(N, H, W, C) -> (N, (H/k)(W/k), E): the stride-k patch convolution."""
    w = p["kernel"].permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["bias"], stride=w.shape[-1])
    y = y.flatten(2).transpose(1, 2)
    return layer_norm(p["norm"], y) if "norm" in p else y


def interpolate(x, size, mode, align_corners):
    """(N, H, W, C) -> (N, h, w, C) by `F.interpolate`."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode=mode, align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def merge_2x2(x, res):
    """(B, H*W, C) -> (B, H/2*W/2, 4C): timm's x0, x1, x2, x3 =
    x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]."""
    H, W = res
    x = x.reshape(x.shape[0], H, W, -1)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return x.reshape(x.shape[0], -1, x.shape[-1])


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def relative_index(ws, device):
    c = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1).to(device)


def shift_mask(H, W, ws, shift, device):
    """(nW, ws*ws, ws*ws): -100 between tokens of different regions."""
    img = torch.zeros(H, W)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(device)


def windowed(attn, x, m):
    """x (B, H*W, C) -> cyclic shift, windows, `attn(windows, mask)`,
    windows back, shift back."""
    H, W = m["res"]
    ws, shift = m["ws"], m["shift"]
    B, L, C = x.shape
    xs = x.reshape(B, H, W, C)
    mask = None
    if shift:
        xs = torch.roll(xs, (-shift, -shift), (1, 2))
        mask = shift_mask(H, W, ws, shift, x.device)
    w = xs.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
    w = attn(w, mask)
    xs = w.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    if shift:
        xs = torch.roll(xs, (shift, shift), (1, 2))
    return xs.reshape(B, L, C)


def _attend(q, k, v, bias, mask):
    """q (Bw, h, N, d) scaled, bias (h, N, N), mask (nW, N, N) or None."""
    a = q @ k.transpose(-1, -2) + bias
    if mask is not None:
        nW = mask.shape[0]
        a = (a.unflatten(0, (-1, nW)) + mask[None, :, None]).flatten(0, 1)
    return torch.softmax(a, -1) @ v


def v1_attention(p, w, mask, heads):
    """HTS-AT's window attention: scaled dot product plus the relative
    position bias table."""
    Bw, N, C = w.shape
    ws = math.isqrt(N)
    q, k, v = linear(p["qkv"], w).reshape(Bw, N, 3, heads, -1).permute(2, 0, 3, 1, 4)
    bias = p["rpb_table"][relative_index(ws, w.device)].reshape(N, N, heads).permute(2, 0, 1)
    out = _attend(q * (C // heads) ** -0.5, k, v, bias, mask)
    return linear(p["proj"], out.transpose(1, 2).reshape(Bw, N, C))


def cpb_coords(ws, pretrained_ws, device):
    r = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)
    t = t / ((pretrained_ws if pretrained_ws > 0 else ws) - 1) * 8.0
    t = torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8.0)
    return t.reshape(-1, 2).to(device)


def v2_attention(p, w, mask, heads, pretrained_ws):
    """Swin-V2's window attention: scaled cosine similarity with a clamped
    learnt temperature plus 16 sigmoid(log-spaced CPB MLP)."""
    Bw, N, C = w.shape
    ws = math.isqrt(N)
    bias_qkv = torch.cat([p["q_bias"], torch.zeros_like(p["v_bias"]), p["v_bias"]])
    qkv = (w @ p["qkv"]["kernel"] + bias_qkv).reshape(Bw, N, 3, heads, -1)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    scale = torch.exp(torch.clamp(p["logit_scale"], max=math.log(100.0)))
    qn, kn = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
    cpb = linear(p["cpb_fc2"], torch.relu(linear(p["cpb_fc1"], cpb_coords(ws, pretrained_ws,
                                                                              w.device))))
    bias = 16.0 * torch.sigmoid(cpb[relative_index(ws, w.device)].reshape(N, N, heads)
                                .permute(2, 0, 1))
    out = _attend(qn * scale, kn, v, bias, mask)
    return linear(p["proj"], out.transpose(1, 2).reshape(Bw, N, C))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def swin_attn_half(p, x, m):
    """Swin-V2's post-norm attention half: x + norm1(attn(x))."""
    attn = lambda w, mask: v2_attention(p["attn"], w, mask, m["heads"], m["pretrained_ws"])
    return x + layer_norm(p["norm1"], windowed(attn, x, m))


def swin_mlp_half(p, x, mode):
    return x + layer_norm(p["norm2"], mlp(p["mlp"], x, mode))


def htsat_block(p, x, m, mode):
    """HTS-AT's pre-norm block."""
    attn = lambda w, mask: v1_attention(p["attn"], w, mask, m["heads"])
    x = x + windowed(attn, layer_norm(p["norm1"], x), m)
    return x + mlp(p["mlp"], layer_norm(p["norm2"], x), mode)


def adapter(p, s, x, other, a):
    """DG-SCT's `VisualAdapter` in eval -> (residual (B, N, C), spatial map
    (B, 1, N)). x: this tower's tokens (B, N, C); other: the prompting
    tower's (B, M, D)."""
    B, N, C = x.shape
    M = other.shape[1]
    if a.avs_variant:  # channels first, then the tokens resized on their grid
        g_in, g_out = math.isqrt(M), math.isqrt(N)
        aligned = linear(p["chan_align"], other).reshape(B, g_in, g_in, C)
        prompts = interpolate(aligned, (g_out, g_out), "bicubic", False).reshape(B, N, C)
    else:  # token map, then channel map
        prompts = linear(p["chan_align"], linear(p["token_resample"], other.transpose(1, 2))
                         .transpose(1, 2))
    tok = p["latent_tokens"]
    att = torch.softmax(torch.einsum("tc,bnc->btn", tok, prompts), -1)
    rep = tok[None] + att @ prompts
    att = torch.softmax(x @ rep.transpose(1, 2), -1)
    x = x + p["gate_av"] * (att @ rep)

    other_mean = prompts.mean(1)
    q_a = torch.relu(linear(p["aff_audio_1"], other_mean))[:, None]
    q_v = torch.relu(linear(p["aff_video_1"], x))
    joint = torch.relu(linear(p["aff_bottleneck"], (q_a * q_v).mean(1)))
    ch = torch.sigmoid(linear(p["aff_v_c_att"], joint))[:, None]
    x_ch = x * (ch + 1.0)
    q_v2 = torch.relu(linear(p["aff_video_2"], x_ch))
    q_a2 = torch.relu(linear(p["aff_audio_2"], other_mean))[:, None]
    sp = linear(p["aff_v_s_att"], q_v2 * q_a2)
    sp_map = torch.softmax(torch.tanh(sp).transpose(1, 2), -1)
    x = x * (a.alpha * ch + a.beta * torch.sigmoid(sp) + 1.0 - a.alpha)

    z = layer_norm(p["ln_before"], x) if a.is_before_layernorm and not a.avs_variant else x
    h = grouped(p["down"], z)
    if a.use_bn:
        h = batch_norm(p["bn1"], s["bn1"], h)
    out = grouped(p["up"], torch.relu(h))
    if a.use_bn:
        out = batch_norm(p["bn2"], s["bn2"], out)
    if a.use_gate and a.avs_variant:
        out = p["gate"] * out
    if a.is_post_layernorm:
        out = layer_norm(p["ln_post"], out)
    if a.use_gate and not a.avs_variant:
        out = p["gate"] * out
    return out, sp_map


# ---------------------------------------------------------------------------
# the audio frontend
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep,
                    3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)


def mel_bank(sr, n_fft, n_mels, fmin, fmax):
    """librosa's slaney mel filters, (n_fft/2 + 1, n_mels)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]
    return torch.as_tensor(w.T, dtype=torch.float32)


def mel_image(p, s, wave, c):
    """wave (N, L) -> the HTS-AT mel image (N, spec, spec, 1):
    torchlibrosa's STFT (hann, centre, reflect) power, slaney log-mel (ref 1,
    no top_db), bn0, then HTS-AT's `reshape_wav2img`."""
    fe = c.frontend
    win = torch.hann_window(fe.n_fft, device=wave.device)
    spec = torch.stft(wave, fe.n_fft, fe.hop_size, window=win, center=True, pad_mode="reflect",
                      return_complex=True)
    power = torch.view_as_real(spec).square().sum(-1).transpose(1, 2)       # (N, T, F)
    bank = mel_bank(fe.sample_rate, fe.n_fft, fe.mel_bins, fe.fmin, fe.fmax).to(wave.device)
    x = 10.0 * torch.log10(torch.clamp(power @ bank, min=fe.amin))
    x = batch_norm(p["bn0"], s["bn0"], x)
    N, T, Fm = x.shape
    if T < fe.target_t:
        x = F.interpolate(x[:, None], (fe.target_t, Fm), mode="bicubic", align_corners=True)[:, 0]
    fr = fe.freq_ratio
    x = x.transpose(1, 2).reshape(N, Fm, fr, fe.target_t // fr).transpose(1, 2)
    return x.reshape(N, fr * Fm, fe.target_t // fr, 1)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def encoder(params, state, wave, images, cfg, *, taps=False):
    """wave (N, L), images (N, H, W, 3) normalized, N = clips x frames ->
    {"f_v" (N, 1, Cv), "f_a" (N, 1, Ca)} and, with `taps`, "taps": the
    visual tokens at the end of each stage before its merge, the last one
    through the final norm."""
    sw, ht = params["swin"], params["htsat"]
    f_v = patch_embed(sw["patch_embed"], images)
    f_a = patch_embed(ht["patch_embed"], mel_image(ht, state["htsat"], wave, cfg.htsat))
    vplan, aplan = cfg.swin.plan(), cfg.htsat.plan()
    ad, ast = params["adapters"], state["adapters"]
    acfg, vcfg = cfg.adapter, cfg.adapter_vis
    out_taps = []
    v_map = a_map = None
    for s, stage in enumerate(paired_layout(cfg)):
        for vb, ab, ai in stage:
            vp, vm = sw["layers"][s]["blocks"][vb], vplan[s][vb]
            if ai is None:
                f_v = swin_mlp_half(vp, swin_attn_half(vp, f_v, vm), cfg.gelu)
                continue
            ap, am = ht["layers"][s]["blocks"][ab], aplan[s][ab]
            a_res, _ = adapter(ad["a_p1"][ai], ast["a_p1"][ai], f_a, f_v, acfg)
            v_res, _ = adapter(ad["v_p1"][ai], ast["v_p1"][ai], f_v, f_a, vcfg)
            f_v = swin_attn_half(vp, f_v, vm) + v_res
            f_a = htsat_block(ap, f_a, am, cfg.gelu) + a_res
            a_res, a_map = adapter(ad["a_p2"][ai], ast["a_p2"][ai], f_a, f_v, acfg)
            v_res, v_map = adapter(ad["v_p2"][ai], ast["v_p2"][ai], f_v, f_a, vcfg)
            f_v = swin_mlp_half(vp, f_v, cfg.gelu) + v_res
            f_a = f_a + a_res
        if taps:
            last = s == cfg.swin.num_layers - 1
            out_taps.append(layer_norm(sw["norm"], f_v) if last else f_v)
        if "downsample" in sw["layers"][s]:
            d = sw["layers"][s]["downsample"]
            merged = merge_2x2(f_v, cfg.swin.stage_resolution(s))
            f_v = layer_norm(d["norm"], merged @ d["reduction"]["kernel"])
        if "downsample" in ht["layers"][s]:
            d = ht["layers"][s]["downsample"]
            merged = merge_2x2(f_a, cfg.htsat.stage_resolution(s))
            f_a = layer_norm(d["norm"], merged) @ d["reduction"]["kernel"]
    f_v = layer_norm(sw["norm"], f_v)
    out = {"f_v": v_map @ f_v, "f_a": a_map @ f_a}
    if taps:
        out["taps"] = out_taps
    return out


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def frames_in(frames_u8):
    """uint8 (..., H, W, 3) -> ImageNet-normalized float32."""
    m = torch.tensor(IMAGENET_MEAN, device=frames_u8.device)
    s = torch.tensor(IMAGENET_STD, device=frames_u8.device)
    return (frames_u8.float() / 255.0 - m) / s


def wave_in(wave_i16):
    """int16 PCM -> float32 in [-1, 1]."""
    return wave_i16.float() / 32767.0
