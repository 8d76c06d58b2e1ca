"""Basic parameterized ops as plain functions over dicts of tensors.

Same conventions as `dg_sct_tpu/ops/basic.py`: linear kernels are stored
(in, out), grouped kernels (g, in/g, out/g), the patch-embed kernel
(P, P, C, E); every op is `f(params, x, ...) -> y` over leading axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import constant
from . import dsp


# ---------------------------------------------------------------------------
# initializers (torch-default distributions, drawn from one torch.Generator)
# ---------------------------------------------------------------------------

class Init:
    """Random float32 initialisers drawing from `generator` on `device`. On
    the "meta" device (shapes only) pass `generator=None`."""

    dtype = torch.float32

    def __init__(self, generator, device):
        self.generator = generator
        self.device = torch.device(device)

    def _empty(self, shape):
        return torch.empty(shape, device=self.device, dtype=self.dtype)

    def uniform(self, shape, lo=0.0, hi=1.0):
        return self._empty(shape).uniform_(lo, hi, generator=self.generator)

    def normal(self, shape, std=1.0):
        return self._empty(shape).normal_(0.0, std, generator=self.generator)

    def trunc_normal(self, shape, std=0.02):
        """timm-style truncated normal in [-2, 2] stds."""
        return torch.nn.init.trunc_normal_(self._empty(shape), std=std, a=-2.0 * std,
                                           b=2.0 * std, generator=self.generator)

    def kaiming_uniform(self, shape, fan_in):
        """nn.Linear / nn.Conv default weight init (kaiming_uniform, a=sqrt(5))."""
        bound = math.sqrt(1.0 / fan_in)
        return self.uniform(shape, -bound, bound)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def full(self, shape, value):
        return torch.full(shape, value, device=self.device, dtype=self.dtype)


def linear_init(init: Init, in_dim, out_dim, bias=True):
    p = {"kernel": init.kaiming_uniform((in_dim, out_dim), in_dim)}
    if bias:
        bound = 1.0 / math.sqrt(in_dim)
        p["bias"] = init.uniform((out_dim,), -bound, bound)
    return p


def layer_norm_init(init: Init, dim):
    return {"scale": init.ones((dim,)), "bias": init.zeros((dim,))}


def mlp_init(init: Init, dim, hidden, out=None):
    return {"fc1": linear_init(init, dim, hidden),
            "fc2": linear_init(init, hidden, out or dim)}


def batch_norm_init(init: Init, dim):
    params = {"scale": init.ones((dim,)), "bias": init.zeros((dim,))}
    state = {"mean": init.zeros((dim,)), "var": init.ones((dim,)),
             "count": torch.zeros((), device=init.device, dtype=torch.int32)}
    return params, state


def grouped_linear_init(init: Init, in_dim, out_dim, groups, bias=False):
    gi, go = in_dim // groups, out_dim // groups
    p = {"kernel": init.kaiming_uniform((groups, gi, go), gi)}
    if bias:
        bound = 1.0 / math.sqrt(gi)
        p["bias"] = init.uniform((out_dim,), -bound, bound)
    return p


def conv2d_init(init: Init, kh, kw, in_ch, out_ch, bias=True):
    """An NHWC convolution's params: kernel (kh, kw, in, out) (JAX's HWIO)."""
    fan_in = kh * kw * in_ch
    p = {"kernel": init.kaiming_uniform((kh, kw, in_ch, out_ch), fan_in)}
    if bias:
        bound = 1.0 / math.sqrt(fan_in)
        p["bias"] = init.uniform((out_ch,), -bound, bound)
    return p


def patch_embed_init(init: Init, patch, in_chans, embed_dim, norm=True):
    fan_in = in_chans * patch * patch
    bound = 1.0 / math.sqrt(fan_in)
    p = {"kernel": init.kaiming_uniform((patch, patch, in_chans, embed_dim), fan_in),
         "bias": init.uniform((embed_dim,), -bound, bound)}
    if norm:
        p["norm"] = layer_norm_init(init, embed_dim)
    return p


# ---------------------------------------------------------------------------
# forward ops
# ---------------------------------------------------------------------------

def linear(params, x, *, kernels=True):
    """x (..., in) -> (..., out). A quantized dict ("kernel_q", from
    `ops.quant`) runs the int8 path, as K4 when `kernels`; a dict tagged for
    calibration ("qtag") first hands x to its tag."""
    if "qtag" in params:
        params["qtag"](x)
    if "kernel_q" in params:
        from .quant import linear_int8
        return linear_int8(params, x, kernels=kernels)
    y = x @ params["kernel"]
    if "bias" in params:
        y = y + params["bias"]
    return y


def layer_norm(params, x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]


GELU_MODES = ("exact", "tanh")


def gelu(x, mode: str = "exact"):
    """"exact" is torch's erf GELU (the reference's nn.GELU()); "tanh" the
    approximation serving uses (<= 3e-3 apart in bf16)."""
    if mode not in GELU_MODES:
        raise ValueError(f"gelu mode {mode!r} not in {GELU_MODES}")
    return F.gelu(x, approximate="tanh" if mode == "tanh" else "none")


def mlp(params, x, gelu_mode: str = "exact", *, kernels=True):
    h = gelu(linear(params["fc1"], x, kernels=kernels), gelu_mode)
    return linear(params["fc2"], h, kernels=kernels)


def batch_norm(params, state, x, *, train=False, axis=-1, momentum=0.1, eps=1e-5):
    """BatchNorm over every axis but `axis` -> (y, new_state). Eval
    normalizes with the running stats and returns `state`. Train normalizes
    with the batch's biased variance and returns new running stats (the
    unbiased variance, momentum `momentum`, `count` + 1) as new tensors
    without a graph: nothing is written in place, so a recompute under
    checkpointing cannot apply an update twice. y keeps x's type (float32
    running stats do not promote a bfloat16 stream)."""
    ax = axis % x.ndim
    shape = [1] * x.ndim
    shape[ax] = x.shape[ax]
    if train:
        dims = tuple(i for i in range(x.ndim) if i != ax)
        var, mu = torch.var_mean(x, dim=dims, correction=0)
        n = x.numel() // x.shape[ax]
        with torch.no_grad():
            new_state = {
                "mean": (1 - momentum) * state["mean"] + momentum * mu,
                "var": (1 - momentum) * state["var"] + momentum * (var * (n / max(n - 1, 1))),
                "count": state["count"] + 1}
    else:
        mu, var, new_state = state["mean"], state["var"], state
    xn = (x - mu.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    y = xn * params["scale"].reshape(shape) + params["bias"].reshape(shape)
    return y.to(x.dtype), new_state


def grouped_linear(params, x):
    """x: (..., in_dim) -> (..., out_dim), block-diagonal over channel groups
    (`nn.Conv2d(in, out, 1, groups=g)`)."""
    g, gi, go = params["kernel"].shape
    lead = x.shape[:-1]
    y = torch.einsum("...gi,gio->...go", x.reshape(lead + (g, gi)), params["kernel"])
    y = y.reshape(lead + (g * go,))
    if "bias" in params:
        y = y + params["bias"]
    return y


def patch_embed(params, x, patch):
    """(B, H, W, C) -> (B, (H/p)*(W/p), E): the stride-p patch conv as
    space-to-depth and one GEMM, then the optional LayerNorm."""
    B, H, W, C = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, gh * gw, patch * patch * C)
    y = x @ params["kernel"].reshape(patch * patch * C, -1) + params["bias"]
    if "norm" in params:
        y = layer_norm(params["norm"], y)
    return y


def conv2d(params, x):
    """Stride-1 "SAME" convolution, x (N, H, W, C) -> (N, H, W, O), as XLA's
    NHWC / HWIO convolution: cuDNN (or the CPU's) on channels-last views,
    no copy of x."""
    w = params["kernel"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, params.get("bias"), padding="same")
    return y.permute(0, 2, 3, 1)


def merge_2x2(x, res):
    """(B, H*W, C) -> (B, H/2*W/2, 4C): each 2x2 patch's tokens concatenated
    in the order (0,0), (1,0), (0,1), (1,1) over (h, w)."""
    H, W = res
    B, L, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]],
                  dim=-1)
    return x.reshape(B, (H // 2) * (W // 2), 4 * C)


# ---------------------------------------------------------------------------
# stochastic ops: each draw from an explicit generator is split from its
# apply, so a caller can draw masks outside a checkpointed region (a
# recompute never redraws) and a test can apply the JAX package's masks
# ---------------------------------------------------------------------------

def keep_mask(gen, shape, rate, device):
    """Bernoulli(1 - rate) keep mask of `shape` drawn from `gen`."""
    return torch.rand(shape, generator=gen, device=device) < (1.0 - rate)


def apply_keep_mask(x, mask, rate):
    """Kept entries scaled by 1 / (1 - rate), the others zero; `mask`
    broadcasts against x."""
    return torch.where(mask, x / (1.0 - rate), 0.0)


def dropout(gen, x, rate, train):
    """Elementwise dropout; the identity unless training with a nonzero rate."""
    if not train or rate == 0.0:
        return x
    return apply_keep_mask(x, keep_mask(gen, x.shape, rate, x.device), rate)


def drop_path_rates(depths, rate):
    """Per-block stochastic-depth rates of a tower, linearly spaced from 0 to
    `rate` over all its blocks."""
    total = sum(depths)
    return [rate * i / max(total - 1, 1) for i in range(total)]


def drop_path_mask(gen, n, rate, device):
    """Stochastic depth's per-example keep mask, (n,)."""
    return keep_mask(gen, (n,), rate, device)


def apply_drop_path(x, mask, rate):
    """Whole rows of x (leading axis) kept by the (n,) `mask`, or zeroed."""
    return apply_keep_mask(x, mask.reshape((-1,) + (1,) * (x.ndim - 1)), rate)


def drop_residual(y, drop, i):
    """A block's residual y through stochastic depth with mask `drop[i]` of
    its `drop` = (mask1, mask2, rate); y itself when `drop` is None."""
    return y if drop is None else apply_drop_path(y, drop[i], drop[2])


def drop_path(gen, x, rate, train):
    """Stochastic depth on the leading (batch) axis; the identity unless
    training with a nonzero rate."""
    if not train or rate == 0.0:
        return x
    return apply_drop_path(x, drop_path_mask(gen, x.shape[0], rate, x.device), rate)


# ---------------------------------------------------------------------------
# on-device ingest of the serving wire formats
# ---------------------------------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_frames_u8(frames, dtype=torch.bfloat16, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """uint8 (..., H, W, 3) frames -> ImageNet-normalized `dtype`."""
    m = constant(_scaled, mean, device=frames.device)
    s = constant(_scaled, std, device=frames.device)
    return ((frames.to(torch.float32) - m) / s).to(dtype)


def _scaled(v):
    return np.asarray(v, np.float32) * np.float32(255.0)


def _ycc_to_rgb():
    """JFIF full-range YCbCr -> RGB as a (3, 3) matrix on (Y, Cb-128, Cr-128)
    rows: R = Y + 1.402 Cr'; G = Y - .344136 Cb' - .714136 Cr'; B = Y + 1.772 Cb'."""
    return np.asarray([[1.0, 1.0, 1.0],
                       [0.0, -0.344136, 1.772],
                       [1.402, -0.714136, 0.0]], np.float32)


def normalize_frames_yuv420(y_u8, uv_u8, dtype=torch.bfloat16, mean=IMAGENET_MEAN,
                            std=IMAGENET_STD):
    """Planar 4:2:0 frames, y (..., S, S) and uv (..., S/2, S/2, 2) uint8
    (`native.load_jpeg_batch_yuv420`), -> ImageNet-normalized (..., S, S, 3)
    `dtype`: bicubic chroma upsample (`dsp.resize_2d`), then YCbCr -> RGB,
    /255 and the ImageNet affine, in float32."""
    *lead, S, _ = y_u8.shape
    dev = y_u8.device
    uv = uv_u8.to(torch.float32).reshape((-1,) + tuple(uv_u8.shape[-3:]))
    uv = dsp.resize_2d(uv, S, S, kernel="cubic", align_corners=False)
    ycc = torch.cat([y_u8.to(torch.float32)[..., None],
                     uv.reshape(tuple(lead) + (S, S, 2)) - 128.0], dim=-1)
    rgb = ycc @ constant(_ycc_to_rgb, device=dev)
    m = constant(_scaled, mean, device=dev)
    s = constant(_scaled, std, device=dev)
    return ((rgb - m) / s).to(dtype)


MULAW_MU = 255.0


def encode_mulaw_u8(wave: np.ndarray) -> np.ndarray:
    """Host-side continuous mu-law companding of a float waveform in [-1, 1]
    (or int16 PCM) to uint8, the inverse of `dequantize_mulaw_u8`: half the
    wire bytes of int16."""
    x = wave.astype(np.float32)
    if wave.dtype == np.int16:
        x = x / 32767.0
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(MULAW_MU * np.abs(x)) / np.log1p(MULAW_MU)
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def dequantize_mulaw_u8(wave_u8, dtype=torch.float32):
    """Inverse of the host-side continuous mu-law companding: uint8 ->
    waveform in [-1, 1]."""
    y = wave_u8.to(torch.float32) / 127.5 - 1.0
    x = torch.sign(y) * (torch.pow(1.0 + MULAW_MU, y.abs()) - 1.0) / MULAW_MU
    return x.to(dtype)
