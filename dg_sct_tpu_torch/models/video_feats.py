"""Frame and clip feature extractors: torchvision's ResNet-152 (2048-d a
frame, the reference's `extract_rgb_feat.py`) and R(2+1)D-18 (512-d an
8-frame clip, `extract_3D_feat.py`), as functions over the JAX package's
parameter trees (`dg_sct_tpu/models/video_feats.py`), with converters from
torchvision state dicts (`*_from_torch`, numpy in and out).

Channels-last throughout (NHWC, NTHWC); the convolutions are cuDNN's
through `ops.basic.conv2d` / `conv3d`. BN is inference-mode, its running
statistics folded into a scale and a shift (eps 1e-5): the backbones are
frozen feature extractors, never trained here.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..ops.basic import Init, conv2d, conv2d_init, conv3d, max_pool2d
from ..utils.torch_convert import convert_conv2d

BN_EPS = 1e-5


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions without TF32 within the block."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# ---------------------------------------------------------------------------
# inference BatchNorm
# ---------------------------------------------------------------------------

def _bn_init(init: Init, dim):
    return {"scale": init.ones((dim,)), "bias": init.zeros((dim,)),
            "mean": init.zeros((dim,)), "var": init.ones((dim,))}


def _bn(p, x, eps=BN_EPS):
    """Running-statistics BN over the last axis as one scale and shift."""
    s = p["scale"] * torch.rsqrt(p["var"] + eps)
    return x * s + (p["bias"] - p["mean"] * s)


def _f32(v):
    return np.ascontiguousarray(np.asarray(v, np.float32))


def _bn_from_torch(state, prefix):
    return {"scale": _f32(state[f"{prefix}.weight"]), "bias": _f32(state[f"{prefix}.bias"]),
            "mean": _f32(state[f"{prefix}.running_mean"]),
            "var": _f32(state[f"{prefix}.running_var"])}


# ---------------------------------------------------------------------------
# torchvision ResNet-152 (Bottleneck 1x1 -> 3x3 (stride) -> 1x1)
# ---------------------------------------------------------------------------

RESNET152_LAYERS = (3, 8, 36, 3)
RESNET_PLANES = (64, 128, 256, 512)


def _conv(init: Init, k, cin, cout):
    return conv2d_init(init, k, k, cin, cout, bias=False)


def init_resnet152(init: Init):
    p = {"conv1": _conv(init, 7, 3, 64), "bn1": _bn_init(init, 64)}
    inplanes = 64
    for li, (blocks, planes) in enumerate(zip(RESNET152_LAYERS, RESNET_PLANES)):
        stride = 1 if li == 0 else 2
        layer = []
        for b in range(blocks):
            blk = {"conv1": _conv(init, 1, inplanes, planes), "bn1": _bn_init(init, planes),
                   "conv2": _conv(init, 3, planes, planes), "bn2": _bn_init(init, planes),
                   "conv3": _conv(init, 1, planes, planes * 4),
                   "bn3": _bn_init(init, planes * 4)}
            if b == 0 and (stride != 1 or inplanes != planes * 4):
                blk["down_conv"] = _conv(init, 1, inplanes, planes * 4)
                blk["down_bn"] = _bn_init(init, planes * 4)
            inplanes = planes * 4
            layer.append(blk)
        p[f"layer{li + 1}"] = layer
    return p


def resnet152_from_torch(state):
    """A torchvision `resnet152` state dict -> the numpy tree (fc unread:
    the feature script drops it)."""
    p = {"conv1": convert_conv2d(state, "conv1"), "bn1": _bn_from_torch(state, "bn1")}
    for li, blocks in enumerate(RESNET152_LAYERS):
        layer = []
        for b in range(blocks):
            base = f"layer{li + 1}.{b}"
            blk = {}
            for i in (1, 2, 3):
                blk[f"conv{i}"] = convert_conv2d(state, f"{base}.conv{i}")
                blk[f"bn{i}"] = _bn_from_torch(state, f"{base}.bn{i}")
            if f"{base}.downsample.0.weight" in state:
                blk["down_conv"] = convert_conv2d(state, f"{base}.downsample.0")
                blk["down_bn"] = _bn_from_torch(state, f"{base}.downsample.1")
            layer.append(blk)
        p[f"layer{li + 1}"] = layer
    return p


def _c2d(p, x, stride=1, pad=0):
    return conv2d(p, x, stride=stride, padding=((pad, pad), (pad, pad)))


def resnet152_features(params, images):
    """images (B, H, W, 3) ImageNet-normalized -> (B, 2048) average-pooled
    features (torchvision's forward without fc)."""
    x = torch.relu(_bn(params["bn1"], _c2d(params["conv1"], images, stride=2, pad=3)))
    x = max_pool2d(x, 3, 2, ((1, 1), (1, 1)))
    for li in range(1, 5):
        for b, blk in enumerate(params[f"layer{li}"]):
            stride = 2 if (li > 1 and b == 0) else 1
            y = torch.relu(_bn(blk["bn1"], _c2d(blk["conv1"], x)))
            y = torch.relu(_bn(blk["bn2"], _c2d(blk["conv2"], y, stride=stride, pad=1)))
            y = _bn(blk["bn3"], _c2d(blk["conv3"], y))
            idn = (_bn(blk["down_bn"], _c2d(blk["down_conv"], x, stride=stride))
                   if "down_conv" in blk else x)
            x = torch.relu(y + idn)
    return x.mean((1, 2))


# ---------------------------------------------------------------------------
# torchvision R(2+1)D-18
# ---------------------------------------------------------------------------

STEM_MID = 45


def _midplanes(cin, cout, t=3, d=3):
    """torchvision Conv2Plus1D's mid channels: floor(t d^2 cin cout /
    (d^2 cin + t cout)), in integers."""
    return (t * d * d * cin * cout) // (d * d * cin + t * cout)


def _conv3d_init(init: Init, kt, kh, kw, cin, cout):
    fan_in = kt * kh * kw * cin
    return {"kernel": init.normal((kt, kh, kw, cin, cout), math.sqrt(2.0 / fan_in))}


def _conv3d_from_torch(state, key):
    """torch conv3d weight (out, in, kt, kh, kw) -> THWIO."""
    return {"kernel": _f32(np.asarray(state[key]).transpose(2, 3, 4, 1, 0))}


def init_r2plus1d_18(init: Init):
    p = {"stem_s": _conv3d_init(init, 1, 7, 7, 3, STEM_MID),
         "stem_bn_s": _bn_init(init, STEM_MID),
         "stem_t": _conv3d_init(init, 3, 1, 1, STEM_MID, 64),
         "stem_bn_t": _bn_init(init, 64)}
    inplanes = 64
    for li, planes in enumerate(RESNET_PLANES):
        stride = 1 if li == 0 else 2
        layer = []
        for b in range(2):
            s = stride if b == 0 else 1
            # torchvision computes midplanes once a block from (inplanes,
            # planes) and reuses it for conv2
            mid = _midplanes(inplanes, planes)
            blk, cin = {}, inplanes
            for ci in (1, 2):
                blk[f"conv{ci}_s"] = _conv3d_init(init, 1, 3, 3, cin, mid)
                blk[f"bn{ci}_s"] = _bn_init(init, mid)
                blk[f"conv{ci}_t"] = _conv3d_init(init, 3, 1, 1, mid, planes)
                blk[f"bn{ci}"] = _bn_init(init, planes)
                cin = planes
            if b == 0 and (s != 1 or inplanes != planes):
                blk["down_conv"] = _conv3d_init(init, 1, 1, 1, inplanes, planes)
                blk["down_bn"] = _bn_init(init, planes)
            inplanes = planes
            layer.append(blk)
        p[f"layer{li + 1}"] = layer
    return p


def r2plus1d_18_from_torch(state):
    """A torchvision `r2plus1d_18` state dict (stem.0/1/3/4;
    layerN.B.convI.0.{0,1,3}, bnI, downsample) -> the numpy tree (fc
    unread)."""
    p = {"stem_s": _conv3d_from_torch(state, "stem.0.weight"),
         "stem_bn_s": _bn_from_torch(state, "stem.1"),
         "stem_t": _conv3d_from_torch(state, "stem.3.weight"),
         "stem_bn_t": _bn_from_torch(state, "stem.4")}
    for li in range(len(RESNET_PLANES)):
        layer = []
        for b in range(2):
            base = f"layer{li + 1}.{b}"
            blk = {}
            for ci in (1, 2):
                cb = f"{base}.conv{ci}.0"
                blk[f"conv{ci}_s"] = _conv3d_from_torch(state, f"{cb}.0.weight")
                blk[f"bn{ci}_s"] = _bn_from_torch(state, f"{cb}.1")
                blk[f"conv{ci}_t"] = _conv3d_from_torch(state, f"{cb}.3.weight")
                blk[f"bn{ci}"] = _bn_from_torch(state, f"{base}.bn{ci}")
            if f"{base}.downsample.0.weight" in state:
                blk["down_conv"] = _conv3d_from_torch(state, f"{base}.downsample.0.weight")
                blk["down_bn"] = _bn_from_torch(state, f"{base}.downsample.1")
            layer.append(blk)
        p[f"layer{li + 1}"] = layer
    return p


def _c3d(p, x, stride, pad):
    return conv3d(p, x, stride=stride, padding=tuple((q, q) for q in pad))


def _conv2plus1d(blk, ci, x, stride):
    """1x3x3 spatial (stride (1, s, s)) -> BN -> ReLU -> 3x1x1 temporal
    (stride (s, 1, 1))."""
    y = _c3d(blk[f"conv{ci}_s"], x, (1, stride, stride), (0, 1, 1))
    y = torch.relu(_bn(blk[f"bn{ci}_s"], y))
    return _c3d(blk[f"conv{ci}_t"], y, (stride, 1, 1), (1, 0, 0))


def r2plus1d_18_features(params, clips):
    """clips (B, T, H, W, 3) normalized (T = 8 at 112 in the feature script)
    -> (B, 512) features pooled over time and space."""
    x = _c3d(params["stem_s"], clips, (1, 2, 2), (0, 3, 3))
    x = torch.relu(_bn(params["stem_bn_s"], x))
    x = _c3d(params["stem_t"], x, (1, 1, 1), (1, 0, 0))
    x = torch.relu(_bn(params["stem_bn_t"], x))
    for li in range(1, 5):
        for b, blk in enumerate(params[f"layer{li}"]):
            stride = 2 if (li > 1 and b == 0) else 1
            y = torch.relu(_bn(blk["bn1"], _conv2plus1d(blk, 1, x, stride)))
            y = _bn(blk["bn2"], _conv2plus1d(blk, 2, y, 1))
            idn = (_bn(blk["down_bn"], _c3d(blk["down_conv"], x, (stride,) * 3, (0, 0, 0)))
                   if "down_conv" in blk else x)
            x = torch.relu(y + idn)
    return x.mean((1, 2, 3))
