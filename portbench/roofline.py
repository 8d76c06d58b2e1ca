"""Peaks of the card and the operations and bytes of the port's kernels.

The formulas count the work of the functions the kernels compute, from
their shapes, whatever computes them: each input byte read once and each
output byte written once. The call lists follow the port's routing rule,
frozen here: a Swin block of C <= 768 runs its attention half as K2 and
the others their attention core as K1; an adapter of the AVE kind (not the
AVS variant) runs its bottleneck as K3.
"""
from __future__ import annotations

import math

from .reference.config import paired_layout

# NVIDIA H100 SXM, dense, at the full 700 W: bf16 tensor cores and HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITEM = {"bfloat16": 2, "float32": 4}
K2_MAX_DIM = 768


def k1(frames, m, it):
    """K1, the window attention core of one block: (flops, bytes)."""
    H, W = m["res"]
    N, heads, D = m["ws"] ** 2, m["heads"], m["dim"] // m["heads"]
    Bw = frames * H * W // N
    nW = H * W // N
    flops = 4 * Bw * heads * N * N * D
    nbytes = it * (4 * Bw * N * heads * D + heads * N * N + (nW * N * N if m["shift"] else 0))
    return flops, nbytes


def k2(frames, m, it):
    """K2, the attention half-block (qkv, window attention, proj, LN and the
    residual) of one block: (flops, bytes)."""
    H, W = m["res"]
    C, heads, N = m["dim"], m["heads"], m["ws"] ** 2
    T = frames * H * W
    Bw, nW = T // N, H * W // N
    flops = 8 * T * C * C + 4 * Bw * heads * N * N * (C // heads)
    nbytes = it * (2 * T * C + 4 * C * C + 6 * C + heads * N * N
                   + (nW * N * N if m["shift"] else 0) + heads)
    return flops, nbytes


def k3(rows, C, groups, go, it):
    """K3, an adapter's LN, grouped bottleneck and LN over `rows` tokens:
    (flops, bytes)."""
    return 4 * rows * C * go, it * (2 * rows * C + 2 * C * go + groups * go + 5 * C)


def calls(cfg, frames, dtype):
    """{"K1" | "K2" | "K3": [(flops, bytes), ...]}: one forward's kernel
    calls at `frames` frames (and as many audio clips), `cfg` a reference
    configuration (`reference.config.load`)."""
    it = ITEM[dtype]
    out = {"K1": [], "K2": [], "K3": []}
    for tower in (cfg.swin, cfg.htsat):
        for stage in tower.plan():
            for m in stage:
                if m["dim"] <= K2_MAX_DIM:
                    out["K2"].append(k2(frames, m, it))
                else:
                    out["K1"].append(k1(frames, m, it))
    for s, stage in enumerate(paired_layout(cfg)):
        for _, _, ai in stage:
            if ai is None:
                continue
            for tower, a in ((cfg.htsat, cfg.adapter), (cfg.swin, cfg.adapter_vis)):
                if a.avs_variant:
                    continue
                C = tower.stage_dim(s)
                rows = frames * math.prod(tower.stage_resolution(s))
                go = C // a.reduction_factor // a.num_conv_group
                out["K3"] += [k3(rows, C, a.num_conv_group, go, it)] * 2  # p1 and p2
    return out


def bound_s(work, dtype):
    """The least time the card could take for [(flops, bytes), ...]."""
    return sum(max(f / PEAK_FLOPS[dtype], b / PEAK_BYTES) for f, b in work)


# kernel name -> group, first match wins (the port's kernels by their names)
KERNEL_GROUPS = (("K1", ("window_attention_kernel",)),
                 ("K2", ("block_attn_",)),
                 ("K3", ("bottleneck_kernel",)),
                 ("K4", ("int8_linear", "int8_quantize")),
                 ("memcpy", ("memcpy", "memset")),
                 ("cuDNN", ("cudnn", "fprop", "convolve")),
                 ("library GEMM", ("gemm", "nvjet", "xmma", "cutlass")))


def kernel_group(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
