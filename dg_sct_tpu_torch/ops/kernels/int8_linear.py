"""K4: the int8 linear of int8 serving (CUDA kernel `csrc/int8_linear.cu`).

Replaces `dg_sct_tpu/ops/quant.py:52` `linear_int8`, an XLA int8 dot with
int32 sums (no pallas_call). For x (rows, K) in float32 or bfloat16:

    y = (clip(rint(x / ascale), +-127) . W_q) * (ascale * kscale) + bias

with the integer product exact in int32, the rest in float32 and y cast to
x's type. `ascale` is one static float32 scalar (calibrated), or None: then
each row takes max(absmax(row), 1e-8) / 127, its absmax from one PyTorch
reduction outside the kernel, as JAX's `jnp.max` sits outside its dot.
"""
from __future__ import annotations

import torch

from .build import CudaKernel, I, P, check_aligned, dtype_code, ptr, stream_of

KERNEL = CudaKernel("int8_linear", "k4_int8_linear", [P] * 6 + [I] * 6 + [P])
K_STEP = 64  # the kernel's k-tile: K must be a multiple of it


def div_exact(t, c: float):
    """t / c, correctly rounded as the JAX package divides. A Python-scalar
    divisor would run on CUDA as a multiplication by its reciprocal, which
    can differ by an ulp; a tensor divisor is divided elementwise."""
    return t / t.new_full((), c)


def linear_int8_plain(x, wq, kscale, ascale=None, bias=None):
    """The kernel's arithmetic in PyTorch: x (rows, K), wq (K, N) int8,
    kscale (N,) float32, ascale a float32 scalar or None (per-row dynamic),
    bias (N,) or None -> (rows, N) in x's type. The integer product runs as
    a float64 matmul of the integer-valued operands: exact, since every
    partial sum is an integer below 2^53."""
    xf = x.to(torch.float32)
    if ascale is None:
        a = div_exact(torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-8), 127.0)
    else:
        a = ascale.to(torch.float32)
    xq = torch.clamp(torch.round(xf / a), -127.0, 127.0)
    acc = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)
    y = acc * (a * kscale.to(torch.float32))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def int8_linear(x, wq, kscale, ascale=None, bias=None):
    """K4 on a CUDA tensor; the plain version on a CPU tensor. Arguments as
    `linear_int8_plain`. The kernel takes wq in the layout `quant.quantize_linear`
    makes (wq.t() contiguous, i.e. (N, K) rows), K a multiple of 64, N a
    multiple of 8, bias in float32 or x's type; a non-contiguous x is made
    contiguous. It raises for anything else."""
    kind = x.device.type
    if kind == "cpu":
        return linear_int8_plain(x, wq, kscale, ascale, bias)
    if kind != "cuda":
        raise ValueError(f"int8_linear: no kernel for device {x.device}")
    name = "int8_linear"
    rows, K = x.shape
    if wq.dtype != torch.int8 or wq.ndim != 2 or wq.shape[0] != K:
        raise ValueError(f"{name}: wq {wq.dtype} {tuple(wq.shape)} is not int8 ({K}, N)")
    N = wq.shape[1]
    if K % K_STEP or N % 8:
        raise ValueError(f"{name}: K={K} is not a multiple of {K_STEP} or N={N} of 8")
    if not wq.t().is_contiguous():
        raise ValueError(f"{name}: wq must be a (K, N) view of (N, K) rows, as "
                         f"quant.quantize_linear makes it")
    if kscale.dtype != torch.float32 or kscale.shape != (N,) or not kscale.is_contiguous():
        raise ValueError(f"{name}: kscale must be contiguous float32 ({N},)")
    if ascale is not None and (ascale.dtype != torch.float32 or ascale.numel() != 1):
        raise ValueError(f"{name}: ascale must be one float32 value")
    if bias is not None and (bias.dtype not in (torch.float32, x.dtype) or bias.shape != (N,)
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be contiguous ({N},) in float32 or {x.dtype}")
    for key, t in (("wq", wq), ("kscale", kscale), ("ascale", ascale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {x.device}")
    x = x.contiguous()
    check_aligned(name, x=x, wq=wq)
    out = torch.empty((rows, N), device=x.device, dtype=x.dtype)
    if rows == 0:
        return out
    if ascale is None:  # per row: the kernel makes max(absmax, 1e-8) / 127
        scale = torch.linalg.vector_norm(x, float("inf"), dim=-1, dtype=torch.float32)
    else:
        scale = ascale
    KERNEL.launch(ptr(x), ptr(wq), ptr(kscale), ptr(scale), ptr(bias), ptr(out), rows, K, N,
                  int(ascale is None), 0 if bias is None else dtype_code(bias), dtype_code(x),
                  stream_of(x))
    return out
