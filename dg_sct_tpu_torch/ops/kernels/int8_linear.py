"""K4: the int8 linear of int8 serving (CUDA kernels `csrc/int8_linear.cu`).

Replaces `dg_sct_tpu/ops/quant.py:52` `linear_int8`, an XLA int8 dot with
int32 sums (no pallas_call). For x (rows, K) in float32 or bfloat16:

    y = (clip(rint(x / ascale), +-127) . W_q) * (ascale * kscale) + bias

with the integer product exact in int32, the rest in float32 and y cast to
x's type. `ascale` is one static float32 scalar (calibrated), or None: then
each row takes max(absmax(row), 1e-8) / 127.

Two kernels, each with its plain version and launch count: the quantize
(`quantize_rows`: x -> int8 rows and each row's (s, 1/s), every element
quantized once a call, the absmax of a dynamic scale found in the same
pass) and the int8 GEMM (`int8_gemm`: the int8 rows times the weight,
dequantize, bias, cast). `int8_linear` runs one after the other;
`linear_int8_plain` equals the composition of their plain versions.
"""
from __future__ import annotations

import torch

from .build import CudaKernel, I, P, check_aligned, dtype_code, ptr, stream_of

QUANTIZE = CudaKernel("int8_linear", "k4_quantize", [P] * 4 + [I] * 4 + [P])
KERNEL = CudaKernel("int8_linear", "k4_int8_gemm", [P] * 6 + [I] * 5 + [P])
K_STEP = 64  # K must be a multiple of it


def div_exact(t, c: float):
    """t / c, correctly rounded as the JAX package divides. A Python-scalar
    divisor would run on CUDA as a multiplication by its reciprocal, which
    can differ by an ulp; a tensor divisor is divided elementwise."""
    return t / t.new_full((), c)


def linear_int8_plain(x, wq, kscale, ascale=None, bias=None):
    """The kernels' arithmetic in PyTorch: x (rows, K), wq (K, N) int8,
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


def quantize_rows_plain(x, ascale=None):
    """The quantize kernel's arithmetic: x (rows, K) -> (xq (rows, K) int8,
    rs (rows, 2) float32 holding each row's scale s and 1/s, correctly
    rounded), s the static `ascale` or the row's max(absmax, 1e-8) / 127."""
    xf = x.to(torch.float32)
    if ascale is None:
        a = div_exact(torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-8), 127.0)
    else:
        a = ascale.to(torch.float32).reshape(1, 1).expand(x.shape[0], 1)
    xq = torch.clamp(torch.round(xf / a), -127.0, 127.0).to(torch.int8)
    return xq, torch.cat([a, torch.ones_like(a) / a], dim=-1)


def int8_gemm_plain(xq, rs, wq, kscale, bias=None, dtype=torch.float32):
    """The GEMM kernel's arithmetic: xq (rows, K) int8 and rs from
    `quantize_rows_plain`, wq (K, N) int8, kscale (N,) float32, bias (N,) or
    None -> float(xq . wq) * (s * kscale) + bias, as `dtype`."""
    acc = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)
    y = acc * (rs[:, :1] * kscale.to(torch.float32))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(dtype)


def _check_device(name, x):
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return kind == "cuda"


def _check_x(name, x, ascale):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim != 2:
        raise ValueError(f"{name}: x must be (rows, K) float32 or bfloat16, not {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[1] % K_STEP:
        raise ValueError(f"{name}: K={x.shape[1]} is not a multiple of {K_STEP}")
    if ascale is not None and (ascale.dtype != torch.float32 or ascale.numel() != 1
                               or ascale.device != x.device):
        raise ValueError(f"{name}: ascale must be one float32 value on {x.device}")


def _quantize(x, ascale, stream):
    """The quantize kernel on a contiguous, aligned CUDA x -> one new buffer
    holding xq (rows, K) int8, then rs (rows, 2) float32 (rows * K is a
    multiple of 64 bytes, so rs is aligned), and the address of rs."""
    rows, K = x.shape
    buf = torch.empty(rows * (K + 8), device=x.device, dtype=torch.uint8)
    rs = buf.data_ptr() + rows * K
    QUANTIZE.launch(ptr(x), ptr(ascale), buf.data_ptr(), rs, rows, K, int(ascale is None),
                    dtype_code(x), stream)
    return buf, rs


def quantize_rows(x, ascale=None):
    """The quantize kernel on a CUDA tensor; the plain version on a CPU
    tensor. Arguments and result as `quantize_rows_plain`; the kernel takes
    K a multiple of 64 and makes a non-contiguous x contiguous. It raises for
    anything else."""
    name = "quantize_rows"
    if not _check_device(name, x):
        return quantize_rows_plain(x, ascale)
    _check_x(name, x, ascale)
    x = x.contiguous()
    check_aligned(name, x=x)
    rows, K = x.shape
    if rows == 0:
        return quantize_rows_plain(x, ascale)
    buf, _ = _quantize(x, ascale, stream_of(x))
    return (buf[:rows * K].view(torch.int8).view(rows, K),
            buf[rows * K:].view(torch.float32).view(rows, 2))


def int8_linear(x, wq, kscale, ascale=None, bias=None):
    """K4 on a CUDA tensor: the quantize kernel, then the int8 GEMM; the
    plain version on a CPU tensor. Arguments as `linear_int8_plain`. The
    kernels take wq in the layout `quant.quantize_linear` makes (wq.t()
    contiguous, i.e. (N, K) rows), K a multiple of 64, N a multiple of 8,
    bias in float32 or x's type; a non-contiguous x is made contiguous. It
    raises for anything else."""
    name = "int8_linear"
    if not _check_device(name, x):
        return linear_int8_plain(x, wq, kscale, ascale, bias)
    _check_x(name, x, ascale)
    rows, K = x.shape
    if wq.dtype != torch.int8 or wq.ndim != 2 or wq.shape[0] != K:
        raise ValueError(f"{name}: wq {wq.dtype} {tuple(wq.shape)} is not int8 ({K}, N)")
    N = wq.shape[1]
    if N % 8:
        raise ValueError(f"{name}: N={N} is not a multiple of 8")
    if not wq.t().is_contiguous():
        raise ValueError(f"{name}: wq must be a (K, N) view of (N, K) rows, as "
                         f"quant.quantize_linear makes it")
    if kscale.dtype != torch.float32 or kscale.shape != (N,) or not kscale.is_contiguous():
        raise ValueError(f"{name}: kscale must be contiguous float32 ({N},)")
    if bias is not None and (bias.dtype not in (torch.float32, x.dtype) or bias.shape != (N,)
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be contiguous ({N},) in float32 or {x.dtype}")
    for key, t in (("wq", wq), ("kscale", kscale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {x.device}")
    x = x.contiguous()
    check_aligned(name, x=x, wq=wq)
    out = torch.empty((rows, N), device=x.device, dtype=x.dtype)
    if rows == 0:
        return out
    stream = stream_of(x)
    buf, rs = _quantize(x, ascale, stream)
    KERNEL.launch(ptr(buf), rs, ptr(wq), ptr(kscale), ptr(bias), ptr(out), rows, K, N,
                  0 if bias is None else dtype_code(bias), dtype_code(x), stream)
    return out


def int8_gemm(xq, rs, wq, kscale, bias=None, dtype=torch.float32):
    """The int8 GEMM kernel alone on CUDA tensors (the plain version on CPU
    ones), on the quantize's output: arguments as `int8_gemm_plain`, wq and
    bias as `int8_linear` takes them. For timing and checking the kernel on
    its own; `int8_linear` is the path."""
    name = "int8_gemm"
    if not _check_device(name, xq):
        return int8_gemm_plain(xq, rs, wq, kscale, bias, dtype)
    rows, K = xq.shape
    N = wq.shape[1]
    if (xq.dtype != torch.int8 or rs.shape != (rows, 2) or rs.dtype != torch.float32
            or not (xq.is_contiguous() and rs.is_contiguous() and wq.t().is_contiguous())
            or K % K_STEP or N % 8 or wq.shape[0] != K):
        raise ValueError(f"{name}: xq {xq.dtype} {tuple(xq.shape)}, rs {tuple(rs.shape)}, wq "
                         f"{tuple(wq.shape)} do not fit the kernel")
    check_aligned(name, xq=xq, rs=rs, wq=wq)
    out = torch.empty((rows, N), device=xq.device, dtype=dtype)
    KERNEL.launch(ptr(xq), ptr(rs), ptr(wq), ptr(kscale), ptr(bias), ptr(out), rows, K, N,
                  0 if bias is None else dtype_code(bias), dtype_code(out), stream_of(xq))
    return out
