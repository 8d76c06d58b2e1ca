"""K1: the window-attention core (CUDA kernel `csrc/window_attention.cu`).

Replaces `dg_sct_tpu/ops/pallas/window_attention.py:73` `fused_window_attention`.
Per window and head, with q, k, v in native (Bw, N, H, D) layout and q
already scaled: s = q k^T + bias[h] (+ mask[w mod nW]); float32 softmax; p
rounded to the output type; out = p . v with float32 sums.
"""
from __future__ import annotations

import torch

from .build import (CudaKernel, I, P, check_aligned, check_cuda, check_shape, dtype_code,
                    ptr, refuse_grad, stream_of)

KERNEL = CudaKernel("window_attention", "k1_window_attention",
                    [P, P, P, P, P, P, I, I, I, I, I, I, P])
MAX_TOKENS = 144     # nine 16-row query tiles
MAX_HEAD_DIM = 32    # four 8-column output tiles; a multiple of 8 (16-byte rows)


def window_attention_plain(q, k, v, bias, mask=None, *, nW=1):
    """The kernel's arithmetic in PyTorch: (Bw, N, H, D) -> (Bw, N, H, D),
    accumulating in float32 (float64 for float64 inputs, which no kernel
    takes)."""
    Bw, N, H, D = q.shape
    f = lambda t: t.to(torch.promote_types(q.dtype, torch.float32))
    s = torch.einsum("bnhd,bmhd->bhnm", f(q), f(k)) + f(bias)[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bw // nW, nW, H, N, N) + f(mask)[None, :, None]).reshape(Bw, H, N, N)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", f(p), f(v)).to(q.dtype)


def window_attention(q, k, v, bias, mask=None, *, nW=1):
    """K1 on a CUDA tensor; the plain version on a CPU tensor. Under grad mode
    an operand that requires grad raises (`build.refuse_grad`)."""
    refuse_grad("window_attention", q, k, v, bias, mask)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask, nW=nW)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for device {q.device}")
    Bw, N, H, D = q.shape
    if mask is not None:
        nW = mask.shape[0]
    if Bw % nW:
        raise ValueError(f"window_attention: {Bw} windows are not a multiple of nW={nW}")
    if N > MAX_TOKENS or D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"window_attention: window of {N} tokens, head dim {D}: the kernel "
                         f"takes <= {MAX_TOKENS} and a multiple of 8 <= {MAX_HEAD_DIM}")
    check_cuda("window_attention", q, k=k, v=v, bias=bias, mask=mask, q=q)
    check_shape("window_attention", "k", k, q.shape)
    check_shape("window_attention", "v", v, q.shape)
    check_shape("window_attention", "bias", bias, (H, N, N))
    check_shape("window_attention", "mask", mask, (nW, N, N))
    check_aligned("window_attention", q=q, k=k, v=v, bias=bias, mask=mask)
    out = torch.empty_like(q)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(mask), ptr(out),
                  Bw, N, H, D, nW, dtype_code(q), stream_of(q))
    return out
