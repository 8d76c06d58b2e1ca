"""K3: stage 5 of an eval adapter, the grouped bottleneck (CUDA kernel
`csrc/adapter_bottleneck.cu`).

Replaces `dg_sct_tpu/ops/pallas/adapter_bottleneck.py:66` `_bottleneck_rows`
(reached through `fused_bottleneck` :84). Per token row, after `fold_eval`:
optional LN_before, then per group g ReLU(z_g Wd[g] + bd_g) Wu[g] + bu_g,
concatenated, then LN_post (gate folded in). z_g and h_g are rounded to x's
type before their products; everything else is float32.
"""
from __future__ import annotations

import torch

from ..basic import layer_norm
from .build import (CudaKernel, I, P, check_cuda, check_shape, dtype_code, ptr, refuse_grad,
                    stream_of)

KERNEL = CudaKernel("adapter_bottleneck", "k3_adapter_bottleneck", [P] * 10 + [I] * 6 + [P])


def bottleneck_rows_plain(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, *, has_ln1):
    """The kernel's arithmetic in PyTorch: x (rows, C) -> (rows, C)."""
    rows, C = x.shape
    g, gi, go = wd.shape
    f = lambda t: t.to(torch.float32)
    z = layer_norm({"scale": f(ln1s), "bias": f(ln1b)}, f(x)) if has_ln1 else f(x)
    zg = f(z.to(x.dtype)).reshape(rows, g, gi)
    h = torch.relu(torch.einsum("rgi,gio->rgo", zg, f(wd)) + f(bd).reshape(g, go))
    o = torch.einsum("rgo,goi->rgi", f(h.to(x.dtype)), f(wu)) + f(bu).reshape(g, gi)
    return layer_norm({"scale": f(ln2s), "bias": f(ln2b)}, o.reshape(rows, C)).to(x.dtype)


def bottleneck_rows(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, *, has_ln1):
    """K3 on a CUDA tensor; the plain version on a CPU tensor. x (rows, C);
    wd (g, C/g, go); bd (g*go,); wu (g, go, C/g); bu, ln* (C,). The kernel
    raises for what its C entry refuses (in bfloat16: C/g not a multiple of 8,
    g * ceil(go/8) > 32, an operand not 16-byte aligned), and under grad mode
    for an operand that requires grad (`build.refuse_grad`)."""
    refuse_grad("bottleneck_rows", x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b)
    kind = x.device.type
    if kind == "cpu":
        return bottleneck_rows_plain(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b,
                                     has_ln1=has_ln1)
    if kind != "cuda":
        raise ValueError(f"bottleneck_rows: no kernel for device {x.device}")
    rows, C = x.shape
    g, gi, go = wd.shape
    name = "bottleneck_rows"
    if g * gi != C:
        raise ValueError(f"{name}: {g} groups of {gi} channels do not make C={C}")
    check_cuda(name, x, x=x, wd=wd, bd=bd, wu=wu, bu=bu, ln1s=ln1s, ln1b=ln1b,
               ln2s=ln2s, ln2b=ln2b)
    for key, t, shape in (("bd", bd, (g * go,)), ("wu", wu, (g, go, gi)), ("bu", bu, (C,)),
                          ("ln1s", ln1s, (C,)), ("ln1b", ln1b, (C,)),
                          ("ln2s", ln2s, (C,)), ("ln2b", ln2b, (C,))):
        check_shape(name, key, t, shape)
    out = torch.empty_like(x)
    KERNEL.launch(ptr(x), ptr(wd), ptr(bd), ptr(wu), ptr(bu), ptr(ln1s), ptr(ln1b),
                  ptr(ln2s), ptr(ln2b), ptr(out), rows, C, g, go, int(has_ln1),
                  dtype_code(x), stream_of(x))
    return out


def fused_bottleneck(params, x, *, has_ln1: bool):
    """Adapter stage 5 on x (B, N, C) -> residual (B, N, C). `params` is the
    post-`fold_eval` adapter: grouped `down`/`up` (optional flat biases),
    `ln_post`, and `ln_before` when `has_ln1`. Every operand goes to x's type."""
    B, N, C = x.shape
    wd, wu = params["down"]["kernel"], params["up"]["kernel"]
    g, _, go = wd.shape
    zeros = lambda n: torch.zeros((n,), device=x.device, dtype=x.dtype)
    ones = lambda n: torch.ones((n,), device=x.device, dtype=x.dtype)
    # fold_eval gives both products a bias; make zeros only where one is absent
    bd = params["down"]["bias"] if "bias" in params["down"] else zeros(g * go)
    bu = params["up"]["bias"] if "bias" in params["up"] else zeros(C)
    ln1 = params["ln_before"] if has_ln1 else {"scale": ones(C), "bias": zeros(C)}
    ln2 = params["ln_post"]
    t = lambda a: a.to(x.dtype).contiguous()
    out = bottleneck_rows(x.reshape(B * N, C).contiguous(), t(wd), t(bd), t(wu), t(bu),
                          t(ln1["scale"]), t(ln1["bias"]), t(ln2["scale"]), t(ln2["bias"]),
                          has_ln1=has_ln1)
    return out.reshape(B, N, C)
