"""The check's control where the program has no path of its own in a
lower precision that reaches the answers: the reference computed with
every product's operands rounded to fp8 (e4m3, one scale a tensor), the
precision below the configurations' bf16."""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
PRODUCTS = {"matmul", "__matmul__", "mm", "bmm", "einsum", "conv2d"}  # by function name


def to_fp8(t):
    """A float tensor rounded to e4m3 after scaling its largest magnitude to
    e4m3's, and scaled back."""
    if not (torch.is_tensor(t) and t.is_floating_point()) or t.numel() == 0:
        return t
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype)) * scale


class fp8(TorchFunctionMode):
    """Within it, matmul, bmm, einsum and conv2d take fp8-rounded operands."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) in PRODUCTS:
            args = [to_fp8(a) if torch.is_tensor(a) else
                    [to_fp8(x) for x in a] if isinstance(a, (list, tuple)) else a for a in args]
        return func(*args, **kwargs)
