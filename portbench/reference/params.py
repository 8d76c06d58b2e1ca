"""Seeded weights for both sides of the comparison.

`Init` hands out the leaves of a parameter tree. On the "meta" device it
builds shapes only. Otherwise every drawn leaf is a view of one flat
bfloat16 buffer (the serving type) that a single `torch.rand` call filled
from the run's seed on the card, scaled in place to the leaf's range; the
tree is then handed over as float32 copies. The ranges follow the
releases' initialisers (torch's default, uniform over +-1/sqrt(fan_in),
for linears, convolutions and LSTMs; 0.02 for the merges' reductions),
with the scalars that are zero at init (the
adapters' gates, TPAVI's BN scale) and the BN statistics drawn too, so
that every branch of the model counts.
"""
from __future__ import annotations

import math

import torch

ALIGN = 32  # elements


class Init:
    def __init__(self, flat=None, device="meta"):
        self.flat = flat
        self.device = torch.device(device)
        self.pos = 0

    def _take(self, shape):
        n = math.prod(shape)
        off = -(-self.pos // ALIGN) * ALIGN  # every leaf starts 128-byte aligned in float32
        self.pos = off + n
        if self.flat is None:
            return torch.empty(shape, device="meta")
        return self.flat[off:off + n].view(shape)

    def uniform(self, shape, lo, hi):
        t = self._take(shape)
        if self.flat is not None:
            t.mul_(hi - lo).add_(lo)
        return t

    def sym(self, shape, bound):
        return self.uniform(shape, -bound, bound)

    def fan_in(self, shape, fan_in):
        """torch's default for a linear or a convolution: uniform over
        +-1/sqrt(fan_in)."""
        return self.sym(shape, 1.0 / math.sqrt(fan_in))

    def const(self, shape, value, dtype=torch.float32):
        return torch.full(shape, value, device=self.device, dtype=dtype)


def count(build) -> int:
    """The number of drawn elements of `build(init)`."""
    init = Init()
    build(init)
    return init.pos


def seeded(build, seed: int, device):
    """`build(init)` with its drawn leaves from `seed` on `device` -> the
    tree with every float leaf as float32 (one bfloat16 draw, one cast)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(count(build), generator=gen, device=device, dtype=torch.bfloat16)
    tree = build(Init(flat, device))
    flat32 = flat.float()
    storage = flat.untyped_storage().data_ptr()

    def to32(t):
        if isinstance(t, dict):
            return {k: to32(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(to32(v) for v in t)
        if t.numel() and t.untyped_storage().data_ptr() == storage:
            off = (t.data_ptr() - storage) // t.element_size()
            return flat32[off:off + t.numel()].view(t.shape)
        return t.float() if t.is_floating_point() else t

    return to32(tree)


# ---------------------------------------------------------------------------
# leaves shared by the towers, the adapters and the heads
# ---------------------------------------------------------------------------

def linear(init, i, o, bias=True):
    p = {"kernel": init.fan_in((i, o), i)}
    if bias:
        p["bias"] = init.fan_in((o,), i)
    return p


def layer_norm(init, d):
    return {"scale": init.uniform((d,), 0.8, 1.2), "bias": init.sym((d,), 0.1)}


def batch_norm(init, d, scale=(0.8, 1.2)):
    params = {"scale": init.uniform((d,), *scale), "bias": init.sym((d,), 0.1)}
    state = {"mean": init.sym((d,), 0.1), "var": init.uniform((d,), 0.5, 1.5),
             "count": init.const((), 0, torch.int32)}
    return params, state


def mlp(init, d, hidden):
    return {"fc1": linear(init, d, hidden), "fc2": linear(init, hidden, d)}


def patch_embed(init, p, c, e, norm=True):
    out = {"kernel": init.fan_in((p, p, c, e), p * p * c), "bias": init.fan_in((e,), p * p * c)}
    if norm:
        out["norm"] = layer_norm(init, e)
    return out


def grouped(init, i, o, g):
    return {"kernel": init.fan_in((g, i // g, o // g), i // g)}


def conv(init, k, i, o):
    return {"kernel": init.fan_in((k, k, i, o), k * k * i), "bias": init.fan_in((o,), k * k * i)}


def lstm(init, i, h):
    cell = lambda: {"wi": init.fan_in((i, 4 * h), h), "wh": init.fan_in((h, 4 * h), h),
                    "bi": init.fan_in((4 * h,), h), "bh": init.fan_in((4 * h,), h)}
    return {"fwd": cell(), "bwd": cell()}


def mha(init, e):
    return {"in_proj": {"kernel": init.fan_in((e, 3 * e), e), "bias": init.sym((3 * e,), 0.02)},
            "out_proj": linear(init, e, e)}
