"""Loop instrumentation and profiling: `AverageMeter` and `StepTimer` for
host loops (both synchronize the card before they read the clock),
`trace` (torch.profiler, a Chrome trace) and `flops_estimate` (PyTorch's
FLOP counter over the plain path on the "meta" device).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from .tree import tree_map


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _meta(t):
    return t.to("meta") if torch.is_tensor(t) else t


def flops_estimate(fn, *args, **kwargs) -> Dict[str, float]:
    """`fn(*args, **kwargs)` with every tensor argument moved to the "meta"
    device (shapes only, nothing computed), under
    `torch.utils.flop_counter.FlopCounterMode` -> {"flops": total, and one
    entry an operator}. The count is PyTorch's: matrix products,
    convolutions and attention, 2 a multiply-add; elementwise work is not
    counted, and it is not XLA's cost analysis. `fn` must run the plain
    path (kernels=False): the port's CUDA kernels launch through ctypes, out
    of the dispatcher's sight, so their work would count as zero."""
    from torch.utils.flop_counter import FlopCounterMode

    args, kwargs = tree_map(_meta, list(args)), tree_map(_meta, kwargs)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args, **kwargs)
    out = {"flops": float(counter.get_total_flops())}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        out[str(op)] = float(n)
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, CPU and (when present) CUDA activity;
    on exit the Chrome trace goes to `<log_dir>/trace.json`. Yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class AverageMeter:
    """Running average of a value over `n`-weighted updates."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        _sync()
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class StepTimer:
    """Wall-clock time of each `with` step, the card synchronized at both
    ends; the first `warmup` steps are left out of an exponential moving
    average (weight `ema` on the past)."""

    def __init__(self, warmup: int = 1, ema: float = 0.9):
        self.warmup = warmup
        self.ema = ema
        self.steps = 0
        self.ema_s: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        dt = time.perf_counter() - self._t0
        self.steps += 1
        if self.steps > self.warmup:
            self.ema_s = dt if self.ema_s is None else self.ema * self.ema_s + (1 - self.ema) * dt

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.ema_s if self.ema_s else 0.0
