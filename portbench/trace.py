"""Reduce a torch.profiler trace of the measured path to what the per-layer
readers and the result's `breakdown` take: device busy time and the idle
gaps of the traced span, device time by kernel group and by kernel, the
host-to-device copies, and for each long gap the host op that was running.
"""
from __future__ import annotations

import torch

from .roofline import kernel_group


def _device(prof):
    """Device activity (kernels, copies, sets) as (name, start_us, end_us);
    a profiler range shows on the device timeline too and is not work."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("portbench.")]


PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")  # the profiler's own host events


def _host(prof):
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == cpu and e.name not in PROFILER_OWN]


def merge(intervals):
    """Sorted, disjoint unions of (start, end) intervals."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def summarize(dev, host):
    """dev: [(name, start_us, end_us)] device activity; host: the same of
    host ops -> {"busy_s", "window_s", "groups" {group: s}, "h2d_s",
    "top" [(group: name, s)], "gaps" [(host op, s)]}, or None without device
    activity."""
    if not dev:
        return None
    busy = merge((s, t) for _, s, t in dev)
    lo, hi = busy[0][0], busy[-1][1]
    groups, names = {}, {}
    h2d = 0.0
    for name, s, t in dev:
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + (t - s) / 1e6
        names[(g, name)] = names.get((g, name), 0.0) + (t - s) / 1e6
        if "htod" in name.lower():
            h2d += (t - s) / 1e6
    gaps = sorted(((s2 - t1, t1, s2) for (_, t1), (s2, _) in zip(busy, busy[1:])), reverse=True)
    named = []
    for length, t1, s2 in gaps[:10]:
        mid = 0.5 * (t1 + s2)
        inside = [(t - s, n) for n, s, t in host if s <= mid <= t]
        named.append((min(inside)[1] if inside else "no host op", length / 1e6))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(t - s for s, t in busy) / 1e6, "window_s": (hi - lo) / 1e6,
            "groups": groups, "h2d_s": h2d,
            "top": [(f"{g}: {n[:120]}", s) for (g, n), s in top], "gaps": named}


def profiled(fn):
    """fn() under torch.profiler (host and device), the device drained at
    the end -> `summarize` of its trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return summarize(_device(prof), _host(prof))
