"""The program's spans read for the benchmark: a profiled trace reduced by
the port's "dgsct." ranges, the window's device intervals from the spans'
own records, and a run of one cell with the program's tracing on.

    python -m portbench.spans --workload <name> --seed <n> --seconds <s>
    python -m portbench.spans --span-cost

A run is `python -m portbench ... --trace 1`'s, with the program's tracing
(`dg_sct_tpu_torch.utils.profiling.tracing`) on from the engine's build to
the end: in the window, where no profiler runs, the serving spans record
their host times and CUDA events; in the profiled blocks after it every
span on the profiled thread is a profiler range. Its last line of standard
output is the result object with a "spans" entry: "metrics" (the
definitions below, by the names a cell would report them under) and
"readings" (what they are made of, and the checks beside them).

- window_idle_pct (stream loops): in the window, 100 x (1 - the union of
  the device intervals of `dgsct.serve.forward` and `dgsct.serve.to_host`
  over the device span from the first of them to the last). Gaps inside a
  forward count as busy: a lower bound of the card's idle share.
- launches_per_forward (".request" in a request loop): in the profiled
  blocks, the distinct launch correlation ids of device operations launched
  from inside a `dgsct.serve.forward` range, over the number of those ranges.
- wire_ms_per_clip, towers_ms_per_clip, adapters_ms_per_clip,
  heads_ms_per_clip (stream loops): device time of the operations whose
  launching host call's innermost "dgsct." range is `dgsct.serve.wire`,
  `dgsct.model.towers`, `dgsct.model.adapter` or `dgsct.model.heads`, per
  clip of the profiled blocks. A device operation is tied to its host call
  by the profiler's link (its `linked_correlation_id`, the host op or range
  it was launched from), not by overlap in time.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys
import time
from unittest import mock

from . import bench, generator, trace
from .roofline import kernel_group

FORWARD, TO_HOST = "dgsct.serve.forward", "dgsct.serve.to_host"
FUNCTIONS = {"dgsct.serve.wire": "wire_ms_per_clip", "dgsct.model.towers": "towers_ms_per_clip",
             "dgsct.model.adapter": "adapters_ms_per_clip",
             "dgsct.model.heads": "heads_ms_per_clip"}
# launch_counts() keys of each kernel group (K4 is its GEMM and its quantize)
# the profiler's own host events, which runtime calls may name as their op
PROFILER_OWN = trace.PROFILER_OWN + ("Command Buffer Full",)
COUNTERS = {"K1": ("window_attention",), "K2": ("block_attention",),
            "K3": ("adapter_bottleneck",), "K4": ("int8_linear", "int8_quantize")}


def kineto_events(prof):
    """A finished torch.profiler session -> (host, dev, runtime): host [(id,
    thread, name, start_ns, end_ns)] of the host ops and ranges (what a
    device operation links to), dev [(name, correlation id, linked id,
    start_ns, end_ns)] of device work (kernels, copies, sets; no range),
    runtime {correlation id: (start_ns, end_ns, linked id)} of the CUDA
    runtime and driver calls (host events named cuda*/cu* outside any "::"
    namespace)."""
    from torch.autograd import DeviceType

    host, dev, runtime = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith("cu") and "::" not in name:
                runtime[e.correlation_id()] = (e.start_ns(), e.end_ns(),
                                               e.linked_correlation_id())
            elif e.linked_correlation_id() == 0 and name not in PROFILER_OWN:
                host.append((e.correlation_id(), e.start_thread_id(), name, e.start_ns(),
                             e.end_ns()))
        elif (e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
              and not name.startswith(("dgsct.", "portbench."))):
            dev.append((name, e.correlation_id(), e.linked_correlation_id(), e.start_ns(),
                        e.end_ns()))
    return host, dev, runtime


def owners(host):
    """host ops -> {id: (the innermost "dgsct." range's name or None, the id
    of the `dgsct.serve.forward` range it lies in or None)}, by nesting in
    time on each thread."""
    out = {}
    by_thread = {}
    for h in host:
        by_thread.setdefault(h[1], []).append(h)
    for ops in by_thread.values():
        stack = []  # (end, (range name, forward id))
        for i, _, name, s, e in sorted(ops, key=lambda h: (h[3], -h[4])):
            while stack and stack[-1][0] <= s:
                stack.pop()
            inner, fwd = stack[-1][1] if stack else (None, None)
            if name.startswith("dgsct."):
                inner = name
                if name == FORWARD:
                    fwd = i
            out[i] = (inner, fwd)
            stack.append((e, (inner, fwd)))
    return out


def attribute(host, dev, runtime=None):
    """The profiled blocks reduced by the program's ranges -> {"forwards":
    `dgsct.serve.forward` ranges, "launches": distinct correlation ids of
    device work launched inside one, "forward_s": its device time,
    "by_range_s": {innermost range: device s}, "groups_in_forward":
    {kernel group: device operations}, "ours_in_forward": {K1-K4 group:
    {kernel name: launches}} (a call of K2 launches several kernels, each
    once), "by_launch_order" and "by_launch_time": kernels tied to a range
    through their runtime call (`runtime`) for want of a profiler link,
    "unlinked": device operations tied to nothing, "clock_offset_ns": (the
    offset taken, the share of linked runtime calls it fits), "ranges":
    {range name: count}}.

    A kernel without a link is one launched outside the dispatcher (the
    port's own kernels, through ctypes): the profiler records its runtime
    call but ties it to no host op. Among the linked runtime calls, on the
    same clock, the one before it and the one after it were issued from
    host ops; where both lie in the same innermost range, so does the
    kernel's launch. Where they straddle a range's edge, the call's time,
    put on the host ops' clock (`clock_offset`), finds the innermost range
    open then. Copies and sets are never tied this way: the staging thread
    issues them beside the profiled thread's ranges."""
    own = owners(host)
    runtime = runtime or {}
    offset = clock_offset(host, runtime)
    ranges, spans = {}, []
    for i, _, name, s, e in host:
        if name.startswith("dgsct."):
            ranges[name] = ranges.get(name, 0) + 1
            spans.append((s, e, own[i]))
    order = sorted((s, own[k]) for s, _, k in runtime.values() if k in own)
    times = [t for t, _ in order]
    by_range, groups, ours, corr = {}, {}, {}, set()
    forward_ns = unlinked = by_order = by_time = 0
    for name, c, linked, s, e in dev:
        o = own.get(linked) if linked else None
        if o is None and c in runtime and kernel_group(name) != "memcpy":
            t = runtime[c][0]
            j = bisect.bisect_left(times, t)
            if 0 < j < len(order) and order[j - 1][1] == order[j][1]:
                o = order[j][1]
                by_order += 1
            else:
                t += offset[0]
                inside = [(rs, oo) for rs, re, oo in spans if rs <= t <= re]
                if inside:
                    o = max(inside, key=lambda x: x[0])[1]
                    by_time += 1
        if o is None:
            unlinked += 1
            continue
        inner, fwd = o
        if inner is not None:
            by_range[inner] = by_range.get(inner, 0) + (e - s)
        if fwd is not None:
            corr.add(c)
            forward_ns += e - s
            g = kernel_group(name)
            groups[g] = groups.get(g, 0) + 1
            if g in COUNTERS:
                k = ours.setdefault(g, {})
                k[name] = k.get(name, 0) + 1
    return {"forwards": ranges.get(FORWARD, 0), "launches": len(corr),
            "forward_s": forward_ns / 1e9,
            "by_range_s": {k: v / 1e9 for k, v in sorted(by_range.items())},
            "groups_in_forward": groups, "ours_in_forward": ours, "by_launch_order": by_order,
            "by_launch_time": by_time, "unlinked": unlinked, "clock_offset_ns": offset,
            "ranges": ranges}


def named_gaps(host, dev, n=10):
    """The `n` longest gaps between device work -> [(the innermost "dgsct."
    range open on the host at the gap's middle, or "none", ms)]."""
    busy = trace.merge((s, e) for _, _, _, s, e in dev)
    ranges = [(s, e, name) for _, _, name, s, e in host if name.startswith("dgsct.")]
    out = []
    for length, a, b in sorted(((b - a, a, b) for (_, a), (b, _) in zip(busy, busy[1:])),
                               reverse=True)[:n]:
        mid = (a + b) // 2
        inside = [(s, name) for s, e, name in ranges if s <= mid <= e]
        out.append((max(inside)[1] if inside else "none", length / 1e6))
    return out


def clock_offset(host, runtime):
    """The offset to add to a runtime call's time to put it on the host ops'
    clock -> (offset, the share of linked calls it fits). A runtime call
    linked to a host op lies inside it, so each pair allows the offsets
    [op start - call start, op end - call end]; the offset is the middle of
    the stretch that most pairs allow ((0, 0.0) without a pair)."""
    times = {i: (s, e) for i, _, _, s, e in host}
    edges = []
    for s, e, k in runtime.values():
        if k in times:
            lo, hi = times[k][0] - s, times[k][1] - e
            if lo <= hi:
                edges += [(lo, 1), (hi, -1)]
    if not edges:
        return 0, 0.0
    edges.sort(key=lambda x: (x[0], -x[1]))
    best, cur, at = 0, 0, 0
    for (x, d), (nxt, _) in zip(edges, edges[1:] + [(edges[-1][0], 0)]):
        cur += d
        if cur > best:
            best, at = cur, (x + nxt) // 2
    return at, best / (len(edges) // 2)


def window(records, t0_ns, t1_ns):
    """The spans' records (`profiling.spans()`) of the window [t0_ns, t1_ns]
    on the host clock -> {"window_idle_pct", "device_span_s", "idle_s",
    "idle_by_host_span_ms" {the host spans open, joined by "+", or "none":
    ms of the gaps}, "lag_ms_median" (device end minus host end of each
    forward), "forwards"}, or None without device intervals."""
    recs = [r for r in records if r.host_start >= t0_ns and r.host_end <= t1_ns]
    busy = trace.merge((r.device_start, r.device_end) for r in recs
                       if r.name in (FORWARD, TO_HOST) and r.device_start is not None)
    if not busy:
        return None
    lo, hi = busy[0][0], busy[-1][1]
    idle = {}
    short = lambda n: n.rsplit(".", 1)[-1]
    for (_, a), (b, _) in zip(busy, busy[1:]):
        cuts = sorted({a, b} | {t for r in recs for t in (r.host_start, r.host_end) if a < t < b})
        for p, q in zip(cuts, cuts[1:]):
            mid = 0.5 * (p + q)
            key = "+".join(sorted({short(r.name) for r in recs
                                   if r.host_start <= mid < r.host_end})) or "none"
            idle[key] = idle.get(key, 0.0) + (q - p) / 1e6
    fwd = [r for r in recs if r.name == FORWARD and r.device_end is not None]
    union = sum(t - s for s, t in busy)
    return {"window_idle_pct": 100.0 * (1.0 - union / (hi - lo)), "device_span_s": (hi - lo) / 1e9,
            "idle_s": (hi - lo - union) / 1e9,
            "idle_by_host_span_ms": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "lag_ms_median": (statistics.median((r.device_end - r.host_end) / 1e6 for r in fwd)
                              if fwd else None),
            "forwards": len(fwd)}


def metrics(loop, batch, win, prof):
    """The metrics a cell of `loop` reports from the window's reduction and
    the profiled blocks' -> {name: value}; a metric whose spans are absent
    is left out."""
    out = {}
    if loop == "stream" and win:
        out["window_idle_pct"] = win["window_idle_pct"]
    if prof and prof["forwards"]:
        out["launches_per_forward" + (".request" if loop == "request" else "")] = (
            prof["launches"] / prof["forwards"])
        if loop == "stream":
            clips = prof["forwards"] * batch
            for rng, name in FUNCTIONS.items():
                if rng in prof["ranges"]:
                    out[name] = 1e3 * prof["by_range_s"].get(rng, 0.0) / clips
    return out


def run(workload, seed, seconds, *, device="cuda", root=bench.CHECKOUT,
        log=lambda s: print(s, file=sys.stderr, flush=True)):
    """A `--trace 1` run of the cell with the program's tracing on -> the
    result object with its "spans" entry. `bench.run_cell` reads no span,
    so for this process only the profiled blocks' reduction
    (`trace.profiled`) is swapped for one that also keeps the events, and
    each loop for one that keeps the window's bounds."""
    import torch

    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.utils import profiling

    spec = bench.load_spec(root)
    wl, config, mix = bench.cell(spec, workload, root)
    got = {}

    def profiled(fn):  # trace.profiled, keeping what the spans' reduction reads
        from torch.profiler import ProfilerActivity, profile

        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got["launch_counts"] = launch_counts()
        t = time.perf_counter()
        host, dev, runtime = kineto_events(prof)
        got["profile"] = attribute(host, dev, runtime)
        got["gaps"] = named_gaps(host, dev)
        got["reduce_s"] = time.perf_counter() - t
        dev = trace._device(prof)
        got["ranges_as_device_work"] = sorted({n for n, _, _ in dev if n.startswith("dgsct.")})
        return trace.summarize(dev, trace._host(prof))

    def windowed(loop):
        def inner(kind, eng, pool, mix, seed, seconds, *, profile=None):
            res = loop(kind, eng, pool, mix, seed, seconds, profile=profile)
            got["window"] = (round(res["t0"] * 1e9), round((res["t0"] + res["window_s"]) * 1e9))
            return res
        return inner

    with contextlib.ExitStack() as stack:
        def engine(kind, config, mix, params, state, device, pool):
            eng = bench.own_engine(kind, config, mix, params, state, device, pool)
            stack.enter_context(profiling.tracing())  # the card in use: its anchor taken
            profiling.reset_spans()
            return eng

        stack.enter_context(mock.patch.object(trace, "profiled", profiled))
        for name in ("stream", "requests"):
            stack.enter_context(mock.patch.object(generator, name,
                                                  windowed(getattr(generator, name))))
        result, _, _ = bench.run_cell(spec, wl, config, mix, seed, seconds, True,
                                      device=torch.device(device), log=log, engine=engine)
    records = profiling.spans()
    win = window(records, *got["window"]) if "window" in got else None
    prof = got.get("profile")
    readings = {"window": win, "profile": prof, "launch_counts": got.get("launch_counts"),
                "reduce_s": got.get("reduce_s"), "gaps_by_range_ms": got.get("gaps"),
                "ranges_as_device_work": got.get("ranges_as_device_work"),
                "clock_drift_ns": profiling.clock_drift_ns(), "records": len(records),
                "dropped": profiling.dropped_spans()}
    if prof:
        counted = got["launch_counts"]
        # each kernel of a group against the program's count of the group's calls
        readings["kernels_in_forward_vs_counter"] = {
            g: [sorted(set(prof["ours_in_forward"].get(g, {}).values())),
                sum(counted.get(k, 0) for k in keys)]
            for g, keys in COUNTERS.items()}
        busy = (result.get("device") or {}).get("busy_s")
        fn_s = sum(prof["by_range_s"].get(r, 0.0) for r in FUNCTIONS)
        readings["functions_s"] = fn_s
        readings["functions_over_forward"] = fn_s / prof["forward_s"] if prof["forward_s"] else None
        readings["functions_over_busy"] = fn_s / busy if busy else None
    if win:
        log(f"window idle {win['window_idle_pct']:.3f}% of {win['device_span_s']:.3f} s by the "
            f"host span it fell in (ms): {win['idle_by_host_span_ms']}; the card's lag at the "
            f"end of each forward's issue: median {win['lag_ms_median']:.3f} ms")
    result["spans"] = {"metrics": metrics(mix["loop"], mix["batch"], win, prof),
                       "readings": readings}
    return result


def span_cost(n=20000):
    """Host microseconds a span adds, the mean of `n` (an empty loop's time
    taken off; half the event pool with CUDA events), in each mode ->
    {mode: us}."""
    import torch

    from dg_sct_tpu_torch.utils import profiling

    def us(record, k=n):
        t = time.perf_counter()
        for _ in range(k):
            with profiling.span(FORWARD, record):
                pass
        spent = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(k):
            pass
        return 1e6 * (spent - (time.perf_counter() - t)) / k

    cuda = torch.cuda.is_available()
    if cuda:
        torch.zeros(1, device="cuda")
    out = {"off": us(profiling.DEVICE)}
    with profiling.tracing():
        out["on, nothing recorded"] = us(0)
        out["on, host times"] = us(profiling.HOST)
        profiling.reset_spans()
        if cuda:
            out["on, host times and CUDA events"] = us(profiling.DEVICE, profiling.POOL // 2)
        profiling.reset_spans()
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts):
            out["on, under torch.profiler"] = us(profiling.DEVICE)
    profiling.reset_spans()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m portbench.spans",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--span-cost", action="store_true")
    args = p.parse_args(argv)
    if args.span_cost:
        print(json.dumps({"span_cost_us": span_cost()}), flush=True)
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        p.error("--workload, --seed and --seconds, or --span-cost")
    # the caches `python -m portbench` keeps inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(bench.ROOT / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(bench.ROOT / ".cache" / "torch_extensions")
    print(json.dumps(run(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
