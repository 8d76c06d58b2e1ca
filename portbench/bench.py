"""Run one cell of BENCHMARK.json once.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (`portbench/configs/<config>.json`: the
model's sizes, how it is served, its model kind and the limits of its
check) and a traffic mix (`portbench/traffic/<traffic>.json`); a per-layer
metric is read by `portbench/metrics/<metric>.py`. Nothing else names a
cell, so a cell, a configuration, a mix or a metric is added by adding
files and entries.

A run: weights and clips from the seed on the card, the port's engine
built and warmed on the cell's batch (set-up), the traffic loop for
`--seconds` (the window), the memory peak read, the engine freed, then the
plain float32 reference (`portbench/reference/`) over every clip the
window answered, and the comparison that decides `correct`. With `--trace
1` the window also times the host's issue of each forward and, after it
closes, a few more blocks run under torch.profiler; the per-layer metrics
come from those. The last line of standard output is the result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from .roofline import PEAK_FLOPS, bound_s, calls

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dg_sct_tpu"}  # compared as whole top-level names


def process_age_s() -> float:
    """Seconds since this process started, from /proc (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


_AGE0, _T0 = process_age_s(), time.perf_counter()


def load_spec(root=CHECKOUT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(spec, name, root=CHECKOUT):
    """The workload `name` -> (workload, configuration file's object, mix)."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = json.loads((Path(root) / conf["file"]).read_text())
    mix = json.loads((Path(root) / "portbench" / "traffic" / f"{wl['traffic']}.json")
                     .read_text())
    return wl, config, mix


def metrics_of(spec, wl, kind):
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those without "workloads" and those that list it."""
    return [m for m in spec[kind] if wl["name"] in m.get("workloads", [wl["name"]])]


def reader(name):
    """`read(ctx)` of `portbench/metrics/<name>.py`."""
    path = ROOT / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(device, log):
    """Build (or find built) the port's CUDA libraries; True if this run
    compiled them."""
    if device.type != "cuda":
        return False
    from dg_sct_tpu_torch.ops.kernels import build

    libs = [build.build_dir() / f"lib{n}.so" for n in build.SOURCES]
    fresh = not all(p.exists() for p in libs)
    t = time.perf_counter()
    build.build_all()
    log(f"kernels: {'compiled' if fresh else 'found built'} in {build.build_dir()} "
        f"({time.perf_counter() - t:.1f} s)")
    return fresh


def flops_per_clip(kind, ref_cfg, batch):
    """Model FLOPs of one clip: PyTorch's FLOP counter over the reference
    forward on the "meta" device at the cell's batch (matrix products and
    convolutions, 2 a multiply-add), over the batch."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.params import Init

    params, state = kind.init(Init(), ref_cfg)  # float32 shapes on "meta"
    shapes = kind.clip_shapes(ref_cfg)
    wave = torch.empty((batch,) + shapes["wave"], dtype=torch.int16, device="meta")
    image = torch.empty((batch,) + shapes["image"], dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        kind.reference(params, state, wave, image, ref_cfg)
    return counter.get_total_flops() / batch


def reference_outputs(kind, ref_cfg, seed, pool, clips, block, device, precision=None):
    """The reference's outputs of the pool clips `clips`, computed in
    blocks of `block` clips, float32 with TF32 off -> {clip: {name: numpy}}.
    `precision`, a context (`control.fp8`), computes it in a lower one."""
    import torch

    from .reference.params import seeded

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params, state = seeded(lambda init: kind.init(init, ref_cfg), seed, device)
        out = {}
        with torch.inference_mode(), precision or contextlib.nullcontext():
            for s in range(0, len(clips), block):
                idx = clips[s:s + block]
                w = torch.as_tensor(pool["wave"][idx], device=device)
                f = torch.as_tensor(pool["image"][idx], device=device)
                res = kind.reference(params, state, w, f, ref_cfg)
                res = {k: v.cpu().numpy() for k, v in res.items()}
                for r, j in enumerate(idx):
                    out[int(j)] = {k: v[r] for k, v in res.items()}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def paired(outputs, ref, out):
    """The program's answers of output `out` and the reference's, stacked in
    the same order: (program, reference) float64 arrays."""
    import numpy as np

    pairs = [(o[out].astype(np.float64), ref[j][out].astype(np.float64))
             for j, kept in sorted(outputs.by_clip.items()) for o in kept]
    return np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])


def compare(outputs, ref):
    """The statistics of the answers kept -> {"<output>.<statistic>": value}
    for each output, and "answers.z_rms" over all of them; a non-finite
    answer reads inf.
    - z_rms: the root mean square of (program - reference) over the
      reference's spread between clips (its standard deviation over the
      answers, element by element): the error in units of how much each
      element of an answer moves from clip to clip. "answers.z_rms" takes
      every element of every output together.
    - rel_l2: the L2 norm of (program - reference) over the reference's.
    - max_gap: the largest |program - reference| over the range (max - min)
      of the reference's answers.
    - shift: the root mean square, over elements, of the mean over the
      answers of z: a bias that every answer shares (a lower precision in
      the towers) stays in it, while rounding that differs from clip to
      clip averages out."""
    import numpy as np

    got, z2, n = {}, 0.0, 0
    finite = True
    for out in next(iter(ref.values())):
        p, r = paired(outputs, ref, out)
        d = p - r
        ok = bool(np.isfinite(p).all())
        finite &= ok
        z = d / np.maximum(r.std(0), 1e-12 * np.abs(r).max())
        z2, n = z2 + float((z ** 2).sum()), n + z.size
        stats = {"z_rms": np.sqrt(np.mean(z ** 2)),
                 "rel_l2": np.linalg.norm(d) / np.linalg.norm(r),
                 "max_gap": np.abs(d).max() / (r.max() - r.min()),
                 "shift": np.sqrt(np.mean(z.mean(0) ** 2))}
        for k, v in stats.items():
            got[f"{out}.{k}"] = float(v) if ok else float("inf")
    got["answers.z_rms"] = float(np.sqrt(z2 / n)) if finite else float("inf")
    return got


def run(workload, seed, seconds, trace, *, device="cuda", root=CHECKOUT,
        log=lambda s: print(s, file=sys.stderr, flush=True)):
    """One run of the cell -> the result object."""
    spec = load_spec(root)
    wl, config, mix = cell(spec, workload, root)
    return run_cell(spec, wl, config, mix, seed, seconds, trace, device=device, log=log)[0]


def own_engine(kind, config, mix, params, state, device, pool):
    """The cell's engine, as its configuration serves it."""
    return kind.engine(config["model"], config["serve"], mix, params, state, device)


def run_cell(spec, wl, config, mix, seed, seconds, trace, *, device, log, engine=own_engine):
    """A run of the cell `wl` with its configuration and mix as given ->
    (result, the answers kept, the reference's). `engine(kind, config, mix,
    params, state, device, pool)` builds what the window drives; the
    calibration tool puts its controls there."""
    import numpy as np
    import torch

    from .reference import config as ref_config
    from .reference.params import seeded
    from .generator import make_pool, requests, stream

    device = torch.device(device)
    kind = importlib.import_module(f"portbench.models.{config['kind']}")
    serve = config["serve"]
    ref_cfg = ref_config.load(config["model"], serve["gelu"])
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- set-up: kernels, weights, engine, clips, warm-up -------------------------
    compiled = build_kernels(device, log)
    pool = make_pool(mix["pool"], kind.clip_shapes(ref_cfg), seed, mix["wave_std"], device)
    params, state = seeded(lambda init: kind.init(init, ref_cfg), seed, device)
    eng = engine(kind, config, mix, params, state, device, pool)
    del params, state
    gc.collect()
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    spans = []
    if trace:  # each forward's call to return: the enqueue, and any wait on a full launch queue
        inner = eng.forward_batch

        def timed(*a, **k):
            t = time.perf_counter()
            with torch.profiler.record_function("portbench.forward_batch"):
                out = inner(*a, **k)
            spans.append(time.perf_counter() - t)
            return out
        eng.forward_batch = timed

    reset_launch_counts()
    eng.forward_batch(pool["wave"][:mix["batch"]], pool["image"][:mix["batch"]])
    sync(device)
    per_forward = launch_counts()
    expect = {k: n for k, (n, _) in _calls(ref_cfg, mix["batch"], serve["dtype"]).items()}
    log(f"launches a forward: {per_forward} (the routing rule: K1 {expect['K1']}, "
        f"K2 {expect['K2']}, K3 {expect['K3']}, K4 0 in {serve['dtype']})")
    if trace:
        spans.clear()
    profile = None
    profiled = {}
    if trace and device.type == "cuda":
        from .trace import profiled as under_profiler

        def profile(next_blocks):
            n0 = len(spans)
            reset_launch_counts()
            profiled.update(summary=under_profiler(next_blocks), launches=launch_counts(),
                            forwards=len(spans) - n0)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loop = stream if mix["loop"] == "stream" else requests
    res = loop(kind, eng, pool, mix, seed, seconds, profile=profile)
    outputs, clips, window = res["outputs"], res["clips"], res["window_s"]
    setup_s = _AGE0 + res["t0"] - _T0
    latencies = res.get("latencies")
    log(f"window by fifths: {res['fifths']}")
    if latencies:
        log(f"requests: {len(latencies)}, latency median {np.median(latencies) * 1e3:.3f} ms, "
            f"started late by up to {max(res['lateness']) * 1e3:.3f} ms")
    n_window_spans = len(spans) - profiled.get("forwards", 0)
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"set-up {setup_s:.3f} s (kernels compiled in this run: {compiled}); window "
        f"{window:.3f} s, {clips} clips")

    # ---- after the window: free the program, check imports, run the reference ----
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")
    check = config["check"]
    clip_ids = sorted(outputs.by_clip)
    ref = reference_outputs(kind, ref_cfg, seed, pool, clip_ids, config["reference_block"],
                            device)
    got = compare(outputs, ref)
    correct = all(got[k] <= check[k] for k in check)

    # ---- the result ----------------------------------------------------------
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(window_peak)}
    metrics = {}
    breakdown = None
    if not trace:
        e2e = {"clips_per_s": clips / window, "setup_s": setup_s}
        if latencies:
            e2e["request_p95_ms"] = float(np.percentile(np.asarray(latencies) * 1e3, 95))
        for m in metrics_of(spec, wl, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        summary = profiled.get("summary")
        ctx = {"loop": mix["loop"], "batch": mix["batch"], "clips": clips, "window_s": window,
               "spans": spans[:n_window_spans], "window_peak_bytes": window_peak,
               "flops_per_clip": flops_per_clip(kind, ref_cfg, mix["batch"]),
               "peak_flops": PEAK_FLOPS[serve["dtype"]], "trace": summary,
               "launches": profiled.get("launches", {}),
               "profiled_clips": profiled.get("forwards", 0) * mix["batch"],
               "calls": _calls(ref_cfg, mix["batch"], serve["dtype"])}
        for m in metrics_of(spec, wl, "per_layer"):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary:
            dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
            breakdown = {"device_ops": [list(t) for t in summary["top"]],
                         "idle_gaps": [list(t) for t in summary["gaps"]]}
    for k in sorted(set(got) - set(check)):
        log(f"reading {k}: {got[k]!r} (no limit)")
    for k in check:
        log(f"check {k}: {got[k]!r} (limit {check[k]!r})")
    out = {"correct": correct, "attempted": clips, "failed": 0, "metrics": metrics,
           "device": dev}
    if breakdown:
        out["breakdown"] = breakdown
    out["readings"] = got
    out["check"] = {k: {"value": got[k], "limit": check[k]} for k in check}
    return out, outputs, ref


def _calls(ref_cfg, batch, dtype):
    """{kernel: (calls a forward, bound s a forward)} at the cell's batch."""
    frames = batch * ref_cfg.num_frames
    return {k: (len(v), bound_s(v, dtype)) for k, v in calls(ref_cfg, frames, dtype).items()}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m portbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # kernel caches at fixed paths inside the checkout; the port's own nvcc
    # libraries go to dg_sct_tpu_torch/_build/ there
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".cache" / "torch_extensions")
    import torch

    spec = load_spec()
    wl, _, _ = cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0
