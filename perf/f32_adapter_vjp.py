#!/usr/bin/env python3
"""Hold the port's float32 train-mode adapter VJP against the JAX package's,
on adapter calls captured from the port's full-width AVE float64 train step.

    JAX_PLATFORMS=cpu python3 perf/f32_adapter_vjp.py [--dir perf/torch_probe_out]

On the CPU; it imports both packages (the port never imports JAX). The
capture comes from `perf/torch_f32_probe.py --capture 46 47 --piece K`, one
chip call a piece, into one directory. For each captured call it runs the
adapter's train-mode forward (`adapter(..., train=True)`: batch statistics in
both BNs) and its VJP with the captured output gradients, in both packages:
  - JAX: `dg_sct_tpu/models/adapter.py` `adapter`, x64 on for the float64
    side, matmul precision "highest" (as `tests/conftest.py` sets);
  - the port: `dg_sct_tpu_torch/models/adapter.py` `adapter` (kernels off),
    the same numpy weights as tensors;
each in float64 and in float32, the batch's clips in order and reversed (the
gradients of a reversed run are put back in order). For the gradients of x,
of other, of every parameter leaf, and of all parameter leaves together, it
prints the relative L2 of each float32 run against the same package's
float64 run in order, and checks that the two packages' float64 gradients
agree. It also prints each package's float64 gain: how many times the
relative error of an output gradient (a seeded elementwise move of NUDGE)
grows by the time it reaches x, other and the parameters; and, where the
directory holds `capture_f32_grads.npz` (`--f32-grads`), how far the error
that the float32 step's own output gradients bring is carried back.

Verdict (decided before the first reading at full width, PERF.md §6): the
port has a float32 fault in a call where, in either order, its error on
x, on other or on all parameters together exceeds RATIO times
JAX's, unless both are below FLOOR (rounded at float32's own level in both
packages, where a ratio compares noise). Single leaves are printed, not
read: a scalar bias whose gradient is a cancelling sum errs by its
summation order. Leaves whose gradient is zero in exact arithmetic are
left out (ZERO).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from dg_sct_tpu.configs import AdapterConfig as JAdapterConfig  # noqa: E402
from dg_sct_tpu.models import adapter as JA  # noqa: E402
from dg_sct_tpu_torch.configs import AdapterConfig as PAdapterConfig  # noqa: E402
from dg_sct_tpu_torch.models import adapter as PA  # noqa: E402

RATIO = 2.0    # the port's float32 error may be at most this many times JAX's
FLOOR = 1e-5   # below this relative L2 in both packages a ratio is not read
ZERO = 1e-9    # a leaf whose float64 gradient RMS is below this share of the call's
               # parameter-gradient RMS is zero in exact arithmetic (ln_before's bias,
               # ahead of a train-mode BN): its float32 "error" is all rounding
VERDICT = ("x", "other", "params")  # the gradients the verdict reads
NUDGE = 1e-6   # relative move of the output gradients for the float64 gain


def load_capture(d: Path):
    """-> (manifest, {array name: numpy array}) from every piece in d."""
    manifest = json.loads((d / "capture.json").read_text())
    arrays = {}
    for k in range(len(manifest["pieces"])):
        f = d / f"capture_piece{k}.npz"
        if not f.exists():
            raise FileNotFoundError(f"{f}: run torch_f32_probe.py --piece {k} into {d}")
        with np.load(f) as z:
            arrays.update({name: z[name] for name in z.files})
    return manifest, arrays


def nest(flat: dict) -> dict:
    """{"a/b": v} -> {"a": {"b": v}}."""
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def call_inputs(manifest, arrays, n):
    """One captured call -> (x, other, g_res, g_maps, params, state, cfg dict) in
    numpy, float arrays as float64."""
    info = manifest["calls"][str(n)]
    f = info["fields"]
    get = lambda k: arrays[f[k]].astype(np.float64) if arrays[f[k]].dtype.kind == "f" \
        else arrays[f[k]]
    params = nest({k[len("params/"):]: get(k) for k in f if k.startswith("params/")})
    state = nest({k[len("state/"):]: get(k) for k in f if k.startswith("state/")})
    return get("x"), get("other"), get("g_res"), get("g_maps"), params, state, info["cfg"]


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def reorder(a, batch, reverse):
    """The batch's clips (leading rows in `batch` runs) reversed, or a as is."""
    if not reverse:
        return a
    return np.ascontiguousarray(a.reshape((batch, -1) + a.shape[1:])[::-1].reshape(a.shape))


def cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.astype(dtype) if tree.dtype.kind == "f" else tree


def jax_vjp(inp, dtype, batch, reverse):
    """JAX's adapter VJP -> {"x", "other", "params/<leaf>": float64 numpy}."""
    x, other, g_res, g_maps, params, state, cfg = inp[:7]
    r = lambda a: jnp.asarray(reorder(a, batch, reverse).astype(dtype))
    jstate = jax.tree_util.tree_map(jnp.asarray, cast(state, dtype))
    jparams = jax.tree_util.tree_map(jnp.asarray, cast(params, dtype))
    acfg = JAdapterConfig(**cfg)

    def f(x, other, p):
        res, maps, _ = JA.adapter(p, jstate, x, other, acfg, train=True)
        return res, maps

    _, vjp = jax.vjp(f, r(x), r(other), jparams)
    gx, go, gp = vjp((r(g_res), r(g_maps)))
    back = lambda a: reorder(np.asarray(a, np.float64), batch, reverse)
    out = {"x": back(gx), "other": back(go)}
    out.update({f"params/{k}": np.asarray(v, np.float64) for k, v in leaves(gp)})
    return out


def port_vjp(inp, dtype, batch, reverse):
    """The port's adapter VJP -> {"x", "other", "params/<leaf>": float64 numpy}."""
    x, other, g_res, g_maps, params, state, cfg = inp[:7]
    tdt = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    t = lambda a: torch.from_numpy(reorder(a, batch, reverse).astype(dtype))
    conv = lambda tree: {k: conv(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else torch.from_numpy(tree.astype(dtype) if tree.dtype.kind == "f" else tree)
    pparams, pstate = conv(params), conv(state)
    named = leaves(pparams)
    for _, v in named:
        v.requires_grad_()
    xt, ot = t(x).requires_grad_(), t(other).requires_grad_()
    res, maps, _ = PA.adapter(pparams, pstate, xt, ot, PAdapterConfig(**cfg), kernels=False,
                              train=True)
    grads = torch.autograd.grad([res, maps], [xt, ot] + [v for _, v in named],
                                grad_outputs=[t(g_res).to(tdt), t(g_maps).to(tdt)],
                                allow_unused=True)
    back = lambda g: reorder(g.double().numpy(), batch, reverse)
    out = {"x": back(grads[0]), "other": back(grads[1])}
    for (k, v), g in zip(named, grads[2:]):
        out[f"params/{k}"] = np.zeros(v.shape) if g is None else g.double().numpy()
    return out


def rel(a, b):
    d = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / d if d > 0 else None


def errors(got, ref):
    """Relative L2 of each gradient of `got` against `ref`, plus all the
    parameters together ("params"); leaves zero in exact arithmetic left out."""
    keys = [k for k in ref if k.startswith("params/")]
    cat = lambda g: np.concatenate([g[k].reshape(-1) for k in keys])
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    floor = ZERO * rms(cat(ref))
    out = {k: rel(got[k], ref[k]) for k in ref if not k.startswith("params/")
           or rms(ref[k]) > floor}
    out["params"] = rel(cat(got), cat(ref))
    return out


def nudged(inp, eps=NUDGE, seed=0):
    """The call with both output gradients moved by a relative eps, elementwise
    (seeded): how far the VJP carries an error that arrives with them."""
    rs = np.random.RandomState(seed)
    g_res, g_maps = inp[2], inp[3]
    return inp[:2] + (g_res * (1 + eps * rs.randn(*g_res.shape)),
                      g_maps * (1 + eps * rs.randn(*g_maps.shape))) + inp[4:]


def compare_call(manifest, arrays, n, f32_grads=None):
    inp = call_inputs(manifest, arrays, n)
    batch = manifest["batch"]
    runs = {"jax": jax_vjp, "port": port_vjp}
    ref = {pkg: fn(inp, np.float64, batch, False) for pkg, fn in runs.items()}
    agree = errors(ref["port"], ref["jax"])
    report = {"float64_port_vs_jax": {k: agree[k] for k in VERDICT}, "orders": {}}
    # float64 gain: relative move of each gradient over the output gradients' NUDGE
    report["gain"] = {pkg: {k: v / NUDGE for k, v in
                            errors(fn(nudged(inp), np.float64, batch, False), ref[pkg]).items()
                            if k in VERDICT} for pkg, fn in runs.items()}
    if f32_grads is not None:
        # the float32 step's own output gradients through the float64 VJP (it is
        # linear in them): the error they bring, carried to x, other and the parameters
        g32 = [f32_grads[f"{n}/{f}"].astype(np.float64) for f in ("g_res", "g_maps")]
        report["arriving"] = {f: rel(g, inp[2 + i]) for i, (f, g) in
                              enumerate(zip(("g_res", "g_maps"), g32))}
        carried = inp[:2] + tuple(g32) + inp[4:]
        report["carried"] = {pkg: {k: v for k, v in
                                   errors(fn(carried, np.float64, batch, False), ref[pkg]).items()
                                   if k in VERDICT} for pkg, fn in runs.items()}
    faults = []
    for order, reverse in (("in order", False), ("reversed", True)):
        e = {pkg: errors(fn(inp, np.float32, batch, reverse), ref[pkg])
             for pkg, fn in runs.items()}
        rows = []
        for k in e["jax"]:
            j, p = e["jax"][k], e["port"][k]
            if j is None or p is None:
                continue
            ratio = p / j if j > 0 else float("inf")
            fault = k in VERDICT and ratio > RATIO and max(p, j) >= FLOOR
            rows.append(dict(grad=k, jax=j, port=p, ratio=ratio, fault=fault))
            if fault:
                faults.append(f"call {n} {order} {k}")
        report["orders"][order] = rows
    report["faults"] = faults
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="perf/torch_probe_out",
                    help="directory holding capture.json and every capture_piece*.npz")
    ap.add_argument("--calls", type=int, nargs="*", help="captured calls (default: all)")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", help="write the report here as JSON")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    d = Path(args.dir)
    manifest, arrays = load_capture(d)
    calls = args.calls or sorted(int(k) for k in manifest["calls"])
    f32_grads = None
    if (d / "capture_f32_grads.npz").exists():
        with np.load(d / "capture_f32_grads.npz") as z:
            f32_grads = {k: z[k] for k in z.files}
    print(f"f32 adapter vjp: capture {d} ({manifest['card']}, float64 step loss "
          f"{manifest['loss_f64']:.12f}); rule: port > {RATIO}x JAX unless both < {FLOOR}",
          flush=True)
    reports = {}
    for n in calls:
        info = manifest["calls"][str(n)]
        rep = reports[n] = compare_call(manifest, arrays, n, f32_grads)
        ratio = info["token_mean_over_std"]
        print(f"f32 adapter vjp: call {n}: x {manifest['shapes'][info['fields']['x']]}, other "
              f"{manifest['shapes'][info['fields']['other']]}; per-token |mean| / std (median, "
              f"max) x {ratio['x'][0]:.4f}, {ratio['x'][1]:.4f}, other {ratio['other'][0]:.4f}, "
              f"{ratio['other'][1]:.4f}; float64 port vs JAX (x, other, params) "
              + ", ".join(f"{v:.3e}" for v in rep["float64_port_vs_jax"].values())
              + "; float64 gain of an output-gradient error (x, other, params): " + "; ".join(
                  f"{pkg} " + ", ".join(f"{v:.1f}" for v in g.values())
                  for pkg, g in rep["gain"].items()), flush=True)
        if "carried" in rep:
            print(f"f32 adapter vjp: call {n}: the float32 step's output gradients err (g_res, "
                  f"g_maps) " + ", ".join(f"{v:.3e}" for v in rep["arriving"].values())
                  + "; carried back by the float64 VJP to (x, other, params): " + "; ".join(
                      f"{pkg} " + ", ".join(f"{v:.3e}" for v in g.values())
                      for pkg, g in rep["carried"].items()), flush=True)
        for order, rows in rep["orders"].items():
            for row in rows:
                if row["grad"] in VERDICT or row["fault"] or \
                        row["grad"].endswith(("down/kernel", "up/kernel", "ln_before/scale")):
                    print(f"f32 adapter vjp: call {n} {order}: {row['grad']}: f32 vs f64 JAX "
                          f"{row['jax']:.3e}, port {row['port']:.3e} (ratio {row['ratio']:.3f})"
                          + ("  FAULT" if row["fault"] else ""), flush=True)
            high = [r for r in rows if r["ratio"] > RATIO and max(r["jax"], r["port"]) >= FLOOR]
            print(f"f32 adapter vjp: call {n} {order}: {len(rows) - 3} leaves; over {RATIO}x "
                  f"above the floor: " + (", ".join(
                      f"{r['grad']} {r['ratio']:.3f} (JAX {r['jax']:.3e}, port {r['port']:.3e})"
                      for r in high) or "none"), flush=True)
    faults = [f for r in reports.values() for f in r["faults"]]
    if args.out:
        Path(args.out).write_text(json.dumps({str(k): v for k, v in reports.items()}, indent=1))
    print("f32 adapter vjp: verdict: "
          + (f"the port has a float32 fault: {faults}" if faults else
             f"the port's float32 error is within {RATIO}x JAX's on x, other and the "
             f"parameters of every captured call, in both orders: the sensitivity belongs to "
             f"the model"), flush=True)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
