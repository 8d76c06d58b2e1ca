#!/usr/bin/env python3
"""Where the port's full-width AVE train step amplifies float32 rounding.

    python3 perf/torch_f32_probe.py [--out perf/torch_probe_out/f32_probe.json]

On one CUDA card (PyTorch only, no JAX). The step is `chip_smoke.py`'s phase-18
one-process reference (`par_dp_step`): `AVEModelConfig()` from seed 0 with its
seeded adapter gates, the global batch of 4 clips with mixup lambdas, no
draws, remat "full". It runs in float64, then in float32 on the same inputs;
every autograd node the forward creates (keyed by the port's source line
that called the op, the node's name and its count at that line) gets a hook
that samples its output gradient (what flows in from the loss) and its input
gradients (what it passes on) at fixed seeded positions. Per node the float32
run's relative error against the float64 run is read on both sides: a node
whose input gradients err orders of magnitude more than its output gradient
is an amplifier. Named points are recorded too: each tower block's output,
each adapter's input and output, and the heads' inputs. Then the float32
trainable leaves' move under the clips in reverse order.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import zlib
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

SAMPLES = 2048
PORT = str(ROOT / "dg_sct_tpu_torch")


def _site():
    """The port's source line that called the current op."""
    f = sys._getframe(2)
    while f is not None and not f.f_code.co_filename.startswith(PORT):
        f = f.f_back
    if f is None:
        return "?"
    return f"{Path(f.f_code.co_filename).relative_to(ROOT)}:{f.f_lineno}"


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


class Probe(TorchFunctionMode):
    """Hooks every autograd node created while it is on; `ref` (the float64
    run's samples) turns sampling into errors."""

    def __init__(self, ref=None):
        super().__init__()
        self.ref = ref
        self.samples, self.errors, self.order = {}, {}, []
        self.counts, self.keep, self.seen = Counter(), [], set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            node = t.grad_fn
            if node is None or id(node) in self.seen or not t.is_floating_point():
                continue
            self.seen.add(id(node))
            self.keep.append(node)
            base = f"{_site()} {node.name()}"
            key = f"{base} {self.counts[base]}"
            self.counts[base] += 1
            self.order.append(key)
            node.register_hook(self._hook(key))
        return out

    def _sample(self, key, slot, g):
        flat = g.detach().reshape(-1)
        n = flat.numel()
        if n > SAMPLES:
            gen = torch.Generator(device=flat.device)
            gen.manual_seed(zlib.crc32(f"{key}/{slot}/{n}".encode()))
            flat = flat[torch.randint(n, (SAMPLES,), generator=gen, device=flat.device)]
        return flat.double().cpu()

    def _hook(self, key):
        def hook(grad_inputs, grad_outputs):
            sides = {}
            for side, gs in (("out", grad_outputs), ("in", grad_inputs)):
                sides[side] = [None if g is None else self._sample(key, f"{side}{i}", g)
                               for i, g in enumerate(gs)]
            if self.ref is None:
                self.samples[key] = sides
                return
            ref = self.ref.get(key)
            if ref is None:
                return
            err = {}
            for side in ("out", "in"):
                num = den = 0.0
                slots = []
                for a, b, g in zip(sides[side], ref[side],
                                   grad_outputs if side == "out" else grad_inputs):
                    if a is None or b is None or a.shape != b.shape:
                        slots.append(None)
                        continue
                    n, d = float(((a - b) ** 2).sum()), float((b ** 2).sum())
                    num, den = num + n, den + d
                    slots.append([(n / d) ** 0.5 if d > 0 else None, g.numel()])
                err[side] = (num / den) ** 0.5 if den > 0 else None
                err[side + "_slots"] = slots
            self.errors[key] = err
        return hook


NAMED = []   # (name, tensor) of the named points, filled while recording


def _named(name, t):
    if torch.is_grad_enabled() and isinstance(t, torch.Tensor) and t.requires_grad and RECORD[0]:
        NAMED.append((name, t))


RECORD = [False]
CALLS = Counter()            # named points so far, by kind, in the recorded forward
PATCHED = []


def _patch():
    """Wrap the tower steps, the adapters and the heads to name their
    boundaries (only while RECORD[0]: the checkpointed steps run again in
    the backward). Once a process."""
    if PATCHED:
        return
    from dg_sct_tpu_torch.models import adapter as A
    from dg_sct_tpu_torch.models import interleave as I
    from dg_sct_tpu_torch.models.heads import ave as HA

    calls = CALLS
    paired, plain, adapter, heads = I._paired_step, I._plain_step, A.adapter, HA.temporal_attention

    def paired_step(blk_params, blk_state, f_v, f_a, *a, vmeta, ameta, **kw):
        out = paired(blk_params, blk_state, f_v, f_a, *a, vmeta=vmeta, ameta=ameta, **kw)
        n = calls["pair"]
        calls["pair"] += RECORD[0]
        _named(f"paired step {n}: swin block out (dim {vmeta['dim']})", out[0])
        _named(f"paired step {n}: htsat block out (dim {ameta['dim']})", out[1])
        return out

    def plain_step(vp, f_v, v_drop, *, vmeta, **kw):
        out = plain(vp, f_v, v_drop, vmeta=vmeta, **kw)
        n = calls["plain"]
        calls["plain"] += RECORD[0]
        _named(f"plain step {n}: swin block out (dim {vmeta['dim']})", out)
        return out

    def adapter_(params, state, x, other, cfg, **kw):
        res, maps, st = adapter(params, state, x, other, cfg, **kw)
        n = calls["adapter"]
        calls["adapter"] += RECORD[0]
        _named(f"adapter {n}: in x (C {x.shape[-1]})", x)
        _named(f"adapter {n}: in other (C {other.shape[-1]})", other)
        _named(f"adapter {n}: out residual", res)
        _named(f"adapter {n}: out maps", maps)
        return res, maps, st

    def heads_(params, f_v, f_a, **kw):
        _named("heads: in f_v", f_v)
        _named("heads: in f_a", f_a)
        return heads(params, f_v, f_a, **kw)

    I._paired_step, I._plain_step, A.adapter, HA.temporal_attention = (
        paired_step, plain_step, adapter_, heads_)
    PATCHED.append(True)


def step(cfg, device, dtype, probe=None, reverse=False):
    """par_dp_step's loss and gradient (no optimizer) -> (loss, {path: grad},
    {named point: grad})."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.train import ave_train, losses
    from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

    params, state = CS.seeded_model(cfg, device=device)
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    params = tree_map(cast, params)
    tr, fr = ave_train.partition_params(params)
    b = CS.par_dp_batch(cfg)
    if reverse:
        b = {k: np.ascontiguousarray(v.reshape((CS.PAR_BATCH, -1) + v.shape[1:])[::-1]
                                     .reshape(v.shape)) for k, v in b.items()}
    batch = {k: cast(torch.as_tensor(v, device=device)) for k, v in b.items()}
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tr)]
    merged = ave_train.merge_params(tree_unflatten(tr, leaves), fr)
    NAMED.clear()
    CALLS.clear()
    RECORD[0] = probe is not None
    ecfg = dataclasses.replace(cfg, compute_dtype=dtype)
    with probe if probe is not None else contextlib.nullcontext():
        out, _ = ave.forward(merged, cast_state(state, dtype), batch["wave"], batch["image"], ecfg,
                             train=True, device=device, gen=None,
                             mixup_lambda=batch["mixup_lambda"], remat_policy="full")
        loss = losses.ave_loss(out, batch["gt"])
    RECORD[0] = False
    named = list(NAMED)
    got = torch.autograd.grad(loss, leaves + [t for _, t in named], allow_unused=True)
    paths = [p for p, _ in tree_paths(tr)]
    grads = {"/".join(map(str, p)): g for p, g in zip(paths, got[:len(leaves)])}
    points = {}
    for (name, _), g in zip(named, got[len(leaves):]):
        points[name] = None if g is None else g.detach().cpu()
    return float(loss), grads, points


def cast_state(state, dtype):
    from dg_sct_tpu_torch.utils.tree import tree_map
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, state)


def rel(a, b):
    return float(torch.linalg.vector_norm((a.double() - b.double()).reshape(-1))
                 / torch.linalg.vector_norm(b.double().reshape(-1)).clamp_min(1e-300))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="perf/torch_probe_out/f32_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    from dg_sct_tpu_torch.configs import AVEModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    cfg, device = AVEModelConfig(), torch.device("cuda", 0)
    summarize(run(cfg, device, card), out)
    return 0


def run(cfg, device, card):
    """The float64 and float32 steps with their probes -> the report."""
    _patch()
    t0 = time.perf_counter()
    ref = Probe()
    loss64, g64, p64 = step(cfg, device, torch.float64, ref)
    samples = ref.samples
    order = ref.order
    del ref
    torch.cuda.empty_cache()
    probe = Probe(ref=samples)
    loss32, g32, p32 = step(cfg, device, torch.float32, probe)
    errors = probe.errors
    del probe, samples
    torch.cuda.empty_cache()
    _, g32r, _ = step(cfg, device, torch.float32, reverse=True)
    seconds = time.perf_counter() - t0

    groups = {"adapters": lambda p: p.startswith("adapters/"),
              "the rest": lambda p: not p.startswith("adapters/")}
    leaf = {}
    for name, keep in groups.items():
        ks = [p for p in g64 if keep(p) and g64[p] is not None]
        cat = lambda g: torch.cat([g[p].double().reshape(-1) for p in ks])
        leaf[name] = {"f32_vs_f64": rel(cat(g32), cat(g64)),
                      "f32_reordered": rel(cat(g32r), cat(g32))}
    per_leaf = sorted(((rel(g32[p], g64[p]), p) for p in g64
                       if g64[p] is not None and bool(g64[p].any())),
                      reverse=True)
    points = [{"point": n, "f32_vs_f64": None if p64.get(n) is None or p32.get(n) is None
               else rel(p32[n], p64[n])} for n in p64]
    nodes = [dict(errors[k], node=k) for k in order if k in errors]
    for n in nodes:
        n["gain"] = (n["in"] / n["out"] if n["in"] is not None and n["out"]
                     else None)
    return {"card": card, "seconds": seconds, "loss": {"f64": loss64, "f32": loss32},
            "leaves": leaf, "worst_leaves": per_leaf[:40], "points": points, "nodes": nodes}


def summarize(report, out):
    """Write the report and print its lines."""
    out.write_text(json.dumps(report))
    card, seconds, leaf = report["card"], report["seconds"], report["leaves"]
    loss64, loss32 = report["loss"]["f64"], report["loss"]["f32"]
    per_leaf, points, nodes = report["worst_leaves"], report["points"], report["nodes"]
    print(f"f32 probe: {card}; B={CS.PAR_BATCH}, no draws, remat full; {seconds:.1f} s; loss f64 "
          f"{loss64:.12f} f32 {loss32:.9f}; leaves' relative L2, f32 vs f64 / f32 reordered: "
          + "; ".join(f"{k} {v['f32_vs_f64']:.3e} / {v['f32_reordered']:.3e}"
                      for k, v in leaf.items()), flush=True)
    for e, p in per_leaf[:12]:
        print(f"f32 probe leaf: {p} {e:.3e}")
    for pt in points[::-1]:
        print(f"f32 probe point: {pt['point']}: "
              + ("none" if pt["f32_vs_f64"] is None else f"{pt['f32_vs_f64']:.3e}"))
    big = sorted((n for n in nodes if n["gain"] is not None and n["in"] > 1e-5),
                 key=lambda n: -n["gain"])[:25]
    for n in big:
        print(f"f32 probe node: {n['node']}: out {n['out']:.3e} -> in {n['in']:.3e} "
              f"(gain {n['gain']:.3e})")
    print(f"f32 probe: {len(nodes)} nodes compared; report {out}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
