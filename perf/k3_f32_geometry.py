#!/usr/bin/env python3
"""K3's float32 kernel at every float32 shape of the main paths, in each
launch geometry, on one CUDA card.

    python3 perf/k3_f32_geometry.py [--reps 2] [--out perf/torch_probe_out/k3_f32_geometry.json]

Geometries (`k3_adapter_bottleneck_f32`'s `cluster` and `m`): one CTA a
16-row tile or a cluster of two CTAs a tile, each on half the groups, which
add each row's LayerNorm sums through distributed shared memory; 16-, 32-
or (one CTA a tile) 64-row tiles (one, two or four m-tiles, every weight
fragment split once for all of them); then the choice
`k3_adapter_bottleneck` makes (0, 0). Each is held against
`bottleneck_rows_plain` at chip_smoke.TOL and timed on the card alone
(`chip_smoke.time_ms`'s device_ms) beside the composed library calls,
`--reps` rounds in turns. Shapes: one B=2 AVE forward's (`kernel_cases`),
AVQA's four-group ones and the pretrain ViT's.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

GEOMETRIES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (0, 0))  # (cluster, m); (0, 0): chosen


def shapes():
    """{K3 key: (path, calls a forward)} of every float32 K3 shape."""
    from dg_sct_tpu_torch.configs import AVEModelConfig

    out = {key: ("ave", n) for name, key, n in CS.kernel_cases(AVEModelConfig())
           if name == "adapter_bottleneck"}
    out.update({key: ("avqa", n) for key, n in CS.avqa_k3_cases().items()})
    key, n = CS.pretrain_k3_case()
    out[key] = ("pretrain", n)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="perf/torch_probe_out/k3_f32_geometry.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_f32_geometry: no CUDA device", file=sys.stderr)
        return 2
    from dg_sct_tpu_torch.ops.kernels import adapter_bottleneck as K3
    from dg_sct_tpu_torch.ops.kernels.build import CudaKernel, I, P, ptr, stream_of

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    entry = CudaKernel("adapter_bottleneck", "k3_adapter_bottleneck_f32", [P] * 10 + [I] * 7 + [P])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows_out, bad = [], []
    for key, (path, n) in sorted(shapes().items()):
        rows, C, g, go, has_ln1 = key
        a = CS.k3_inputs(key, torch.float32, gen)
        ref = K3.bottleneck_rows_plain(*a, has_ln1=has_ln1)
        out = torch.empty_like(a[0])

        def run(cl, m):
            entry.launch(*map(ptr, a), ptr(out), rows, C, g, go, int(has_ln1), cl, m,
                         stream_of(out))
            return out

        def takes(cl, m):  # the entry refuses a geometry whose plan does not fit
            try:
                run(cl, m)
                return True
            except RuntimeError:
                return False

        fns = {f"{cl}x{m}": (lambda cl=cl, m=m: run(cl, m)) for cl, m in GEOMETRIES
               if takes(cl, m)}
        fns["composed"] = lambda: CS.composed_bottleneck(*a, has_ln1=has_ln1)
        row = dict(case=list(key), path=path, per_forward=n, device_ms={}, max_abs_err={})
        for name, fn in fns.items():
            if name != "composed":
                err, worst = CS.compare(fn().clone(), ref, torch.float32)
                row["max_abs_err"][name] = err
                if worst > 1.0:
                    bad.append((key, name, err))
        for _ in range(args.reps):
            for name, fn in fns.items():
                row["device_ms"].setdefault(name, []).append(CS.time_ms(fn)[1])
        rows_out.append(row)
        print(f"k3 f32 geometry: {path} {tuple(key)} x{n}: " + ", ".join(
            f"{k} {min(v) * 1e3:.1f} us" for k, v in row["device_ms"].items())
            + f"; max err {max(row['max_abs_err'].values()):.2e}", flush=True)
    for path in ("ave", "avqa", "pretrain"):
        mine = [r for r in rows_out if r["path"] == path]
        tot = {k: sum(r["per_forward"] * min(r["device_ms"][k]) for r in mine)
               for k in mine[0]["device_ms"] if all(k in r["device_ms"] for r in mine)}
        print(f"k3 f32 geometry sums: {path}, {sum(r['per_forward'] for r in mine)} calls: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in tot.items()), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=card, rows=rows_out)))
    print(f"k3 f32 geometry: {card}; {len(bad)} checks over TOL {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
