"""Readings that the check's limits and the request rate are set from, on
the card.

    python -m portbench.calibrate --workload <name> --seeds 11 12 ... \\
        [--int8-seeds 21 22 23] [--fp8-seeds 31 32 33] [--f32-seeds 41] \\
        [--plain-seeds 42] [--rates 3.5 4.5 --rate-seed 51] [--seconds 8] [--dump DIR]

Each seed is a whole run of the cell (untraced) in this one process, so the
kernels are built once: `--seeds` as the cell serves (bf16); `--int8-seeds`
through the program's int8 path at static scales and `--fp8-seeds` the
reference computed in fp8 in the program's place, the two controls (a
configuration's "control" names by its "kind" the one its limits are held
against); `--f32-seeds` the program in float32 (a second witness beside the
reference) and `--plain-seeds` in bf16 with the kernels off. `--rates`
serves the request mix at each rate (requests a second) to find the highest
it sustains. `--dump` keeps each run's answers (npz, float16). One JSON line
a run goes to standard output and to `--out`.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

from . import bench


def variant(workload, seed, seconds, *, serve=None, mix=None, int8=False, device="cuda",
            root=None, log=lambda s: print(s, file=sys.stderr, flush=True)):
    """A run of the cell with entries of its configuration's serving
    (`serve`) or of its mix (`mix`) changed, or through the program's int8
    path -> (result, the answers kept, the reference's)."""
    root = root or bench.CHECKOUT
    spec = bench.load_spec(root)
    wl, config, traffic = bench.cell(spec, workload, root)
    config = copy.deepcopy(config)
    config["serve"].update(serve or {})
    traffic = dict(traffic, **(mix or {}))
    engine = bench.own_engine
    if int8:
        def engine(kind, config, mix, params, state, device, pool):
            calib = pool["wave"][:mix["batch"]], pool["image"][:mix["batch"]]
            return kind.int8_engine(config["model"], config["serve"], mix, params, state, device,
                                    calib)
    return bench.run_cell(spec, wl, config, traffic, seed, seconds, False, device=device,
                          log=log, engine=engine)


def fp8_control(workload, seed, device="cuda", root=None):
    """The reference computed in fp8 (`control.fp8`) over the cell's pool,
    in blocks of the configuration's reference block, judged against the
    float32 reference by the cell's check -> {"correct", "readings"}."""
    import importlib

    import numpy as np

    from .control import fp8
    from .reference import config as ref_config
    from .generator import Outputs, make_pool

    root = root or bench.CHECKOUT
    _, config, mix = bench.cell(bench.load_spec(root), workload, root)
    kind = importlib.import_module(f"portbench.models.{config['kind']}")
    ref_cfg = ref_config.load(config["model"], config["serve"]["gelu"])
    pool = make_pool(mix["pool"], kind.clip_shapes(ref_cfg), seed, mix["wave_std"], device)
    clips = list(range(mix["pool"]))
    args = (kind, ref_cfg, seed, pool, clips, config["reference_block"], device)
    ref = bench.reference_outputs(*args)
    low = bench.reference_outputs(*args, precision=fp8())
    outputs = Outputs()
    outputs.add({k: np.stack([low[j][k] for j in clips]) for k in low[0]}, clips)
    got = bench.compare(outputs, ref)
    return {"correct": all(got[k] <= v for k, v in config["check"].items()), "readings": got}


def control(workload, seed, seconds=3.0, device="cuda", root=None):
    """The cell's control, as its configuration's control "kind" names it
    ("int8_static": the program's int8 path; "fp8_reference": the reference
    in fp8 in the program's place) -> {"correct", "readings"}."""
    root = root or bench.CHECKOUT
    _, config, _ = bench.cell(bench.load_spec(root), workload, root)
    kind = config["control"]["kind"]
    if kind == "int8_static":
        return variant(workload, seed, seconds, int8=True, device=device, root=root)[0]
    if kind == "fp8_reference":
        return fp8_control(workload, seed, device=device, root=root)
    raise ValueError(f"unknown control kind {kind!r}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--int8-seeds", type=int, nargs="*", default=[])
    p.add_argument("--f32-seeds", type=int, nargs="*", default=[])
    p.add_argument("--plain-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fp8-seeds", type=int, nargs="*", default=[])
    p.add_argument("--dump", help="a directory for each run's answers (npz, float16)")
    p.add_argument("--rates", type=float, nargs="*", default=[])
    p.add_argument("--rate-seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default="portbench/out/calibrate.jsonl")
    args = p.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    rows = []

    def keep(seed, name, r):
        row = {"workload": args.workload, "seed": seed, "variant": name,
               "correct": r["correct"], "readings": r["readings"],
               "metrics": {k: v["value"] for k, v in r.get("metrics", {}).items()},
               "memory_peak_bytes": r.get("device", {}).get("memory_peak_bytes", 0)}
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        rows.append(row)

    def one(seed, name, **kw):
        r, outputs, ref = variant(args.workload, seed, args.seconds, **kw)
        if args.dump:
            dump(Path(args.dump) / f"{args.workload}-{seed}-{name.replace(' ', '_')}.npz",
                 outputs, ref)
        keep(seed, name, r)

    for s in args.seeds:
        one(s, "bf16")
    for s in args.int8_seeds:
        one(s, "int8 static", int8=True)
    for s in args.f32_seeds:  # the program in float32: the second witness
        one(s, "float32", serve={"dtype": "float32", "gelu": "exact", "stft_bf16": False})
    for s in args.plain_seeds:  # bf16 with the kernels off: the plain path's own rounding
        one(s, "bf16 plain", serve={"kernels": False})
    for s in args.fp8_seeds:  # the reference in fp8 in the program's place
        keep(s, "fp8 reference", fp8_control(args.workload, s))
    for rate in args.rates:  # the request mix at each rate, requests a second
        one(args.rate_seed, f"rate {rate}", mix={"rate": rate})
    for name in sorted({r["variant"] for r in rows}):
        sel = [r for r in rows if r["variant"] == name]
        for k in sel[0]["readings"]:
            vals = [r["readings"][k] for r in sel]
            print(f"{name} {k}: min {min(vals)!r} max {max(vals)!r} over {len(vals)} seeds",
                  flush=True)
    return 0


def dump(path, outputs, ref):
    """The answers compared and the reference's, as float16 npz; masks as
    means of 4x4 pixels, to keep the files small."""
    import numpy as np

    arrays = {}
    for out in next(iter(ref.values())):
        p, r = bench.paired(outputs, ref, out)
        if p.ndim == 4:
            shape = p.shape[:2] + (p.shape[2] // 4, 4, p.shape[3] // 4, 4)
            p, r = p.reshape(shape).mean((3, 5)), r.reshape(shape).mean((3, 5))
        arrays[f"program.{out}"] = p.astype(np.float16)
        arrays[f"reference.{out}"] = r.astype(np.float16)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


if __name__ == "__main__":
    sys.exit(main())
