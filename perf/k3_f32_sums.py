#!/usr/bin/env python3
"""K3's rows of `chip_smoke.py` phase-3 logs, shape by shape and summed over
one forward's calls, for logs of different commits side by side.

    python3 perf/k3_f32_sums.py LOG [LOG ...]

Reads the `kernel {...}`, `kernel avqa {...}` and `kernel pretrain {...}`
JSON rows that phase 3 prints for K3 (a commit's `python3 chip_smoke.py
--only adapter_bottleneck`, run from its own checkout) and prints, for each
log, dtype and path (one B=2 AVE forward's 48 calls, one AVQA forward's 48,
the pretrain ViT's 24), each shape's device time a call against the composed
library calls, then the sums: kernel and composed device ms, the bound, the
largest error against the plain version. No card needed.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

PATHS = {"kernel": ("ave", "per_forward"), "kernel avqa": ("avqa", "avqa_per_forward"),
         "kernel pretrain": ("pretrain", "pretrain_per_forward")}


def k3_rows(log: Path):
    """{(path, dtype): [row, ...]} of the log's K3 rows that carry calls."""
    out = {}
    for line in log.read_text().splitlines():
        tag, _, rest = line.partition(" {")
        if tag not in PATHS or not rest:
            continue
        row = json.loads("{" + rest)
        path, n_key = PATHS[tag]
        if row.get("name") != "adapter_bottleneck" or not row.get(n_key):
            continue
        row["calls"] = row[n_key]
        out.setdefault((path, row["dtype"]), []).append(row)
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for name in argv:
        log = Path(name)
        for (path, dtype), rows in sorted(k3_rows(log).items()):
            tot = lambda k: sum(r["calls"] * r[k] for r in rows)
            for r in sorted(rows, key=lambda r: r["case"]):
                print(f"k3 {log.name} {path} {dtype} {tuple(r['case'])} x{r['calls']}: device "
                      f"{r['kernel_device_ms'] * 1e3:.1f} us, composed "
                      f"{r['composed_device_ms'] * 1e3:.1f} us, max abs err {r['max_abs_err']:.2e}")
            print(f"k3 sums {log.name} {path} {dtype}: {sum(r['calls'] for r in rows)} calls: "
                  f"kernel {tot('kernel_device_ms'):.4f} ms on the card, "
                  f"{tot('kernel_ms'):.4f} ms as issued; composed {tot('composed_device_ms'):.4f} "
                  f"ms; bound {tot('bound_ms'):.4f} ms; max abs err "
                  f"{max(r['max_abs_err'] for r in rows):.3e}; shapes slower than composed: "
                  f"{[tuple(r['case'][:3]) for r in rows if r['kernel_device_ms'] > r['composed_device_ms']]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
