"""Experiment metrics: an append-only JSONL stream (one event a line: step,
seconds since the logger started, scalars), the records of
`dg_sct_tpu/utils/metrics_log.py`.

    logger = MetricsLogger(run_dir, run_name="ave", config=vars(args))
    logger.log({"loss": 0.31, "acc": 71.2}, step=120, prefix="train/")
    logger.close()
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from typing import Mapping, Optional

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _to_scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def snapshot_run(run_dir: str, *, config: Optional[Mapping] = None) -> str:
    """Copy this package's sources (.py, .cpp, .h, .cu, .cuh) into
    `<run_dir>/code/` and write `run_meta.json` (package root, git revision
    when git answers, the run's config), so a run directory describes
    itself. Returns the code directory."""
    code_dir = os.path.join(run_dir, "code")
    os.makedirs(code_dir, exist_ok=True)
    for dirpath, dirnames, files in os.walk(PACKAGE_ROOT):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
        rel = os.path.relpath(dirpath, PACKAGE_ROOT)
        for name in files:
            if name.endswith((".py", ".cpp", ".h", ".cu", ".cuh")):
                dst = os.path.join(code_dir, rel, name)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copyfile(os.path.join(dirpath, name), dst)
    meta = {"package_root": PACKAGE_ROOT}
    try:
        meta["git_rev"] = subprocess.run(["git", "rev-parse", "HEAD"], cwd=PACKAGE_ROOT,
                                         text=True, capture_output=True,
                                         timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    if config is not None:
        meta["config"] = {k: _to_scalar(v) for k, v in dict(config).items()}
    with open(os.path.join(run_dir, "run_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return code_dir


class MetricsLogger:
    """JSONL scalar logger; `run_dir=None` logs nothing."""

    def __init__(self, run_dir: Optional[str], run_name: str = "run",
                 config: Optional[Mapping] = None):
        self.run_dir = run_dir
        self._fh = None
        self._t0 = time.time()
        if run_dir is None:
            return
        os.makedirs(run_dir, exist_ok=True)
        self._fh = open(os.path.join(run_dir, f"{run_name}.metrics.jsonl"), "a")
        if config is not None:
            self._emit({"event": "config",
                        "config": {k: _to_scalar(v) for k, v in dict(config).items()}})

    def _emit(self, rec: dict):
        if self._fh is None:
            return
        rec.setdefault("time", round(time.time() - self._t0, 3))
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log(self, scalars: Mapping[str, float], step: int, prefix: str = ""):
        vals = {prefix + k: _to_scalar(v) for k, v in scalars.items()}
        self._emit({"event": "scalars", "step": int(step), **vals})

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
