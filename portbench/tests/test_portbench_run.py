"""Whole runs at tiny sizes on the CPU: every cell, the faults the check
must catch, the import guard, and a cell, a configuration, a mix and a
metric added as files."""
import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import bench
from portbench.models import ave as kind_ave
from portbench.models import avs as kind_avs

from .tiny import REPO, tiny_checkout

CELLS = [w["name"] for w in bench.load_spec()["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def _run(root, wl, trace=False, seconds=1.0):
    return bench.run(wl, 2 ** 31 + 99, seconds, trace, device="cpu", root=root,
                     log=lambda s: None)


@pytest.mark.parametrize("wl", CELLS)
def test_cell_dry_run(root, wl):
    r = _run(root, wl)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "check"
    assert "setup_s" in r["metrics"]
    for v in r["check"].values():
        assert 0 <= v["value"] < 1e-4 < v["limit"]


def _plant(v, fault, batch):
    v = v.clone()
    if fault == "half batch":   # half the batch left out, the mean taken over the rest
        rows = v.reshape(batch, -1)
        rows[batch // 2:] = rows[:batch // 2].mean(0, keepdim=True)
    else:                       # one answer altered where it is produced
        v[0] = -v[0]
    return v


def _faulty(build, fault):
    """`build`, the kind's engine builder, with `fault` planted under the
    timed path (the engine's forward)."""
    def engine(*a, **k):
        eng = build(*a, **k)
        inner, batch = eng.forward_batch, eng.B

        def broken(*args, **kw):
            out = inner(*args, **kw)
            if isinstance(out, dict):
                return {name: _plant(v, fault, batch) for name, v in out.items()}
            return _plant(out, fault, batch)
        eng.forward_batch = broken
        return eng
    return engine


@pytest.mark.parametrize("fault", ["half batch", "answer altered"])
@pytest.mark.parametrize("wl, kind", [("ave-stream-b16", kind_ave), ("ave-request-b8", kind_ave),
                                      ("avs-stream-b16", kind_avs)])
def test_faults_are_not_correct(root, monkeypatch, wl, kind, fault):
    monkeypatch.setattr(kind, "engine", _faulty(kind.engine, fault))
    assert _run(root, wl)["correct"] is False


def test_import_guard_and_reference_imports(root):
    """After a run, no module named jax, jaxlib, flax or dg_sct_tpu (whole
    top-level names) is loaded; the reference imports nothing of the port."""
    code = ("import sys, json; from portbench import bench; "
            "r = bench.run('ave-stream-b16', 7, 0.5, False, device='cpu', root=sys.argv[1], "
            "log=lambda s: None); "
            "print(json.dumps([bench.forbidden_modules(), r['correct'], "
            "sorted(m for m in sys.modules if m.split('.')[0] == 'dg_sct_tpu_torch')[:1]]))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], cwd=REPO, capture_output=True,
                         text=True, timeout=600, check=True)
    forbidden, correct, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert forbidden == [] and correct and port == ["dg_sct_tpu_torch"]
    for path in (REPO / "portbench").rglob("*.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops.add(node.module.split(".")[0])
        assert not tops & bench.FORBIDDEN, (path, tops & bench.FORBIDDEN)
        if "reference" in path.parts:
            assert "dg_sct_tpu_torch" not in tops, path


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing."""
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_added_as_files(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as new files and entries, no existing file edited, run end to end."""
    root = tiny_checkout(tmp_path)
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "ave.json").read_text())
    conf["model"]["num_frames"] = 3
    (pb / "configs" / "ave3.json").write_text(json.dumps(conf))
    mix = {"loop": "stream", "batch": 2, "chunk": 3, "prefetch": 1, "workers": 2, "pool": 6,
           "wave_std": 0.3, "warmup": 1, "profile": 1}
    (pb / "traffic" / "stream-b2.json").write_text(json.dumps(mix))
    (pb / "metrics" / "clips_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx['clips'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ave3", "source": "https://arxiv.org/abs/2311.05152",
                            "file": "portbench/configs/ave3.json", "reduced": ["num_frames"],
                            "why": "a dummy"})
    spec["workloads"].append({"name": "ave3-stream-b2", "config": "ave3",
                              "traffic": "stream-b2", "chips": 1, "why": "a dummy"})
    for m in spec["end_to_end"]:
        if m["name"] in ("clips_per_s", "setup_s") and "workloads" in m:
            m["workloads"].append("ave3-stream-b2")
    spec["per_layer"].append({"name": "clips_in_window", "unit": "clips", "better": "higher",
                              "source": "host_clock", "layer": "engine", "moves": "clips_per_s",
                              "workloads": ["ave3-stream-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json; from portbench import bench; "
            "print(json.dumps([bench.run('ave3-stream-b2', 3, 0.5, t, device='cpu', root='.', "
            "log=lambda s: None) for t in (False, True)]))")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and set(plain["metrics"]) == {"clips_per_s", "setup_s"}
    assert traced["metrics"]["clips_in_window"]["value"] == traced["attempted"] > 0
