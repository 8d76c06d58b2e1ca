"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file."""
import dataclasses
import json
import re

import pytest

from portbench import bench
from portbench.bench import cell, load_spec, metrics_of

from .tiny import REPO

SPEC = load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in names
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
    assert "setup_s" in names


@pytest.mark.parametrize("wl", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads_by_name(wl):
    """Each cell's configuration, mix and metric readers are found by name;
    it reports setup_s, another end-to-end metric, a per-layer metric, and
    every per-layer metric it lists moves an end-to-end metric it reports."""
    w, config, mix = cell(SPEC, wl)
    e2e = {m["name"] for m in metrics_of(SPEC, w, "end_to_end")}
    per_layer = metrics_of(SPEC, w, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        assert callable(bench.reader(m["name"]))
    assert mix["loop"] in ("stream", "request")
    assert config["kind"] in ("ave", "avs")
    assert all(config["check"][k] > 0 for k in config["check"])


@pytest.mark.parametrize("name", ["ave", "avs"])
def test_configuration_is_the_release(name):
    """Nothing is cut: each configuration file's "model" is every field of
    the port's default config (all but the dtype fields)."""
    from dg_sct_tpu_torch import configs

    from portbench.models.common import dataclass_from

    cls = {"ave": configs.AVEModelConfig, "avs": configs.AVSModelConfig}[name]
    model = json.loads((REPO / f"portbench/configs/{name}.json").read_text())["model"]
    assert dataclass_from(cls, model) == cls()

    def fields(dc):
        return {f.name for f in dataclasses.fields(dc)} - {"compute_dtype", "stft_compute"}
    assert set(model) == fields(cls)
    assert set(model["swin"]) == fields(configs.SwinV2Config)
    assert set(model["htsat"]["frontend"]) == fields(configs.AudioFrontendConfig)
