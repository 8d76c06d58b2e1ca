"""The metric arithmetic on synthetic inputs."""
import math

import numpy as np
import pytest

from portbench import bench, roofline
from portbench.reference import config as ref_config
from portbench.trace import merge, summarize

from .tiny import REPO, TINY_AVE


def test_idle_share_from_overlapping_intervals():
    dev = [("kernel_a", 0.0, 10.0), ("kernel_b", 5.0, 15.0),      # overlap: busy 0-15
           ("Memcpy HtoD (Pinned -> Device)", 20.0, 30.0),        # gap 15-20
           ("block_attn_v2", 60.0, 100.0)]                         # gap 30-60
    host = [("aten::copy_", 14.0, 25.0), ("portbench.forward_batch", 0.0, 100.0)]
    s = summarize(dev, host)
    assert merge([(0, 10), (5, 15), (20, 30)]) == [[0, 15], [20, 30]]
    assert s["busy_s"] == pytest.approx(65e-6) and s["window_s"] == pytest.approx(100e-6)
    assert s["h2d_s"] == pytest.approx(10e-6)
    assert s["groups"]["K2"] == pytest.approx(40e-6)
    assert s["groups"]["other"] == pytest.approx(20e-6)
    # the longest gap first, named by the innermost host op over its middle
    assert s["gaps"][0] == ("portbench.forward_batch", pytest.approx(30e-6))
    assert s["gaps"][1] == ("aten::copy_", pytest.approx(5e-6))
    assert summarize([], host) is None
    idle = bench.reader("device_idle_pct")({"trace": s})
    assert idle == pytest.approx(35.0)


def test_compare_shift_and_z_rms():
    """A bias shared by every answer stays in `shift`; errors that differ
    from answer to answer average out of it but not out of z_rms."""
    from portbench.generator import Outputs

    rng = np.random.default_rng(0)
    ref = rng.normal(size=(400, 6))
    noise = rng.normal(scale=0.1, size=ref.shape)
    std = ref.std(0)
    for err, z, shift in [(noise * std, 0.1, 0.005), (0.1 * std * np.ones_like(ref), 0.1, 0.1)]:
        outputs = Outputs()
        outputs.add({"x": ref + err}, range(len(ref)))
        got = bench.compare(outputs, {j: {"x": r} for j, r in enumerate(ref)})
        assert got["x.z_rms"] == pytest.approx(z, rel=0.05)
        assert got["x.shift"] == pytest.approx(shift, abs=0.01)
        assert got["answers.z_rms"] == got["x.z_rms"]


def test_p95_of_all_requests():
    lat = np.arange(1, 201, dtype=float)            # 200 requests, 1..200 ms
    assert np.percentile(lat, 95) == pytest.approx(190.05)


def test_k2_and_k3_against_hand_worked_shapes():
    # Swin stage 0 block at 2 frames: 48x48 tokens, C 192, 6 heads, ws 12, shifted
    m = {"res": (48, 48), "dim": 192, "heads": 6, "ws": 12, "shift": 6}
    T, N, Bw = 2 * 48 * 48, 144, 2 * 16
    flops, nbytes = roofline.k2(2, m, 2)
    assert flops == 8 * T * 192 ** 2 + 4 * Bw * 6 * N * N * 32
    assert nbytes == 2 * (2 * T * 192 + 4 * 192 ** 2 + 6 * 192 + 6 * N * N + 16 * N * N + 6)
    f3, b3 = roofline.k3(720, 1536, 2, 96, 2)
    assert f3 == 720 * 1536 ** 2 // 4
    assert b3 == (2 * 720 * 1536 + 2 * 1536 * 96 + 2 * 96 + 5 * 1536) * 2
    assert roofline.bound_s([(989e12, 0)], "bfloat16") == pytest.approx(1.0)
    assert roofline.bound_s([(0, 3.35e12)], "bfloat16") == pytest.approx(1.0)


@pytest.mark.parametrize("name, k1, k2, k3", [("ave", 2, 34, 48), ("avs", 2, 34, 0)])
def test_call_lists_of_the_configurations(name, k1, k2, k3):
    import json

    conf = json.loads((REPO / f"portbench/configs/{name}.json").read_text())
    cfg = ref_config.load(conf["model"], "tanh")
    calls = roofline.calls(cfg, 16 * cfg.num_frames, "bfloat16")
    assert (len(calls["K1"]), len(calls["K2"]), len(calls["K3"])) == (k1, k2, k3)


def test_roofline_and_mfu_readers():
    trace = {"groups": {"K2": 0.010, "K3": 0.004, "other": 0.05}, "h2d_s": 0.002,
             "busy_s": 0.08, "window_s": 0.1}
    ctx = {"trace": trace, "calls": {"K2": (34, 0.001), "K3": (48, 0.0005)},
           "launches": {"block_attention": 68, "adapter_bottleneck": 96},
           "profiled_clips": 32, "clips": 500, "window_s": 10.0, "flops_per_clip": 1e12,
           "peak_flops": 989e12, "loop": "stream", "spans": [0.1, 0.3],
           "window_peak_bytes": 3 * 2 ** 30}
    assert bench.reader("k2_roofline")(ctx) == pytest.approx(100 * 2 * 0.001 / 0.010)
    assert bench.reader("k3_roofline")(ctx) == pytest.approx(100 * 2 * 0.0005 / 0.004)
    assert bench.reader("step_mfu_pct")(ctx) == pytest.approx(100 * 1e12 * 50 / 989e12)
    assert bench.reader("pointwise_ms_per_clip")(ctx) == pytest.approx(50 / 32)
    assert bench.reader("h2d_ms_per_clip")(ctx) == pytest.approx(2 / 32)
    assert bench.reader("forward_call_ms.stream")(ctx) == pytest.approx(200.0)
    assert bench.reader("forward_call_ms.request")(ctx) is None
    assert bench.reader("peak_mem_gib")(ctx) == pytest.approx(3.0)
    # a kernel off the path reads nothing, never 0
    ctx["launches"] = {"block_attention": 68}
    assert bench.reader("k3_roofline")(ctx) is None
    ctx["trace"] = None
    assert bench.reader("device_idle_pct")(ctx) is None
    assert bench.reader("h2d_ms_per_clip")(ctx) is None


def test_flops_per_clip_counts_the_reference():
    from portbench.models import ave

    cfg = ref_config.load(TINY_AVE, "exact")
    one, two = bench.flops_per_clip(ave, cfg, 1), bench.flops_per_clip(ave, cfg, 2)
    # per clip, all but the per-forward tables (the CPB MLPs) scale with the batch
    assert one > 0 and math.isclose(one, two, rel_tol=0.02)
