"""The reduction of the program's spans (`portbench/spans.py`) on synthetic
events: device work tied to the innermost range by its host call, not by
time; the window's union, bounds and idle by host span; the metrics left out
where their spans are absent. A whole traced run at tiny sizes on the CPU
with the program's tracing on, and on the card the spans' device intervals
against their host spans."""
import pytest

from portbench import spans
from dg_sct_tpu_torch.utils.profiling import Span

from .tiny import tiny_checkout

# (id, thread, name, start, end): two forwards on thread 7
HOST = [(1, 7, "dgsct.serve.forward", 0, 1000),
        (2, 7, "dgsct.serve.wire", 10, 100),
        (3, 7, "aten::to", 20, 90),
        (4, 7, "dgsct.model.towers", 100, 700),
        (5, 7, "aten::mm", 110, 200),
        (6, 7, "dgsct.model.adapter", 300, 400),
        (7, 7, "aten::add", 310, 320),
        (8, 7, "dgsct.model.heads", 700, 950),
        (9, 7, "aten::mul", 710, 720),
        (10, 7, "aten::copy_", 1100, 1200),
        (11, 7, "dgsct.serve.forward", 2000, 3000),
        (12, 7, "aten::mm", 2100, 2200),
        (15, 7, "aten::bmm", 210, 250)]
# (name, correlation, linked host id, start, end): device time runs late,
# so overlap in time would tie most of it to no range or the wrong one
DEV = [("elementwise_kernel", 101, 3, 5000, 5010),      # wire, through aten::to
       ("sm90_gemm", 102, 5, 5010, 5110),                # towers
       ("elementwise_kernel", 103, 7, 5110, 5115),       # adapter: the innermost range wins
       ("bottleneck_kernel_bf16", 104, 0, 5115, 5130),   # ctypes: no link to a host op
       ("elementwise_kernel", 105, 9, 5130, 5140),       # heads
       ("Memcpy DtoH (Device -> Pinned)", 106, 10, 5140, 5150),  # after the forward
       ("Memcpy HtoD (Pinned -> Device)", 107, 0, 4000, 4010),   # the staging thread's copy
       ("sm90_gemm", 108, 12, 6000, 6100),               # the second forward, no function
       ("window_attention_kernel", 109, 0, 5140, 5145)]  # ctypes, between two towers calls
# (start, end, linked host id) of the runtime calls, on a clock ~1000 behind
# the host ops'. K1's call (109) falls between two calls from the towers; K3's
# (104) between one from the adapter and one from the heads, at 350 on the
# host ops' clock: inside the adapter.
RUNTIME = {201: (-885, -880, 5), 109: (-850, -845, 0), 204: (-780, -776, 15),
           202: (-688, -684, 7), 104: (-650, -645, 0), 203: (-288, -284, 9),
           107: (-950, -945, 0)}


def test_attribution_by_launch_to_the_innermost_range():
    got = spans.attribute(HOST, DEV, RUNTIME)
    assert got["forwards"] == 2
    assert got["launches"] == 7  # 101-105, 108 and 109; the copies are outside
    assert got["by_range_s"] == {"dgsct.model.adapter": 20e-9, "dgsct.model.heads": 10e-9,
                                 "dgsct.model.towers": 105e-9, "dgsct.serve.wire": 10e-9,
                                 "dgsct.serve.forward": 100e-9}  # the remainder
    assert got["forward_s"] == pytest.approx(245e-9)
    assert got["groups_in_forward"] == {"other": 3, "library GEMM": 2, "K3": 1, "K1": 1}
    assert got["ours_in_forward"] == {"K3": {"bottleneck_kernel_bf16": 1},
                                      "K1": {"window_attention_kernel": 1}}
    assert got["clock_offset_ns"] == (1001, 1.0)  # every pair allows 998-1004
    assert got["by_launch_order"] == 1 and got["by_launch_time"] == 1
    assert got["unlinked"] == 1  # a copy is never tied through its runtime call
    assert got["ranges"]["dgsct.model.adapter"] == 1
    m = spans.metrics("stream", 2, None, got)
    assert m == {"launches_per_forward": 3.5, "wire_ms_per_clip": pytest.approx(2.5e-6),
                 "towers_ms_per_clip": pytest.approx(26.25e-6),
                 "adapters_ms_per_clip": pytest.approx(5e-6),
                 "heads_ms_per_clip": pytest.approx(2.5e-6)}
    assert spans.metrics("request", 8, None, got) == {"launches_per_forward.request": 3.5}


def test_gaps_named_by_the_innermost_range():
    got = spans.named_gaps(HOST, DEV, n=3)
    # device work 4000-4010, 5000-5150, 6000-6100: no range is open at the
    # gaps' middles, 4505 and 5575
    assert got == [("none", 990e-6), ("none", 850e-6)]
    host = HOST + [(13, 7, "dgsct.serve.forward", 4000, 7000),
                   (14, 7, "dgsct.model.adapter", 5500, 5600)]
    assert spans.named_gaps(host, DEV, n=2) == [("dgsct.serve.forward", 990e-6),
                                                ("dgsct.model.adapter", 850e-6)]


def test_a_launch_outside_every_forward_is_not_counted():
    host = [(1, 7, "dgsct.serve.to_host", 0, 100), (2, 7, "aten::copy_", 10, 20)]
    dev = [("Memcpy DtoH", 5, 2, 200, 210)]
    got = spans.attribute(host, dev)
    assert got["launches"] == 0 and got["forwards"] == 0
    assert got["by_range_s"] == {"dgsct.serve.to_host": 10e-9}
    assert spans.metrics("stream", 16, None, got) == {}


def _rec(name, h0, h1, d0=None, d1=None, thread="MainThread"):
    return Span(name, thread, h0, h1, d0, d1)


def test_window_union_bounds_idle_by_host_span_and_lag():
    recs = [_rec("dgsct.serve.forward", 50, 150, 100, 200),
            _rec("dgsct.serve.to_host", 150, 160, 200, 210),
            _rec("dgsct.serve.forward", 160, 260, 250, 400),
            _rec("dgsct.serve.stage", 220, 240, 220, 241, thread="producer"),
            _rec("dgsct.serve.wait", 270, 300),
            _rec("dgsct.serve.forward", -50, -10, 0, 90)]    # before the window
    got = spans.window(recs, 0, 1000)
    assert got["device_span_s"] == pytest.approx(300e-9)
    assert got["window_idle_pct"] == pytest.approx(100.0 * 40 / 300)
    assert got["idle_by_host_span_ms"] == {"forward": pytest.approx(20e-6),
                                           "forward+stage": pytest.approx(20e-6)}
    assert got["lag_ms_median"] == pytest.approx(95e-6) and got["forwards"] == 2
    assert spans.window(recs[4:5], 0, 1000) is None          # no device interval
    assert spans.metrics("stream", 16, got, None) == {"window_idle_pct": got["window_idle_pct"]}
    assert spans.metrics("request", 8, got, None) == {}


def test_traced_run_with_tracing_on(tmp_path):
    """On the CPU no profiler runs and no span has device times: the run is
    correct, its spans are host records, and no metric is made up."""
    root = tiny_checkout(tmp_path)
    r = spans.run("ave-stream-b16", 2 ** 31 + 5, 0.5, device="cpu", root=root,
                  log=lambda s: None)
    assert r["correct"]
    assert r["spans"]["metrics"] == {}
    read = r["spans"]["readings"]
    assert read["records"] > 0 and read["window"] is None and read["profile"] is None


@pytest.mark.chip
def test_device_intervals_follow_their_host_spans(card):
    """A tiny AVE engine streamed on the card with tracing on: every span with
    CUDA events (staging on the side stream, forwards, copies out) starts on
    the card no earlier than on the host, 0.1 ms allowed for the anchoring,
    and ends after it starts; the forwards queue behind each other."""
    import numpy as np
    import torch

    from dg_sct_tpu_torch.configs import AVEModelConfig
    from dg_sct_tpu_torch.models.ave import init_ave_model
    from dg_sct_tpu_torch.serve import AVEInferenceEngine
    from dg_sct_tpu_torch.utils import profiling
    from portbench.models.common import dataclass_from

    from .tiny import TINY_AVE

    cfg = dataclass_from(AVEModelConfig, TINY_AVE)
    params, state = init_ave_model(cfg, device=card)
    eng = AVEInferenceEngine(cfg, params, state, batch_size=4, chunk=2, device=card,
                             compute_dtype=torch.float32, num_workers=2, kernels=False)
    rs = np.random.RandomState(0)
    n, T, L, S = 32, cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    items = [{"wave": (rs.randn(T, L) * 3000).astype(np.int16),
              "image": rs.randint(0, 256, (T, S, S, 3), dtype=np.uint8)} for _ in range(n)]
    eng.predict_clips(items)  # warm
    profiling.reset_spans()
    with profiling.tracing():
        eng.predict_clips(items)
    recs = profiling.spans()
    timed = [r for r in recs if r.device_start is not None]
    names = {r.name for r in timed}
    assert names == {"dgsct.serve.stage", "dgsct.serve.forward", "dgsct.serve.to_host"}
    assert sum(r.name == "dgsct.serve.forward" for r in timed) == n // 4
    for r in timed:
        assert r.device_start >= r.host_start - 100_000, r
        assert r.device_end >= r.device_start, r
    fwd = [r for r in timed if r.name == "dgsct.serve.forward"]
    assert all(b.device_start >= a.device_end - 100_000 for a, b in zip(fwd, fwd[1:]))
    assert profiling.clock_drift_ns() is not None
    profiling.reset_spans()
