"""The port's spans (dg_sct_tpu_torch.utils.profiling): off, one shared null
context and no record; on, host records that nest, carry their thread and
time a sleep, kept under a lock from many threads; inside `trace()`, ranges
named "dgsct." in the Chrome trace; and in the engines, the census of ranges
a forward (forward, wire, towers and heads once, an adapter range per
adapter call) with outputs bit-identical to tracing off, and a training
step under remat whose gradients are bit-identical with tracing on."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dg_sct_tpu_torch.configs import ave_adapter_dims
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.models import avs as PAvs
from dg_sct_tpu_torch.serve import AVEInferenceEngine, AVSInferenceEngine
from dg_sct_tpu_torch.utils import profiling as PR
from dg_sct_tpu_torch.utils.tree import tree_map, tree_paths
from dg_sct_tpu_torch.weights import from_jax
from test_ave_model import tiny_cfg
from test_torch_avs import port_avs_cfg, scramble_avs, tiny_avs_variant_cfg
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_records():
    PR.reset_spans()
    yield
    PR.reset_spans()


def test_off_is_one_null_context_and_records_nothing():
    a = PR.span("dgsct.serve.forward", PR.DEVICE)
    b = PR.span("dgsct.model.towers")
    assert a is b
    with a, PR.span("dgsct.serve.wait", PR.HOST):
        time.sleep(0.001)
    assert PR.spans() == [] and PR.dropped_spans() == 0


def test_on_records_nested_host_spans_and_reset():
    with PR.tracing():
        with PR.span("dgsct.serve.forward", PR.HOST):
            with PR.span("dgsct.model.towers"):          # records nothing without a profiler
                pass
            with PR.span("dgsct.serve.wait", PR.HOST):
                time.sleep(0.02)
    got = PR.spans()
    assert [s.name for s in got] == ["dgsct.serve.forward", "dgsct.serve.wait"]
    fwd, wait = got
    assert fwd.host_start <= wait.host_start <= wait.host_end <= fwd.host_end
    assert 20e6 <= wait.host_end - wait.host_start < 2e9
    assert fwd.device_start is None and fwd.device_end is None  # no card
    assert fwd.thread == threading.current_thread().name
    PR.reset_spans()
    assert PR.spans() == []


def test_records_carry_their_thread():
    def stage():
        with PR.span("dgsct.serve.stage", PR.HOST):
            time.sleep(0.005)

    with PR.tracing():
        t = threading.Thread(target=stage, name="producer")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with PR.span("dgsct.serve.forward", PR.HOST):
            pass
    threads = {s.name: s.thread for s in PR.spans()}
    assert threads == {"dgsct.serve.stage": "producer",
                       "dgsct.serve.forward": threading.current_thread().name}


def test_many_threads_lose_no_record_and_the_buffer_is_bounded(monkeypatch):
    """More threads than cores, a short switch interval: every record kept
    up to MAX_RECORDS, the rest counted as dropped."""
    n_threads, each = 16, 200
    monkeypatch.setattr(PR, "MAX_RECORDS", n_threads * each - 300)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with PR.span("dgsct.serve.stage", PR.HOST):
                    pass

        with PR.tracing():
            ts = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert len(PR.spans()) == n_threads * each - 300 and PR.dropped_spans() == 300


def test_trace_puts_the_ranges_in_the_chrome_trace(tmp_path):
    with PR.trace(str(tmp_path / "tr")):
        with PR.span("dgsct.serve.forward", PR.DEVICE):
            with PR.span("dgsct.model.towers"):
                torch.randn(16, 16) @ torch.randn(16, 16)
    names = {e.get("name") for e in
             json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]}
    assert {"dgsct.serve.forward", "dgsct.model.towers"} <= names
    assert PR.spans() == []  # under the profiler a span is a range, not a record
    assert PR.span("dgsct.serve.forward") is PR.span("dgsct.serve.wait")  # off again


def _census(fn):
    """fn() under torch.profiler with tracing on -> (its result, {range name:
    count})."""
    with PR.tracing(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    count = {}
    for e in prof.events():
        if e.name.startswith("dgsct."):
            count[e.name] = count.get(e.name, 0) + 1
    return out, count


def _inputs(cfg, B, img, seed=0):
    rs = np.random.RandomState(seed)
    T, L = cfg.num_frames, cfg.htsat.frontend.clip_samples
    wave = (rs.randn(B, T, L) * 3000).astype(np.int16)
    frames = rs.randint(0, 256, (B, T, img, img, 3), dtype=np.uint8)
    return wave, frames


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def ave_model():
    pcfg = port_cfg(tiny_cfg())
    jp, js = scramble_adapters(*(to_numpy(t) for t in PA.init_ave_model(pcfg, device="cpu")))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    return pcfg, pp, ps


def test_ave_engine_census_and_bit_identical_outputs(ave_model):
    pcfg, pp, ps = ave_model
    eng = AVEInferenceEngine(pcfg, pp, ps, batch_size=2, chunk=1, device="cpu",
                             compute_dtype=torch.float32, num_workers=1, kernels=False)
    wave, frames = _inputs(pcfg, 2, pcfg.swin.img_size)
    off = eng.forward_batch(wave, frames)
    on, count = _census(lambda: eng.forward_batch(wave, frames))
    _same(off, on)
    n_adapters = 4 * len(ave_adapter_dims(pcfg.swin, pcfg.htsat))
    assert count == {"dgsct.serve.forward": 1, "dgsct.serve.wire": 1, "dgsct.model.towers": 1,
                     "dgsct.model.heads": 1, "dgsct.model.adapter": n_adapters}
    # a request: the reads of its answers are a wait range
    _, count = _census(lambda: eng.predict(wave[:1], frames[:1]))
    assert count["dgsct.serve.wait"] == 1 and count["dgsct.serve.forward"] == 1


def test_ave_stream_records_its_engine_spans(ave_model):
    """Streamed on the CPU with tracing on and no profiler: a forward record
    a batch (the CPU stream has no staging, copy-out or wait), host times
    only; the answers those of tracing off."""
    pcfg, pp, ps = ave_model
    eng = AVEInferenceEngine(pcfg, pp, ps, batch_size=2, chunk=1, device="cpu",
                             compute_dtype=torch.float32, num_workers=1, kernels=False)
    wave, frames = _inputs(pcfg, 3, pcfg.swin.img_size, seed=1)

    class Clips:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return {"wave": wave[i], "image": frames[i], "label": np.zeros(1)}

    off = eng.predict_clips(Clips())
    with PR.tracing():
        on = eng.predict_clips(Clips())
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert [s.name for s in PR.spans()] == ["dgsct.serve.forward"] * 2
    assert all(s.device_start is None for s in PR.spans())


def test_avs_engine_census_and_bit_identical_outputs():
    pcfg = port_avs_cfg(tiny_avs_variant_cfg())
    jp, js = scramble_avs(*(to_numpy(t) for t in PAvs.init_avs_model(pcfg, device="cpu")))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    eng = AVSInferenceEngine(pcfg, pp, ps, batch_size=1, chunk=1, device="cpu",
                             compute_dtype=torch.float32, num_workers=1, kernels=False,
                             mask_u8=False)
    wave, frames = _inputs(pcfg, 1, pcfg.mask_size, seed=2)
    off = eng.forward_batch(wave, frames)
    on, count = _census(lambda: eng.forward_batch(wave, frames))
    assert torch.equal(off, on)
    n_adapters = 4 * len(ave_adapter_dims(pcfg.swin, pcfg.htsat))
    assert count == {"dgsct.serve.forward": 1, "dgsct.serve.wire": 1, "dgsct.model.towers": 1,
                     "dgsct.model.heads": 1, "dgsct.model.adapter": n_adapters}


def test_training_step_under_remat_is_unchanged_by_tracing(ave_model):
    """The adapters' gradients of a training step whose paired blocks are
    recomputed in the backward pass, with the spans as profiler ranges inside
    the checkpointed blocks, bit-identical to tracing off. Remat "dots", whose
    selective checkpoint sees every operator, the profiler's ranges too."""
    pcfg, pp, ps = ave_model
    params = dict(pp)
    params["adapters"] = tree_map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()), pp["adapters"])
    leaves = [t for _, t in tree_paths(params["adapters"]) if t.requires_grad]
    wave, frames = _inputs(pcfg, 1, pcfg.swin.img_size, seed=3)
    wave = torch.from_numpy(wave.astype(np.float32) / 32767.0)
    frames = torch.from_numpy(frames.astype(np.float32) / 255.0)

    def step():
        out, _ = PA.forward(params, ps, wave, frames, pcfg, train=True, kernels=False,
                            device="cpu", remat_policy="dots")
        loss = out["event_scores"].square().sum() + out["is_event_scores"].sum()
        return torch.autograd.grad(loss, leaves)

    off = step()
    on, count = _census(step)
    assert count["dgsct.model.adapter"] >= 4 * len(ave_adapter_dims(pcfg.swin, pcfg.htsat))
    assert all(torch.equal(a, b) for a, b in zip(off, on))
