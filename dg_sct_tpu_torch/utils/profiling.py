"""Tracing and profiling: `span` (named ranges at the serving and model
boundaries), `tracing` (turns them on), `spans` (what they recorded),
`trace` (torch.profiler, a Chrome trace) and `flops_estimate` (PyTorch's
FLOP counter over the plain path on the "meta" device).

Spans. The port opens a span at each serving and model boundary:

    with span("dgsct.serve.forward", DEVICE):
        ...

While tracing is off, which is the default, `span` is a flag test that
returns one shared null context. While it is on (`with tracing():`, and
inside `trace()`):
- on a thread that a torch.profiler session records (the profiler is
  thread-local: the thread that started it), every span is a
  `record_function` range, in the trace and on the clock of the device
  events, so a gap on the device timeline falls under the innermost range;
- elsewhere a span opened with `HOST` records its host `perf_counter_ns`
  at entry and exit, and one opened with `DEVICE` also a pair of timing
  CUDA events on the stream it runs on (`stream`, else the current one);
  a span opened with neither records nothing.
The events come from a pool filled when tracing starts, so a span creates
none. `spans()` returns the records: the events are read there, after the
fact, never inside a span, and placed on the host clock through anchors
that `tracing()` takes at its start and end (a synchronize, an event and a
clock read): device time = host time of the start anchor + the events'
elapsed time, scaled linearly between the two anchors where the clocks
drift apart by more than 0.1 ms over the session.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from .tree import tree_map

HOST, DEVICE = 1, 2      # what a span records when no profiler runs
MAX_RECORDS = 1 << 16    # the bound of the record buffer; later records are dropped
DRIFT_NS = 100_000       # clock drift over a session beyond which device times are scaled
POOL = 4096              # timing events made at a session's start, so a span makes none


class Span(NamedTuple):
    """A recorded span: perf_counter_ns times on the host, its device
    interval on the same clock (None without CUDA events)."""
    name: str
    thread: str
    host_start: int
    host_end: int
    device_start: Optional[int]
    device_end: Optional[int]


class _Session:
    """One `tracing()` session: its clock anchors, each (host ns, event)."""

    def __init__(self):
        self.start = _anchor()
        self.end = None


_NULL = contextlib.nullcontext()
_on = False
_depth = 0
_session: Optional[_Session] = None
_lock = threading.Lock()
_records: list = []      # (name, thread, t0, t1, session, start event, end event)
_dropped = 0
_pool: list = []         # timing events free for a span (created, recorded once)


def _event():
    """A timing event from the pool, else a new one (list.pop is atomic)."""
    try:
        return _pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _fill_pool():
    """Top the pool up to POOL events; a CUDA event is created at its first
    record, so each is recorded once here, outside any span."""
    while len(_pool) < POOL:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        _pool.append(ev)


def _anchor():
    """(host ns, event) of a drained card, the host time taken as the middle
    of the event's record and its completion; None without CUDA."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter_ns()
    ev.record()
    ev.synchronize()
    return (t0 + time.perf_counter_ns()) // 2, ev


class _Span:
    __slots__ = ("name", "record", "stream", "range", "t0", "ev0")

    def __init__(self, name, record, stream):
        self.name, self.record, self.stream = name, record, stream

    def __enter__(self):
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            return self
        self.ev0 = None
        if self.record:
            self.t0 = time.perf_counter_ns()
            if self.record == DEVICE and _session is not None and _session.start is not None:
                self.ev0 = _event()
                self.ev0.record(self.stream)
        return self

    def __exit__(self, *exc):
        global _dropped
        if self.range is not None:
            self.range.__exit__(*exc)
            return False
        if not self.record:
            return False
        ev1 = None
        if self.ev0 is not None:
            ev1 = _event()
            ev1.record(self.stream)
        t1 = time.perf_counter_ns()
        rec = (self.name, threading.current_thread().name, self.t0, t1, _session, self.ev0, ev1)
        with _lock:
            if len(_records) < MAX_RECORDS:
                _records.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, record: int = 0, stream=None):
    """A named range (the prefix "dgsct."): a shared null context while
    tracing is off; else a profiler range under torch.profiler, and without
    one a record of what `record` (0, HOST or DEVICE) asks for, its CUDA
    events on `stream` (None: the current stream)."""
    if not _on:
        return _NULL
    return _Span(name, record, stream)


@contextlib.contextmanager
def tracing():
    """Spans on over the block (nested blocks share the outermost one's
    session). The session's anchors are taken at the outermost entry and
    exit; CUDA events are recorded only where the card was in use at entry."""
    global _on, _depth, _session
    _depth += 1
    if _depth == 1:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            _fill_pool()
        _session = _Session()
        _on = True
    try:
        yield
    finally:
        _depth -= 1
        if _depth == 0:
            _on = False
            _session.end = _anchor()


def _device_ns(session, end, ev):
    """`ev` on the host clock, by the session's start anchor and `end`."""
    h0, e0 = session.start
    ms = e0.elapsed_time(ev)
    if end is not None:
        h1, e1 = end
        span_ms = e0.elapsed_time(e1)
        if span_ms > 0 and abs((h1 - h0) - span_ms * 1e6) > DRIFT_NS:
            return h0 + round(ms * (h1 - h0) / span_ms)
    return h0 + round(ms * 1e6)


def spans() -> List[Span]:
    """The records kept since the last `reset_spans`, in host start order.
    Their CUDA events are waited for here; a session still open is given a
    provisional end anchor for its drift."""
    with _lock:
        recs = list(_records)
    ends = {}
    out = []
    for name, thread, t0, t1, session, ev0, ev1 in recs:
        d0 = d1 = None
        if ev0 is not None:
            if id(session) not in ends:
                ends[id(session)] = session.end if session.end is not None else _anchor()
            ev1.synchronize()
            end = ends[id(session)]
            d0, d1 = _device_ns(session, end, ev0), _device_ns(session, end, ev1)
        out.append(Span(name, thread, t0, t1, d0, d1))
    return sorted(out, key=lambda s: s.host_start)


def dropped_spans() -> int:
    """Records dropped since the last `reset_spans` because the buffer held
    MAX_RECORDS."""
    return _dropped


def clock_drift_ns() -> Optional[int]:
    """Host time minus device time between the last closed session's two
    anchors (ns); None without one on the card."""
    s = _session
    if s is None or s.start is None or s.end is None:
        return None
    return (s.end[0] - s.start[0]) - round(s.start[1].elapsed_time(s.end[1]) * 1e6)


def reset_spans() -> None:
    """Drop the records; their events go back to the pool."""
    global _dropped
    with _lock:
        _pool.extend(ev for r in _records for ev in r[5:] if ev is not None)
        _records.clear()
        _dropped = 0


def _meta(t):
    return t.to("meta") if torch.is_tensor(t) else t


def flops_estimate(fn, *args, **kwargs) -> Dict[str, float]:
    """`fn(*args, **kwargs)` with every tensor argument moved to the "meta"
    device (shapes only, nothing computed), under
    `torch.utils.flop_counter.FlopCounterMode` -> {"flops": total, and one
    entry an operator}. The count is PyTorch's: matrix products,
    convolutions and attention, 2 a multiply-add; elementwise work is not
    counted, and it is not XLA's cost analysis. `fn` must run the plain
    path (kernels=False): the port's CUDA kernels launch through ctypes, out
    of the dispatcher's sight, so their work would count as zero."""
    from torch.utils.flop_counter import FlopCounterMode

    args, kwargs = tree_map(_meta, list(args)), tree_map(_meta, kwargs)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args, **kwargs)
    out = {"flops": float(counter.get_total_flops())}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        out[str(op)] = float(n)
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, CPU and (when present) CUDA activity,
    with tracing on, so the port's spans are ranges in it; on exit the
    Chrome trace goes to `<log_dir>/trace.json`. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing(), torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
