"""The one traffic generator and its two loops.

A traffic mix is a data file, `portbench/traffic/<name>.json`:

    loop       "stream" (a dataset streamed through the engine's chunked
               pipeline) or "request" (requests due at a fixed rate, one at a time)
    batch      clips a forward; chunk, prefetch, workers: the stream's knobs
    clips_per_request  (request loop) clips a request
    rate       (request loop) requests a second, due at fixed intervals
    pool       distinct clips made from the seed; the loop cycles through
               them in an order drawn from the seed
    wave_std   the waves' level as a share of full scale (int16 PCM)
    warmup     blocks or requests served before the window opens
    profile    blocks or requests served under the profiler after it closes
               (traced runs)

Every seed gets the same sizes and the same amount of work; the seed
changes the clips' contents and their order only.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def make_pool(n, shapes, seed, wave_std, device):
    """n clips from `seed`: {"wave": int16 (n, T, L), "image": uint8 (n, T,
    S, S, 3)} numpy in host memory, drawn on `device` in two calls."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    wave = torch.randn((n,) + shapes["wave"], generator=gen, device=device)
    wave = (wave * (wave_std * 32767.0)).clamp_(-32767, 32767).to(torch.int16)
    image = torch.randint(0, 256, (n,) + shapes["image"], generator=gen, device=device,
                          dtype=torch.uint8)
    return {"wave": wave.cpu().numpy(), "image": image.cpu().numpy()}


def order(n_pool, length, seed):
    """`length` pool indices: permutations of the pool drawn from `seed`,
    one after another."""
    rng = np.random.default_rng(seed)
    reps = -(-length // n_pool)
    return np.concatenate([rng.permutation(n_pool) for _ in range(reps)])[:length]


class PoolDataset:
    """A map-style dataset over the pool in a drawn order; each item names
    its pool clip in "video"."""

    def __init__(self, pool, idx):
        self.pool, self.idx = pool, idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        j = int(self.idx[i])
        return {"wave": self.pool["wave"][j], "image": self.pool["image"][j],
                "category": "pool", "video": str(j)}


class Outputs:
    """The answers of a window, by pool clip: each distinct output of a
    clip is kept once (a clip served again gives, as a rule, the same
    bits)."""

    def __init__(self):
        self.by_clip = {}

    def add(self, outs, clips):
        """outs {name: (n, ...) numpy}, clips the n pool indices."""
        for r, j in enumerate(clips):
            row = {k: np.ascontiguousarray(v[r]) for k, v in outs.items()}
            kept = self.by_clip.setdefault(int(j), [])
            if not any(all(np.array_equal(row[k], o[k]) for k in row) for o in kept):
                kept.append(row)


def fifths(marks, window):
    """clips/s in each fifth of the window, from the blocks that ended in it:
    marks [(s since the start, clips so far)] at each block's end."""
    out, prev = [], (0.0, 0)
    for k in range(1, 6):
        last = next((m for m in reversed(marks) if m[0] <= k * window / 5 + 1e-9), prev)
        out.append(round((last[1] - prev[1]) / (last[0] - prev[0]), 3)
                   if last[0] > prev[0] else None)
        prev = last
    return out


def stream(kind, eng, pool, mix, seed, seconds, *, profile=None):
    """Stream the pool through the engine until `seconds` have passed since
    the end of the warm-up. -> {"outputs", "clips" in the window, "window_s",
    "t0" (the window's start, perf_counter), "fifths" (clips/s in each fifth
    of it), "profile" (its result or None)}. The window closes at the first
    block that comes back after `seconds`, so it holds whole blocks; with
    `profile`, `profile(next_blocks)` is called after it with a function
    that serves the next `mix["profile"]` blocks."""
    per_block = mix["batch"] * mix["chunk"]
    blocks = mix["warmup"] + mix["profile"] + int(seconds * 1000.0 / per_block) + 64
    ds = PoolDataset(pool, order(mix["pool"], blocks * per_block, seed))
    it = kind.stream(eng, ds)
    outputs = Outputs()
    for _ in range(mix["warmup"]):
        next(it)
    t0 = time.perf_counter()
    clips, marks = 0, []
    while True:
        outs, idx = next(it)
        outputs.add(outs, idx)
        clips += len(idx)
        now = time.perf_counter()
        marks.append((now - t0, clips))
        if now - t0 >= seconds:
            break

    def next_blocks():
        for _ in range(mix["profile"]):
            outs, idx = next(it)
            outputs.add(outs, idx)

    extra = profile(next_blocks) if profile else None
    it.close()
    return {"outputs": outputs, "clips": clips, "window_s": now - t0, "t0": t0,
            "fifths": fifths(marks, now - t0), "profile": extra}


def requests(kind, eng, pool, mix, seed, seconds, *, profile=None):
    """Requests of `clips_per_request` consecutive pool clips (views of
    pageable host memory), in an order drawn from `seed`, due at `rate` a
    second from the window's start and each answered before the next starts
    (an open loop: a request that waits for the one before counts the
    wait). Requests due in the first `seconds` form the window; the last is
    waited for. -> {"outputs", "clips", "window_s", "t0", "profile" as
    `stream` gives them, "latencies" and "lateness" (s, a request each), and
    "fifths": the median and the largest latency (ms) of the requests due
    in each fifth of the window}."""
    k = mix["clips_per_request"]
    gap = 1.0 / mix["rate"]
    n = mix["warmup"] + mix["profile"] + int(seconds * mix["rate"]) + 64
    seq = iter(order(mix["pool"] // k, n, seed))
    outputs = Outputs()

    def one(due):
        now = time.perf_counter()
        if due > now:
            time.sleep(due - now)
        start = time.perf_counter()
        r = int(next(seq))
        outs = kind.request(eng, pool["wave"][r * k:(r + 1) * k], pool["image"][r * k:(r + 1) * k])
        end = time.perf_counter()
        outputs.add(outs, range(r * k, (r + 1) * k))
        return end - due, start - due

    for _ in range(mix["warmup"]):
        one(time.perf_counter())
    t0 = time.perf_counter()
    lat, late = [], []
    while True:
        due = t0 + len(lat) * gap
        if due - t0 >= seconds:
            break
        latency, lateness = one(due)
        lat.append(latency)
        late.append(lateness)
    window = time.perf_counter() - t0

    def next_blocks():
        for _ in range(mix["profile"]):
            one(time.perf_counter())

    extra = profile(next_blocks) if profile else None
    ms = 1e3 * np.asarray(lat)
    parts = [p for p in np.array_split(ms, 5) if p.size]
    return {"outputs": outputs, "clips": len(lat) * k, "window_s": window, "t0": t0,
            "fifths": [[round(float(np.median(p)), 3), round(float(p.max()), 3)] for p in parts],
            "profile": extra, "latencies": lat, "lateness": late}
