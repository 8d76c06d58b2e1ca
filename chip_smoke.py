#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dg_sct_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); TF32 off for matmul and cuDNN;
  2. build the four CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version at every shape of the
     main path, in float32 and bfloat16, and time kernel, plain version and
     the yardsticks the port never calls: for K1 `scaled_dot_product_attention`
     (library_ms), for K2 and K3 a composition of library calls (composed_ms);
     for K2 in bf16 also the device time of each of its kernels (stages_ms);
     for K4 (the int8 linear, at the 56 (rows, K, N) of one B=2 int8 forward,
     static scales, and dynamic ones checked too) the quantize / `torch._int_mm`
     / dequantize composition (composed_ms) and a bf16 addmm of the same shape
     (matmul_ms). Times as the host issues the calls (ms) and, for kernel and
     yardsticks, the card's time alone (device_ms). The float32 checks of K1
     and K2 run after a launch that leaves NaN in shared memory. K3 also at
     shapes off the main path: ragged row tiles, no LN_before, four groups of
     24 or 48 channels; K1 and K2 also at phase 8's shapes (10 frames a
     forward), checked in both dtypes, not timed;
  4. drive the full-width AVE eval forward (AVEModelConfig(), random weights
     from seed 0, nonzero adapter gates) through AVEInferenceEngine: B=2 clips
     in bf16, 3 predict requests; check outputs, launch counts K1=2, K2=34,
     K3=48 per forward, and one float32 kernel forward against the float32
     plain forward;
  5. serve through `predict_clips`: a DG-SCT state dict synthesized from the
     key census of best_82.18.pt goes through the import path (converter,
     key census, `from_jax`) into a bf16 engine (B=2, chunk=2), which answers
     7 full-width clips in memory in both wire formats (int16 wave with
     uint8 RGB; mu-law wave with YUV420), twice each, and once with chunk=3
     (a padded chunk); checks shapes, finite scores, launch counts of 2/34/48
     per forward and, for uint8 RGB, agreement with `predict` within bf16
     TOL; then, if Pillow imports, the same over a 7-video tree of 320x320
     JPEGs on disk (prints the decoder, native or PIL); then `stream:` lines:
     clips/s of `predict_clips` over 32 clips per wire format beside
     `predict`, host-to-device bytes per forward, and the host-to-device
     copies of a profiled run (time a forward, kind, overlap with kernels);
  6. train the same widths (random weights from seed 0, nonzero adapter
     gates) in bf16 over float32 Adam masters with remat "full": B=8 clips
     (80 frames and 80 audio clips), accum 2, 4 mini-steps on seeded
     synthetic batches with a mixup lambda and a generator, so SpecAugment,
     drop_path and dropout are on; checks a finite loss at each, no change
     after mini-step 1, every trainable leaf changed after mini-step 2 but
     the unused ones, every frozen leaf bit-identical, the BN running state
     of bn0 and the adapters moved, no kernel launched; prints each
     mini-step's time and the peak memory (`train:` lines), a profiled
     mini-step (`train profile:`), two mini-steps of B=8 with remat "none"
     (their times and peak memory), the eval step on the trained weights
     (launches K1/K2/K3 = 2/34/0), and the saved train state loaded into
     the engine, which folds it and answers 2 clips (2/34/48);
  7. serve the same widths in int8 (`int8:` lines): calibrate static
     activation scales on a seeded B=2 batch (towers and adapters), then an
     engine with int8_towers, int8_adapters and those scales answers 3
     requests of B=2 clips in bf16 in turns with a bf16 engine on the same
     weights and requests: clips/s of both, each engine's weight bytes
     and a request's peak memory above what was resident, launches
     K1/K2/K3/K4 = 34/2/48/430 per forward, drift against bf16 (max |delta
     event_scores| over the spread, share of segment_preds that agree), one
     profiled int8 forward (K4 its own group); in float32, the int8 forward
     with kernels against the int8 plain forward (INT8_TOL, per output) and
     each of its 430 K4 calls against the plain version on its own input
     (TOL); then one
     forward each of towers only (K4 = 142), dynamic scales and int8_attn
     (K1 = 10), with launch counts and finite outputs checked;
  8. serve the AVS model at full width (AVSModelConfig(): the same towers,
     48 AVS-variant adapters, TPAVI on 4 stages, the FPN decoder): a state
     dict synthesized from the key census of the AVS S4 checkpoint goes
     through `convert_avs_model` (0 unexplained keys) and `from_jax` into a
     bf16 AVSInferenceEngine (B=2, chunk=2), which streams 7 clips of an
     on-disk AVSBench tree (PNG frames and masks at 224, .npy waves of 5 x
     320000) through `stream_masks`: launches 4 x (K1/K2/K3/K4 = 2/34/0/0),
     masks (7, 5, 224, 224) finite in [0, 1], metas in dataset order; in
     float32 the engine with kernels against the plain one (launches
     2/34/0/0 a forward, each K1 and K2 call against the plain version on
     its own input (TOL); AVS_F32_TOL of the logits' spread, beside the
     plain path's own move under a 1e-6 relative change of its inputs, and
     the bound read against faults PLANTED in front of K2, each of which it
     must catch) and uint8 masks against sigmoid(logits) (0.5/255); clips/s of
     `stream_masks` over 16 in-memory clips in two wire formats (uint8
     frames with int16 waves; S4Dataset's float32 items), two rounds each;
     one profiled forward (cuDNN convolutions and TPAVI's products as their
     own groups) and its peak memory; `calibrate_avs` on a seeded B=2 batch
     and an int8_towers engine (launches 34/2/0/142 a forward, drift against
     bf16); in float32 the int8-towers forward with kernels against the
     int8 plain one (AVS_INT8_TOL on the mean |delta| over the mean |logit|,
     and faults planted in front of K1) and each of its 142 K4 and 34 K1
     calls against the plain version on its own input.
     The bounds of this phase are checked once every reading is printed.
It then prints the kernels line (launches from phase 4, K4's from phase 7),
the card line and, last, the ok line.

    python3 chip_smoke.py --only adapter_bottleneck   # phases 1-3 for K3 alone
    python3 chip_smoke.py --only avs                  # phases 1, 2 and 8

`--only NAME` (repeatable) checks and times only the named kernels and skips
phases 4 to 8 (`--only int8_linear` for K4); `--only avs` runs phase 8 alone.
Such a run prints no ok line.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM dense; f32 without TF32; int8 the tensor cores' int8 x int8 -> int32 rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
PEAK_BYTES = 3.35e12
SPIN_HZ = 2.0e9  # cycles a second for torch.cuda._sleep: above the H100's 1.98 GHz boost
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 2e-2)}  # (atol, rtol)
MODEL_TOL = (2e-3, 2e-3)  # f32 kernel forward vs f32 plain forward (atol, rtol)
BATCH = 2
REQUESTS = 3
PER_FORWARD = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 48,
               "int8_linear": 0}
SOURCES = {
    "window_attention": ("dg_sct_tpu_torch/csrc/window_attention.cu",
                         "dg_sct_tpu/ops/pallas/window_attention.py:73"),
    "block_attention": ("dg_sct_tpu_torch/csrc/block_attention.cu",
                        "dg_sct_tpu/ops/pallas/block_attention.py:113"),
    "adapter_bottleneck": ("dg_sct_tpu_torch/csrc/adapter_bottleneck.cu",
                           "dg_sct_tpu/ops/pallas/adapter_bottleneck.py:66"),
    "int8_linear": ("dg_sct_tpu_torch/csrc/int8_linear.cu",
                    "dg_sct_tpu/ops/quant.py:52 linear_int8 (an XLA int8 dot, no pallas_call)"),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, budget_ms=60.0):
    """Mean time of one call in ms, by CUDA events over a batch of calls, as
    (ms, device_ms, host_ms). ms: the calls as the host issues them, so a
    call whose host side outlasts its kernels reads as the host's time, as
    it does in serving. device_ms: the same batch queued behind a spin kernel
    that holds the stream until the host has issued it, so the events time
    the card alone. host_ms: the host's time to issue one call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(50, max(3, budget_ms / max(start.elapsed_time(end), 1e-3))))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    torch.cuda._sleep(int(min(0.5, 2.0 * host_s + 1e-3) * SPIN_HZ))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms, start.elapsed_time(end) / iters, host_ms


def bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, t_ops * 1e3, t_bytes * 1e3


def stage_ms(fn, reps=5) -> dict:
    """Device time per call of each kernel `fn` launches (torch.profiler),
    by kernel name without its arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("dgsct::(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ")
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def compare(got, ref, dtype):
    atol, rtol = TOL[dtype]
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output is not finite")
    err = (g - r).abs()
    worst = (err / (atol + rtol * r.abs())).max().item()
    return err.max().item(), worst


# ---------------------------------------------------------------------------
# phase 3: the kernels at the main path's shapes
# ---------------------------------------------------------------------------

FLOAT_ATTN = {"qkv": {"kernel": None}, "proj": {"kernel": None}}  # a block of the bf16 path


def attention_cases(cfg, frames):
    """{K1 key: calls a forward}, {K2 key: calls a forward} of the towers'
    blocks at `frames` frames and audio clips a forward; K1 also at the
    shapes it takes in the blocks where K2 runs (0 calls a forward)."""
    from dg_sct_tpu_torch.models import htsat, swinv2
    from dg_sct_tpu_torch.ops.windows import fused_block_eligible

    k1, k2 = {}, {}
    for kind, plan in (("v2", swinv2.block_plan(cfg.swin)), ("v1", htsat.block_plan(cfg.htsat))):
        for stage in plan:
            for m in stage:
                H, W = m["res"]
                N, ws = m["ws"] ** 2, m["ws"]
                nW = (H // ws) * (W // ws)
                on_k2 = fused_block_eligible(m["dim"], m["heads"], False, True, FLOAT_ATTN)
                for masked in (False, True):
                    key = (frames * nW, N, m["heads"], m["dim"] // m["heads"], nW, masked,
                           H, W, ws)
                    k1.setdefault(key, 0)
                    if not on_k2 and masked == (m["shift"] > 0):
                        k1[key] += 1
                if on_k2:
                    key = (kind, frames, H, W, m["dim"], m["heads"], ws, m["shift"])
                    k2[key] = k2.get(key, 0) + 1
    return k1, k2


def kernel_cases(cfg):
    """(kernel, case, launches per forward): every main-path shape, with the
    number of calls one forward makes at it."""
    from dg_sct_tpu_torch.configs import ave_adapter_dims

    frames = BATCH * cfg.num_frames
    k1, k2 = attention_cases(cfg, frames)
    k3 = {}
    for (v_dim, v_tok, a_dim, a_tok) in ave_adapter_dims(cfg.swin, cfg.htsat):
        for C, N in ((v_dim, v_tok), (a_dim, a_tok)):
            key = (frames * N, C, 2, C // 16, True)  # (rows, C, groups, go, has_ln1)
            k3[key] = k3.get(key, 0) + 2
    return ([("window_attention", k, n) for k, n in k1.items()]
            + [("block_attention", k, n) for k, n in k2.items()]
            + [("adapter_bottleneck", k, n) for k, n in k3.items()]
            + [("int8_linear", k, n) for k, n in sorted(int8_call_shapes(cfg).items())])


def avs_attention_cases():
    """(kernel, case, launches per AVS forward) of K1 and K2 at the shapes
    of phase 8's forward (B=2 AVS clips: BATCH * 5 frames); checked in phase
    3, not timed. K1's cases hold the shapes that int8 towers move onto it."""
    from dg_sct_tpu_torch.configs import AVSModelConfig

    cfg = AVSModelConfig()
    k1, k2 = attention_cases(cfg, BATCH * cfg.num_frames)
    return ([("window_attention", k, n) for k, n in k1.items()]
            + [("block_attention", k, n) for k, n in k2.items()])


INT8_TOWERS = ("swin", "htsat", "adapters")  # int8 serving's headline configuration


def int8_call_shapes(cfg, towers=INT8_TOWERS):
    """{(rows, K, N): calls} of the quantized linears one forward of BATCH
    clips makes, from a plain forward on the "meta" device (shapes only)
    whose eligible linears are tagged to record their inputs' shapes."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.ops import quant

    class Shapes(quant.Recorder):
        def record(self, qid, x):
            self.calls.append((qid, tuple(x.shape)))

    params, state = ave.init_ave_model(cfg, device="meta")
    shapes = Shapes()
    tagged = dict(params)
    tagged.update(quant.attach_qtags(quant._ordered_towers(params, towers), recorder=shapes))
    out_dims = quant.qid_shape_map(quant._ordered_towers(params, towers))
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    with torch.inference_mode():
        ave.forward(tagged, state, torch.empty(BATCH, T, L, device="meta"),
                    torch.empty(BATCH, T, S, S, 3, device="meta"), cfg, kernels=False,
                    device="meta")
    out = {}
    for qid, shape in shapes.calls:
        key = (math.prod(shape[:-1]), shape[-1], out_dims[qid][1])
        out[key] = out.get(key, 0) + 1
    return out


def composed_half_block(x, wqkv, bqkv, wproj, bproj, full_bias, ln_s, ln_b, logit_scale, *,
                        kind, heads, ws):
    """K2's function as library calls in x's type: addmm for qkv, SDPA with
    bias and mask as one additive (Bw, heads, N, N) mask, addmm for proj,
    layer_norm, the residual. A yardstick only; the port never calls it."""
    F = torch.nn.functional
    B, Hs, Ws, C = x.shape
    D, N, T = C // heads, ws * ws, B * Hs * Ws
    h = F.layer_norm(x, (C,), ln_s, ln_b, eps=1e-5) if kind == "v1" else x
    qkv = torch.addmm(bqkv, h.reshape(T, C), wqkv)
    qkv = qkv.view(B, Hs // ws, ws, Ws // ws, ws, 3, heads, D).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = qkv.reshape(3, -1, heads, N, D).unbind(0)
    scale = D ** -0.5
    if kind == "v2":
        ls = torch.exp(torch.clamp(logit_scale.float(), max=math.log(100.0))).to(x.dtype)
        q = F.normalize(q, dim=-1) * ls.view(1, heads, 1, 1)
        k, scale = F.normalize(k, dim=-1), 1.0
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=full_bias, scale=scale)
    o = o.view(B, Hs // ws, Ws // ws, heads, ws, ws, D).permute(0, 1, 4, 2, 5, 3, 6).reshape(T, C)
    y = torch.addmm(bproj, o, wproj)
    if kind == "v2":
        y = F.layer_norm(y, (C,), ln_s, ln_b, eps=1e-5)
    return x + y.view(B, Hs, Ws, C)


# K3 off the main path, (rows, C, groups, go, has_ln1): ragged last row tiles
# (one clip: 360 rows at C = 1536), no LN_before, and the four groups of the
# AVS and AVQA adapters (C/g = 24 or 48)
K3_EXTRA = ((360, 1536, 2, 96, True), (360, 1536, 2, 96, False), (40, 768, 2, 48, True),
            (2880, 768, 2, 48, False), (100, 96, 4, 3, True), (77, 192, 4, 6, False))


def composed_bottleneck(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, *, has_ln1):
    """K3's function as library calls in x's type: layer_norm, grouped baddbmm
    for down plus bias, relu, grouped baddbmm for up plus bias, layer_norm. A
    yardstick only; the port never calls it."""
    F = torch.nn.functional
    rows, C = x.shape
    g, gi, go = wd.shape
    z = F.layer_norm(x, (C,), ln1s, ln1b, eps=1e-5) if has_ln1 else x
    z = z.to(x.dtype).view(rows, g, gi).transpose(0, 1)
    h = torch.relu(torch.baddbmm(bd.view(g, 1, go), z, wd)).to(x.dtype)
    o = torch.baddbmm(bu.view(g, 1, gi), h, wu)
    return F.layer_norm(o.transpose(0, 1).reshape(rows, C), (C,), ln2s, ln2b, eps=1e-5)


def int8_inputs(key, dtype, gen):
    """K4's operands at (rows, K, N) on the card: x, the quantized weight (the
    layout `quantize_linear` makes), kscale, a static scale under which a few
    values of x clip, and a bias in x's type."""
    from dg_sct_tpu_torch.ops.quant import quantize_linear

    rows, K, N = key
    x = torch.randn(rows, K, device="cuda", generator=gen).to(dtype)
    q = quantize_linear({"kernel": torch.randn(K, N, device="cuda", generator=gen) * K ** -0.5})
    ascale = x.float().abs().amax() * (0.9 / 127.0)
    bias = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dtype)
    return x, q["kernel_q"], q["kscale"], ascale, bias


def composed_int8_linear(x, wq, kscale, ascale, bias):
    """K4's function as library calls: the quantize in PyTorch, `torch._int_mm`
    (int8 x int8 -> int32), the dequantize and bias in PyTorch. A yardstick
    only; the port never calls it."""
    xq = torch.clamp(torch.round(x.float() / ascale), -127, 127).to(torch.int8)
    return (torch._int_mm(xq, wq).float() * (ascale * kscale) + bias.float()).to(x.dtype)


def check_int8_dynamic(key, dtype, gen):
    """K4 with dynamic per-row scales against its plain version; max abs error."""
    from dg_sct_tpu_torch.ops.kernels import int8_linear as K4

    x, wq, kscale, _, bias = int8_inputs(key, dtype, gen)
    got, ref = K4.int8_linear(x, wq, kscale, None, bias), K4.linear_int8_plain(x, wq, kscale,
                                                                              None, bias)
    torch.cuda.synchronize()
    err, worst = compare(got, ref, dtype)
    if worst > 1.0:
        raise AssertionError(f"int8_linear dynamic {key} {dtype}: max error {err:.3e} exceeds "
                             f"atol/rtol {TOL[dtype]}")
    return err


def window_bias(bias, mask, Bw):
    """bias (H, N, N) plus mask (nW, N, N) or None as one (Bw, H, N, N) tensor."""
    H, N, _ = bias.shape
    full = bias[None].expand(Bw, H, N, N)
    if mask is not None:
        nW = mask.shape[0]
        full = (full.reshape(Bw // nW, nW, H, N, N) + mask[None, :, None]).reshape(Bw, H, N, N)
    return full.contiguous()


def run_case(name, key, dtype, gen):
    """Inputs from `gen` on the card -> (kernel fn, plain fn, library fn or
    None, composed fn or None, flops, bytes)."""
    from dg_sct_tpu_torch.ops.kernels import adapter_bottleneck as K3
    from dg_sct_tpu_torch.ops.kernels import block_attention as K2
    from dg_sct_tpu_torch.ops.kernels import int8_linear as K4
    from dg_sct_tpu_torch.ops.kernels import window_attention as K1
    from dg_sct_tpu_torch.ops.windows import shift_attn_mask

    dev = "cuda"
    rnd = lambda *s, scale=1.0: (torch.randn(s, device=dev, generator=gen) * scale).to(dtype)
    it = torch.tensor([], dtype=dtype).element_size()
    if name == "window_attention":
        Bw, N, H, D, nW, masked, Hs, Ws, ws = key
        q, k, v = rnd(Bw, N, H, D, scale=0.3), rnd(Bw, N, H, D, scale=0.3), rnd(Bw, N, H, D)
        bias = rnd(H, N, N, scale=0.5)
        mask = None
        if masked:
            mask = torch.as_tensor(shift_attn_mask(Hs, Ws, ws, ws // 2), device=dev).to(dtype)
        full = window_bias(bias, mask, Bw)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=full,
                                                                       scale=1.0)
        flops = 4 * Bw * H * N * N * D
        nbytes = it * (4 * Bw * N * H * D + H * N * N + (nW * N * N if masked else 0))
        return (lambda: K1.window_attention(q, k, v, bias, mask, nW=nW),
                lambda: K1.window_attention_plain(q, k, v, bias, mask, nW=nW), lib, None,
                flops, nbytes)
    if name == "block_attention":
        kind, B, Hs, Ws, C, heads, ws, shift = key
        N = ws * ws
        x = rnd(B, Hs, Ws, C)
        wqkv, wproj = rnd(C, 3 * C, scale=C ** -0.5), rnd(C, C, scale=C ** -0.5)
        bqkv, bproj = rnd(3 * C, scale=0.1), rnd(C, scale=0.1)
        if kind == "v2":
            bias = (16.0 * torch.sigmoid(torch.randn(heads, N, N, device=dev, generator=gen))).to(dtype)
            logit_scale = (math.log(10.0) + rnd(heads, scale=0.3).float()).to(dtype)
        else:
            bias, logit_scale = rnd(heads, N, N, scale=0.02), None
        ln_s, ln_b = (1.0 + rnd(C, scale=0.1).float()).to(dtype), rnd(C, scale=0.1)
        mask = None
        if shift:
            mask = torch.as_tensor(shift_attn_mask(Hs, Ws, ws, shift), device=dev).to(dtype)
        args = (x, wqkv, bqkv, wproj, bproj, bias, ln_s, ln_b, mask, logit_scale)
        kw = dict(kind=kind, heads=heads, ws=ws)
        T = B * Hs * Ws
        Bw = T // N
        full = window_bias(bias, mask, Bw)
        composed = lambda: composed_half_block(x, wqkv, bqkv, wproj, bproj, full, ln_s, ln_b,
                                               logit_scale, **kw)
        flops = 2 * T * C * 4 * C + 4 * Bw * heads * N * N * (C // heads)
        nbytes = it * (2 * T * C + 4 * C * C + 6 * C + heads * N * N
                       + (mask.numel() if shift else 0) + heads)
        return (lambda: K2.fused_attn_half_block(*args, **kw),
                lambda: K2.fused_attn_half_block_plain(*args, **kw), None, composed,
                flops, nbytes)
    if name == "int8_linear":
        rows, K, N = key
        args = int8_inputs(key, dtype, gen)
        nbytes = it * rows * K + K * N + 4 * N + 4 + it * N + it * rows * N
        return (lambda: K4.int8_linear(*args), lambda: K4.linear_int8_plain(*args), None,
                lambda: composed_int8_linear(*args), 2 * rows * K * N, nbytes)
    rows, C, g, go, has_ln1 = key
    x = rnd(rows, C)
    wd, wu = rnd(g, C // g, go, scale=(C // g) ** -0.5), rnd(g, go, C // g, scale=go ** -0.5)
    bd, bu = rnd(g * go, scale=0.1), rnd(C, scale=0.1)
    ln = [(1.0 + rnd(C, scale=0.1).float()).to(dtype), rnd(C, scale=0.1)] * 2
    args = (x, wd, bd, wu, bu, *ln)
    flops = 4 * rows * C * go
    nbytes = it * (2 * rows * C + 2 * C * go + g * go + (5 if has_ln1 else 3) * C)
    return (lambda: K3.bottleneck_rows(*args, has_ln1=has_ln1),
            lambda: K3.bottleneck_rows_plain(*args, has_ln1=has_ln1), None,
            lambda: composed_bottleneck(*args, has_ln1=has_ln1), flops, nbytes)


def poison_shared_memory():
    """Leave NaN in the shared memory of every SM: K4 over a float32 x of NaN
    stages raw NaN tiles in its first 48 KB. The float32 checks of K1 and K2
    run right after it, so a read of shared memory that their copies never
    wrote shows as NaN."""
    from dg_sct_tpu_torch.ops.kernels import int8_linear as K4
    from dg_sct_tpu_torch.ops.quant import quantize_linear

    q = quantize_linear({"kernel": torch.ones(256, 128, device="cuda")})
    K4.int8_linear(torch.full((64 * 4 * 132, 256), math.nan, device="cuda"), q["kernel_q"],
                   q["kscale"], torch.ones((), device="cuda"))


def check_case(name, key, dtype, gen):
    """Kernel and plain version on the same inputs, held at TOL; returns the
    case's functions and its max abs error."""
    kern, plain, lib, composed, flops, nbytes = run_case(name, key, dtype, gen)
    if dtype == torch.float32 and name in ("window_attention", "block_attention"):
        poison_shared_memory()
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err, worst = compare(got, ref, dtype)
    if worst > 1.0:
        raise AssertionError(f"{name} {key} {dtype}: max error {err:.3e} exceeds "
                             f"atol/rtol {TOL[dtype]}")
    return kern, plain, lib, composed, flops, nbytes, ref, err


def check_kernels(cfg, only=None):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for name, key, per_fwd in kernel_cases(cfg):
        if only and name not in only:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            kern, plain, lib, composed, flops, nbytes, ref, err = check_case(name, key, dtype, gen)
            b_ms, ops_ms, bytes_ms = bound(flops, nbytes,
                                           torch.int8 if name == "int8_linear" else dtype)
            k_ms, k_dev, k_host = time_ms(kern)
            l_ms, l_dev, _ = time_ms(lib) if lib else (None, None, None)
            c_ms, c_dev, _ = time_ms(composed) if composed else (None, None, None)
            row = dict(name=name, case=list(key), dtype=str(dtype).replace("torch.", ""),
                       per_forward=per_fwd, max_abs_err=err, kernel_ms=k_ms,
                       kernel_device_ms=k_dev, kernel_host_ms=k_host, plain_ms=time_ms(plain)[0],
                       library_ms=l_ms, library_device_ms=l_dev, composed_ms=c_ms,
                       composed_device_ms=c_dev, bound_ms=b_ms, ops_ms=ops_ms, bytes_ms=bytes_ms)
            if composed:  # the yardstick computes the same function (not a check)
                row["composed_err"] = (composed().float() - ref.float()).abs().max().item()
            if name == "block_attention" and dtype == torch.bfloat16:
                row["stages_ms"] = stage_ms(kern)  # where K2's time goes, kernel by kernel
            if name == "int8_linear":
                row["dynamic_err"] = check_int8_dynamic(key, dtype, gen)
                if dtype == torch.bfloat16:  # yardstick: the bf16 matmul + bias int8 replaces
                    m, k, n = key
                    xb = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
                    wb = torch.randn(k, n, device="cuda", generator=gen).to(dtype)
                    bb = torch.zeros(n, device="cuda", dtype=dtype)
                    row["matmul_ms"], row["matmul_device_ms"], _ = time_ms(
                        lambda: torch.addmm(bb, xb, wb))
            rows.append(row)
            print("kernel", json.dumps(row), flush=True)
    # checks only, not timed: K3 off the main path, K1 and K2 at phase 8's shapes
    extra = [("adapter_bottleneck", key, "off the main path") for key in K3_EXTRA]
    extra += [(name, key, f"AVS path, {n} a forward") for name, key, n in avs_attention_cases()]
    for name, key, what in extra:
        if only and name not in only and not ("avs" in only and what.startswith("AVS")):
            continue
        for dtype in (torch.float32, torch.bfloat16):
            err = check_case(name, key, dtype, gen)[-1]
            rows.append(dict(name=name, case=list(key), dtype=str(dtype).replace("torch.", ""),
                             per_forward=0, max_abs_err=err, checked_only=True))
            print(f"check {name} {list(key)} {dtype} ({what}): max abs err {err:.3e} "
                  f"(atol/rtol {TOL[dtype]})", flush=True)
    return rows


def kernels_line(rows, counts):
    """One entry per kernel: the bfloat16 times summed over one forward's
    calls (the main path serves bf16), errors over every case and dtype."""
    out = []
    for name, (source, replaces) in SOURCES.items():
        checked = [r for r in rows if r["name"] == name]  # errors over every check
        mine = [r for r in checked if not r.get("checked_only")]
        if not mine:  # not checked in this run (--only)
            continue
        main = [r for r in mine if r["dtype"] == "bfloat16" and r["per_forward"]]
        tot = lambda k: sum(r["per_forward"] * r[k] for r in main)
        known = lambda k: tot(k) if main and None not in [r[k] for r in main] else None
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name],
            max_abs_err=max(max(r["max_abs_err"], r.get("dynamic_err", 0.0)) for r in checked),
            ms=tot("kernel_ms"), device_ms=tot("kernel_device_ms"), plain_ms=tot("plain_ms"),
            bound_ms=tot("bound_ms"),
            bound_by="operations" if tot("ops_ms") >= tot("bytes_ms") else "bytes",
            library_ms=known("library_ms"), library_device_ms=known("library_device_ms"),
            composed_ms=known("composed_ms"), composed_device_ms=known("composed_device_ms")))
        if name == "int8_linear":
            out[-1].update(matmul_ms=known("matmul_ms"), matmul_device_ms=known("matmul_device_ms"))
    return {"kernels": out}


# ---------------------------------------------------------------------------
# phase 4: the full-width AVE eval forward through the engine
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (("K1", ("window_attention_kernel",)),
                 ("K2", ("block_attn_",)),
                 ("K3", ("bottleneck_kernel",)),
                 ("K4", ("int8_linear_kernel",)),
                 ("library GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("memcpy", ("memcpy", "memset")))


def kernel_group(name: str) -> str:
    """The first group of KERNEL_GROUPS whose key is in the kernel's name."""
    low = name.lower()
    return next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")


def profile_forward(eng, wave, frames):
    """One engine forward under torch.profiler: device time by kernel group,
    the busiest kernels, and the share of the forward's span the card idles."""
    profile_run(lambda: eng.forward_batch(wave, frames), f"one forward of {BATCH} clips",
                "profile")


def profile_run(fn, what, tag, host_ops=True, op_group=None):
    """`fn()` under torch.profiler; prints `tag:` lines: device busy time and
    the idle share of the span from the first kernel's start to the last
    one's end, time by kernel group, the busiest kernels. `host_ops=False`
    records device activity only (a train step's host ops number ~10^5).
    `op_group(host op)` -> a group name or None moves the kernels a host op
    launched from their name's group to that one (by the op's own kernel
    list, so each kernel moves once), and splits "other" by the host op
    (and its parent) that launched each kernel; returns {group: ms}."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"{tag}: the profiler recorded no device time", flush=True)
        return {}
    by_group, by_name = {}, {}
    for e in dev:
        us = e.time_range.elapsed_us()
        group = kernel_group(e.name)
        by_group[group] = by_group.get(group, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    moved, other_ops = {}, {}
    for e in prof.events() if op_group else ():
        if not e.kernels or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        group = op_group(e)
        for k in e.kernels:
            if group:
                by_group[kernel_group(k.name)] = by_group.get(kernel_group(k.name), 0.0) - k.duration
                by_group[group] = by_group.get(group, 0.0) + k.duration
                moved[group] = moved.get(group, 0) + 1
            elif kernel_group(k.name) == "other":  # "other" by the host op that launched it
                key = " < ".join(op.name for op in (e, e.cpu_parent) if op is not None)
                us, n = other_ops.get(key, (0.0, 0))
                other_ops[key] = (us + k.duration, n + 1)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for s, t in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, t
        else:
            hi = max(hi, t)
    busy += hi - lo
    span = max(t for _, t in spans) - spans[0][0]
    groups = ", ".join(f"{g} {us / 1e3:.3f} ms" for g, us in
                       sorted(by_group.items(), key=lambda kv: -kv[1]))
    print(f"{tag}: {what}: device busy {busy / 1e3:.3f} ms of a "
          f"{span / 1e3:.3f} ms span ({100.0 * (1.0 - busy / span):.1f}% idle), "
          f"{len(dev)} device events; by group: {groups}"
          + "".join(f"; {n} kernels moved to {g}" for g, n in moved.items()), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:10] + [kv for kv in top[10:] if kernel_group(kv[0])[0] == "K"]:
        short = name.replace("dgsct::(anonymous namespace)::", "")
        print(f"{tag}:   {us / 1e3:9.3f} ms  {kernel_group(name):5s} {short[:110]}", flush=True)
    for key, (us, n) in sorted(other_ops.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"{tag}:   other by host op: {us / 1e3:9.3f} ms in {n} kernels  {key}", flush=True)
    return {g: us / 1e3 for g, us in by_group.items()}


def seeded_model(cfg, device="cuda"):
    """Float32 (params, state) from seed 0 with seeded nonzero adapter gates
    (zero at init, the adapters would not count), as phases 4, 6 and 7 use."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.models.interleave import ADKEYS

    params, state = ave.init_ave_model(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for k in ADKEYS:
        for ap in params["adapters"][k]:
            for g in ("gate", "gate_av"):
                ap[g] = torch.empty_like(ap[g]).uniform_(0.2, 0.6, generator=gen)
    return params, state


def seeded_requests(cfg):
    """REQUESTS requests of BATCH seeded clips: float, int16 and float waves
    with uint8 frames."""
    rs = np.random.RandomState(0)
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    wave_f = (0.3 * rs.randn(BATCH, T, L)).clip(-1, 1).astype(np.float32)
    frames = lambda: rs.randint(0, 256, (BATCH, T, S, S, 3), dtype=np.uint8)
    return [(wave_f, frames()), ((wave_f * 32767).astype(np.int16), frames()),
            (wave_f[::-1].copy(), frames())][:REQUESTS]


def run_model(cfg):
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
    from dg_sct_tpu_torch.ops.basic import normalize_frames_u8
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVEInferenceEngine

    params, state = seeded_model(cfg)
    requests = seeded_requests(cfg)
    eng = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, device="cuda")
    eng.predict(*requests[0])                       # warm-up: allocator, cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [eng.predict(w, f) for w, f in requests]
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for o in outs:
        assert o["event_scores"].shape == (BATCH, cfg.num_classes), o["event_scores"].shape
        assert o["is_event_scores"].shape == (BATCH, cfg.num_frames), o["is_event_scores"].shape
        assert o["segment_preds"].shape == (BATCH, cfg.num_frames)
        for v in o.values():
            assert np.isfinite(v).all(), "non-finite engine output"
    want = {k: v * REQUESTS for k, v in PER_FORWARD.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want} "
                             f"({PER_FORWARD} per forward x {REQUESTS})")
    print(f"model: {REQUESTS} requests of {BATCH} clips in {dt:.3f} s = "
          f"{REQUESTS * BATCH / dt:.3f} clips/s (bf16, kernels on), peak memory "
          f"{peak / 2**30:.3f} GiB, launches {counts}, card {torch.cuda.get_device_name(0)}",
          flush=True)

    profile_forward(eng, *requests[0])

    # float32: kernels on vs the plain path, same folded weights and inputs
    fp, fs = fold_adapters_eval(params, state, cfg)
    wave = torch.as_tensor(requests[0][0], device="cuda")
    frames = normalize_frames_u8(torch.as_tensor(requests[0][1], device="cuda"), torch.float32)
    with torch.inference_mode():
        got = ave.forward(fp, fs, wave, frames, cfg, kernels=True, device="cuda")
        ref = ave.forward(fp, fs, wave, frames, cfg, kernels=False, device="cuda")
    atol, rtol = MODEL_TOL
    for k in ref:
        g, r = got[k].float(), ref[k].float()
        err = (g - r).abs().max().item()
        ok = bool(torch.isfinite(g).all()) and bool(((g - r).abs() <= atol + rtol * r.abs()).all())
        print(f"model f32 {k}: kernels vs plain max abs err {err:.3e} "
              f"(atol {atol}, rtol {rtol}), |plain| max {r.abs().max().item():.3e}", flush=True)
        if not ok:
            raise AssertionError(f"f32 forward {k}: kernels and plain path disagree ({err:.3e})")
    bf = outs[0]["event_scores"]
    print(f"model bf16 engine vs f32 plain event_scores max abs diff "
          f"{np.abs(bf - ref['event_scores'].cpu().numpy()).max():.3e}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 5: the serving path, from a DG-SCT state dict to predict_clips
# ---------------------------------------------------------------------------

CENSUS = Path(__file__).resolve().parent / "tests" / "golden" / "census_best_82_18.json"
CLIPS = 7          # B=2, chunk=2: 4 forwards, the last batch ragged
STREAM_CLIPS = 32  # clips a timed run


def census_state_dict(path, seed=0):
    """A DG-SCT state dict with exactly the keys, shapes and dtypes of the
    census at `path`, values from `seed`: weights N(0, 1/fan_in), biases
    N(0, 0.02^2), LayerNorm and BatchNorm scales near 1, running variances
    in [0.5, 1.5], adapter gates in [0.2, 0.6], logit scales near log 10."""
    census = json.loads(Path(path).read_text())
    rng = np.random.default_rng(seed)
    normal = lambda shape, std, mean=0.0: (mean + std * rng.standard_normal(
        shape, dtype=np.float32)).astype(np.float32)
    sd = {}
    for k, spec in census.items():
        shape, dtype = tuple(spec["shape"]), np.dtype(spec["dtype"])
        if dtype.kind in "iu":
            sd[k] = np.zeros(shape, dtype)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif k.endswith(("running_mean", ".bias", "_bias")):
            sd[k] = normal(shape, 0.02)
        elif k.endswith((".gate", ".gate_av")):
            sd[k] = rng.uniform(0.2, 0.6, shape).astype(np.float32)
        elif k.endswith("logit_scale"):
            sd[k] = normal(shape, 0.1, math.log(10.0))
        elif len(shape) == 1 and k.endswith(".weight"):  # LayerNorm / BatchNorm scales
            sd[k] = normal(shape, 0.1, 1.0)
        else:
            sd[k] = normal(shape, 1.0 / math.sqrt(max(1, int(np.prod(shape[1:])))))
    return sd


def import_census_model(cfg):
    """The census state dict through the port's import path: converter,
    key census, `from_jax` onto the card."""
    from dg_sct_tpu_torch.utils import torch_convert as TC
    from dg_sct_tpu_torch.weights import from_jax

    t0 = time.perf_counter()
    sd = TC.track(census_state_dict(CENSUS))
    params, state = TC.convert_ave_model(sd)
    report = TC.census_report(sd)
    if report["unexplained"]:
        raise AssertionError(f"census: unexplained keys {report['unexplained'][:10]}")
    params, state = from_jax(params, state, cfg, device="cuda")
    print(f"import: {len(sd)} keys of {CENSUS.name}: {len(report['consumed'])} consumed, "
          f"{len(report['ignored'])} ignored, 0 unexplained; on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params, state


class Clips:
    """A map-style dataset of distinct seeded full-width clips in memory, in
    one wire format: int16 wave with uint8 RGB frames, or mu-law wave with
    YUV420 planes made from the same frames (JFIF, 2x2 chroma means). Frames
    are `size` square (the towers' input unless given); `named` adds the
    (category, video) fields an AVS dataset carries."""

    def __init__(self, n, cfg, seed, yuv420=False, size=None, named=False):
        from dg_sct_tpu_torch.ops.basic import encode_mulaw_u8

        rs = np.random.RandomState(seed)
        T, L = cfg.num_frames, cfg.htsat.frontend.clip_samples
        S = size or cfg.swin.img_size
        self.wave = (np.clip(0.3 * rs.randn(n, T, L), -1, 1) * 32767).astype(np.int16)
        self.frames = rs.randint(0, 256, (n, T, S, S, 3), dtype=np.uint8)
        self.names = [("synthetic", f"c{i:03d}") for i in range(n)] if named else None
        self.yuv420 = yuv420
        if yuv420:
            self.mulaw = encode_mulaw_u8(self.wave)
            rgb = self.frames.astype(np.float32)
            ycc = rgb @ np.asarray([[0.299, -0.168736, 0.5], [0.587, -0.331264, -0.418688],
                                    [0.114, 0.5, -0.081312]], np.float32)
            ycc[..., 1:] += 128.0
            ycc = np.clip(np.round(ycc), 0, 255)
            self.y = ycc[..., 0].astype(np.uint8)
            uv = ycc[..., 1:].reshape(n, T, S // 2, 2, S // 2, 2, 2).mean((3, 5))
            self.uv = np.round(uv).astype(np.uint8)

    def __len__(self):
        return len(self.wave)

    def __getitem__(self, i):
        if self.yuv420:
            item = {"wave": self.mulaw[i], "image_y": self.y[i], "image_uv": self.uv[i]}
        else:
            item = {"wave": self.wave[i], "image": self.frames[i]}
        if self.names:
            item["category"], item["video"] = self.names[i]
        return item

    def bytes_per_forward(self, batch):
        return batch * sum(v.nbytes for v in self[0].values() if isinstance(v, np.ndarray))


def check_clips(name, eng, ds, per_call, ref=None):
    """predict_clips with the launch counts read around it; shapes, finite
    values and, against `ref` (predict's output), agreement within bf16 TOL."""
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    ev, ie, pred = eng.predict_clips(ds)
    counts = launch_counts()
    n, T = len(ds), eng.cfg.num_frames
    if ev.shape != (n, 28) or ie.shape != (n, T) or pred.shape != (n, T):
        raise AssertionError(f"{name}: shapes {ev.shape} {ie.shape} {pred.shape}")
    if not (np.isfinite(ev).all() and np.isfinite(ie).all()):
        raise AssertionError(f"{name}: non-finite scores")
    want = {k: v * per_call for k, v in PER_FORWARD.items()}
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts}, expected {want}")
    line = f"serve {name}: {n} clips, launches {counts} ({per_call} forwards)"
    if ref is not None:
        atol, rtol = TOL[torch.bfloat16]
        for got, key in ((ev, "event_scores"), (ie, "is_event_scores")):
            err = np.abs(got - ref[key])
            line += f", {key} vs predict max abs diff {err.max():.3e}"
            if (err > atol + rtol * np.abs(ref[key])).any():
                raise AssertionError(f"{name}: predict_clips and predict disagree on {key}")
    print(line, flush=True)
    return ev, ie


def profile_chunk(eng, ds):
    """One predict_clips of several chunks under torch.profiler: each
    host-to-device copy's device time, start and share beside kernels, its
    kind, and the copies' time a forward."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.predict_clips(ds)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    h2d = sorted((e for e in dev if "htod" in e.name.lower().replace(" ", "")),
                 key=lambda e: e.time_range.start)
    kernels = sorted((e.time_range.start, e.time_range.end) for e in dev
                     if "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    forwards = -(-len(ds) // eng.B)
    staged = {k: eng.B * eng.chunk * v.nbytes for k, v in ds[0].items()}
    print(f"stream: profile of {len(ds)} clips ({forwards} forwards, chunks of {eng.chunk}): "
          f"{len(h2d)} host-to-device copies recorded of {len(staged) * forwards // eng.chunk} "
          f"staged; a chunk stages " + ", ".join(f"{k} {b / 1e6:.3f} MB"
                                                 for k, b in staged.items()), flush=True)
    if not h2d:
        return
    t0 = min(a for a, _ in kernels) if kernels else h2d[0].time_range.start
    total = 0.0
    for e in h2d:
        s, t = e.time_range.start, e.time_range.end
        beside = sum(max(0.0, min(t, b) - max(s, a)) for a, b in kernels)
        total += t - s
        print(f"stream:   copy {(t - s) / 1e3:.4f} ms at +{(s - t0) / 1e3:.3f} ms, "
              f"{100.0 * min(beside, t - s) / max(t - s, 1e-9):.1f}% beside kernels, {e.name}",
              flush=True)
    per_fwd = total / 1e3 / (len(h2d) / len(staged) * eng.chunk)
    print(f"stream: host-to-device copies {per_fwd:.4f} ms a forward (recorded copies), kinds "
          f"{sorted({e.name for e in h2d})}", flush=True)


def write_ave_tree(root, n, cfg, size=320, seed=0):
    """An AVE tree on disk: `n` videos of T JPEG frames (size x size) and
    int16 waves, with categories, annotations and split files."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    T, L = cfg.num_frames, cfg.htsat.frontend.clip_samples
    cats = [f"c{i}" for i in range(cfg.num_classes)]
    (root / "audio").mkdir(parents=True)
    rows = ["Category&VideoID&Quality&StartTime&EndTime"]
    for v in range(n):
        vid = f"v{v:03d}"
        vdir = root / "frames" / vid
        vdir.mkdir(parents=True)
        for t in range(T):
            Image.fromarray(rs.randint(0, 256, (size, size, 3), dtype=np.uint8)).save(
                vdir / f"{t:08d}.jpg", quality=90)
        np.save(root / "audio" / f"{vid}.npy",
                (np.clip(0.3 * rs.randn(T * L), -1, 1) * 32767).astype(np.int16))
        rows.append(f"{cats[v % len(cats)]}&{vid}&good&{v % 4}&{6 + v % 4}")
    (root / "categories.txt").write_text("\n".join(cats) + "\n")
    for name in ("Annotations.txt", "testSet.txt"):
        (root / name).write_text("\n".join(rows) + "\n")
    return root


def serve_from_disk(eng, cfg):
    """predict_clips over an on-disk AVE tree in both wire formats, if
    Pillow can write it; prints which decoder ran. A native build that
    fails for want of libjpeg's header falls back to PIL, any other build
    failure is fatal."""
    import tempfile

    from dg_sct_tpu_torch import native
    from dg_sct_tpu_torch.data.ave import AVEDataset

    try:
        import PIL  # noqa: F401
    except ImportError as e:
        print(f"serve disk: not run: Pillow does not import ({e})", flush=True)
        return
    if native.available():
        decoder = "native"
    elif "jpeglib.h" in (native.build_error() or ""):
        decoder = "pil"
        print(f"serve disk: native core not built, jpeglib.h missing: "
              f"{native.build_error().strip().splitlines()[0]}", flush=True)
    else:
        raise RuntimeError(f"native io core failed to build:\n{native.build_error()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ave_") as tmp:
        root = write_ave_tree(Path(tmp), CLIPS, cfg)
        for fmt, kw in (("u8+i16", {"raw_u8": True}),
                        ("yuv420+mulaw", {"yuv420": True, "wave_mulaw": True})):
            ds = AVEDataset(str(root), "test", img_size=cfg.swin.img_size,
                            frame_dir=str(root / "frames"), audio_dir=str(root / "audio"),
                            num_frames=cfg.num_frames,
                            segment_samples=cfg.htsat.frontend.clip_samples, **kw)
            t0 = time.perf_counter()
            check_clips(f"disk {fmt} ({decoder} decoder)", eng, ds, 4)
            print(f"serve disk {fmt}: decoder {decoder}, {len(ds)} clips of 320x320 JPEGs in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)


def run_serving(cfg):
    """Phase 5: the census-built model in bf16 through predict_clips."""
    from dg_sct_tpu_torch.serve import AVEInferenceEngine

    params, state = import_census_model(cfg)
    eng = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device="cuda")
    del params, state
    u8, yuv = Clips(CLIPS, cfg, seed=10), Clips(CLIPS, cfg, seed=10, yuv420=True)
    ref = eng.predict(u8.wave, u8.frames)
    ev, ie = check_clips("u8+i16", eng, u8, 4, ref)
    ev2, ie2 = check_clips("u8+i16 again", eng, u8, 4, ref)
    print(f"serve u8+i16: two runs max abs diff {np.abs(ev2 - ev).max():.3e} / "
          f"{np.abs(ie2 - ie).max():.3e}", flush=True)
    ev, ie = check_clips("yuv420+mulaw", eng, yuv, 4)
    ev2, ie2 = check_clips("yuv420+mulaw again", eng, yuv, 4)
    atol, rtol = TOL[torch.bfloat16]
    if not (np.allclose(ev2, ev, atol=atol, rtol=rtol) and np.allclose(ie2, ie, atol=atol,
                                                                       rtol=rtol)):
        raise AssertionError("yuv420+mulaw: two predict_clips runs disagree")
    print(f"serve yuv420+mulaw: two runs max abs diff {np.abs(ev2 - ev).max():.3e} / "
          f"{np.abs(ie2 - ie).max():.3e}", flush=True)
    eng.chunk = 3  # 7 clips: 4 batches in 2 chunks of 3, the last padded with 2 batches
    check_clips("u8+i16 chunk 3", eng, u8, 6, ref)
    eng.chunk = 2

    serve_from_disk(eng, cfg)

    u8, yuv = Clips(STREAM_CLIPS, cfg, seed=11), Clips(STREAM_CLIPS, cfg, seed=11, yuv420=True)
    for ds, fmt in ((u8, "u8+i16"), (yuv, "yuv420+mulaw")):
        print(f"stream: {fmt}: {ds.bytes_per_forward(BATCH) / 1e6:.3f} MB host to device a "
              f"forward of {BATCH} clips", flush=True)
    for rnd in (1, 2):
        for name, fn in (("predict_clips u8+i16", lambda: eng.predict_clips(u8)),
                         ("predict u8+i16", lambda: eng.predict(u8.wave, u8.frames)),
                         ("predict_clips yuv420+mulaw", lambda: eng.predict_clips(yuv))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
            print(f"stream: run {rnd} {name}: {STREAM_CLIPS} clips in {dt:.3f} s = "
                  f"{STREAM_CLIPS / dt:.3f} clips/s (B={BATCH}, chunk {eng.chunk}, bf16)",
                  flush=True)
    profile_chunk(eng, Clips(3 * BATCH * eng.chunk, cfg, seed=12))


# ---------------------------------------------------------------------------
# phase 6: AVE training at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH = 8      # TrainConfig.batch_size: 80 frames and 80 audio clips a mini-step
TRAIN_ACCUM = 2
TRAIN_STEPS = 4
EVAL_LAUNCHES = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 0,
                 "int8_linear": 0}


def unused_leaf(path) -> bool:
    """Trainable weights the AVE forward never reads, kept for checkpoint
    parity (`models/heads/ave.py`): CMBS's AVInter / VAInter and the
    decoders' self-attention. Their gradient is zero, so Adam leaves them."""
    return (path[0] == "CMBS" and path[1] in ("AVInter", "VAInter")) or (
        path[0] == "temporal_attn" and path[1].endswith("_decoder") and "self_attn" in path)


def train_batches(cfg, n, batch, seed, device):
    """`n` seeded synthetic batches at the model's widths on `device`, each
    with a mixup lambda a clip of audio (B*T)."""
    from dg_sct_tpu_torch.data.ave import synthetic_batch

    out = []
    for i in range(n):
        b = synthetic_batch(batch, img_size=cfg.swin.img_size, num_segments=cfg.num_frames,
                            sr=cfg.htsat.frontend.clip_samples, seed=seed + i)
        b["mixup_lambda"] = np.random.RandomState(seed + i).beta(
            0.5, 0.5, size=(batch * cfg.num_frames,)).astype(np.float32)
        out.append({k: torch.as_tensor(v, device=device) for k, v in b.items()})
    return out


def timed_step(step, args):
    """One train step, synchronised -> (its outputs, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def remat_none_step(cfg, opt, tr, fr, state, opt_state, batch, device):
    """Two mini-steps of TRAIN_BATCH clips with remat "none" from the same
    inputs (the first grows the allocator's pool): ([seconds of each], peak
    GiB). An out-of-memory error is fatal."""
    from dg_sct_tpu_torch.train import ave_train

    step = ave_train.make_train_step(cfg, opt, device=device, remat_policy="none")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        (_, _, _, m), dt = timed_step(step, (tr, fr, state, opt_state, batch,
                                             torch.Generator(device=device).manual_seed(5)))
        if not math.isfinite(float(m["loss"])):
            raise AssertionError("train remat none: the loss is not finite")
        times.append(dt)
    return times, torch.cuda.max_memory_allocated() / 2**30


def run_training(cfg, device="cuda"):
    """Phase 6: the full-width model in bf16 over float32 Adam masters, remat
    "full", TRAIN_BATCH clips, accum TRAIN_ACCUM; TRAIN_STEPS mini-steps
    with SpecAugment, drop_path, dropout and mixup on, the checks of each,
    a profiled mini-step, two with remat "none", the eval step, and the
    saved train state served by the engine."""
    import dataclasses
    import tempfile

    from dg_sct_tpu_torch.configs import TrainConfig
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVEInferenceEngine
    from dg_sct_tpu_torch.train import ave_train
    from dg_sct_tpu_torch.utils import checkpoint as ckpt
    from dg_sct_tpu_torch.utils.tree import tree_paths
    from dg_sct_tpu_torch.weights import from_jax

    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    params, state = seeded_model(cfg, device)
    gen = torch.Generator(device=device)
    tr, fr = ave_train.partition_params(params)
    p0 = {p: t.cpu() for p, t in tree_paths(params)}  # on the host: not in the peak
    s0 = {p: t.cpu() for p, t in tree_paths(state)}
    opt = ave_train.make_optimizer(tr, TrainConfig(batch_size=TRAIN_BATCH,
                                                   accum_steps=TRAIN_ACCUM), steps_per_epoch=1)
    opt_state = opt.init(tr)
    step = ave_train.make_train_step(tcfg, opt, device=device, remat_policy="full")
    batches = train_batches(cfg, TRAIN_STEPS, TRAIN_BATCH, seed=20, device=device)
    gen.manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for i in range(TRAIN_STEPS):
        (tr, state, opt_state, m), dt = timed_step(step, (tr, fr, state, opt_state, batches[i],
                                                          gen))
        times.append(dt)
        loss = float(m["loss"])
        print(f"train: mini-step {i + 1}: loss {loss:.4f}, acc {float(m['acc']):.2f}, "
              f"{dt:.3f} s, applied updates {opt_state['gradient_step']}", flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"train: mini-step {i + 1}: the loss is not finite")
        if i > 1:
            continue
        now = dict(tree_paths(ave_train.merge_params(tr, fr)))
        same = {p: torch.equal(now[p].cpu(), p0[p]) for p in p0}
        if i == 0 and not all(same.values()):
            changed = [p for p in same if not same[p]]
            raise AssertionError(f"train: mini-step 1 changed {changed[:3]}")
        if i == 1:
            frozen = [p for p in same if p[0] in ("swin", "htsat")]
            moved = [p for p in same if p[0] not in ("swin", "htsat") and not same[p]]
            dead = [p for p in same if p[0] not in ("swin", "htsat") and unused_leaf(p)]
            bad = ([p for p in frozen if not same[p]]
                   + [p for p in same if p[0] not in ("swin", "htsat")
                      and same[p] != unused_leaf(p)])
            if bad:
                raise AssertionError(f"train: after mini-step 2, leaves against the rule: "
                                     f"{bad[:5]}")
            print(f"train: after mini-step 2: {len(moved)} trainable leaves changed, "
                  f"{len(dead)} unused ones and {len(frozen)} frozen ones bit-identical",
                  flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"train: the train steps launched kernels {counts}")
    bn = [(p, t) for p, t in tree_paths(state) if p[-1] in ("mean", "var")]
    still = [p for p, t in bn if torch.equal(t.cpu(), s0[p])]
    counts_bn = {int(t) for p, t in tree_paths(state) if p[-1] == "count"}
    if still or counts_bn != {TRAIN_STEPS}:
        raise AssertionError(f"train: BN state did not move: {still[:3]}, counts {counts_bn}")
    print(f"train: {TRAIN_STEPS} mini-steps of B={TRAIN_BATCH} clips, accum {TRAIN_ACCUM}, "
          f"bf16 over float32 masters, remat full: "
          + ", ".join(f"{t:.3f}" for t in times) + f" s; peak memory {peak:.3f} GiB; "
          f"{len(bn)} BN stats of bn0 and the adapters moved, counts {TRAIN_STEPS}; "
          f"kernel launches {counts}; card {torch.cuda.get_device_name(0)}", flush=True)

    profile_run(lambda: step(tr, fr, state, opt_state, batches[0], gen),
                f"one mini-step of {TRAIN_BATCH} clips, remat full", "train profile",
                host_ops=False)
    dts, peak_none = remat_none_step(tcfg, opt, tr, fr, state, opt_state, batches[0], device)
    print(f"train remat none: two mini-steps of B={TRAIN_BATCH} clips in "
          + ", ".join(f"{t:.3f}" for t in dts) + f" s, peak memory {peak_none:.3f} GiB",
          flush=True)

    estep = ave_train.make_eval_step(tcfg, device=device)
    reset_launch_counts()
    em = estep(tr, fr, state, batches[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != EVAL_LAUNCHES or not all(bool(torch.isfinite(v).all())
                                          for v in em["outputs"].values()):
        raise AssertionError(f"train eval step: launches {counts} (expected {EVAL_LAUNCHES}) "
                             f"or non-finite outputs")
    print(f"train eval step: B={TRAIN_BATCH}, correct_frac {float(em['correct_frac']):.4f}, "
          f"launches {counts}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        path = str(Path(tmp) / "train_state.npz")
        t0 = time.perf_counter()
        ckpt.save_train_state(path, params=ave_train.merge_params(tr, fr), state=state,
                              opt_state=opt_state, rng_state=gen.get_state(),
                              step=opt_state["gradient_step"])
        size = Path(path).stat().st_size
        lp, ls = ckpt.load_params_and_state(path)
        dt = time.perf_counter() - t0
    eng = AVEInferenceEngine(cfg, *from_jax(lp, ls, cfg, device=device), batch_size=BATCH,
                             device=device)
    rs = np.random.RandomState(30)
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    wave = (np.clip(0.3 * rs.randn(BATCH, T, L), -1, 1) * 32767).astype(np.int16)
    frames = rs.randint(0, 256, (BATCH, T, S, S, 3), dtype=np.uint8)
    eng.predict(wave, frames)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = eng.predict(wave, frames)
    counts = launch_counts()
    if counts != PER_FORWARD or not all(np.isfinite(v).all() for v in out.values()):
        raise AssertionError(f"train serve: launches {counts} (expected {PER_FORWARD}) or "
                             f"non-finite scores")
    print(f"train serve: train state of {size / 1e9:.3f} GB saved and read in {dt:.1f} s; "
          f"the engine folds its params and state and answers {BATCH} clips, launches "
          f"{counts}", flush=True)


# ---------------------------------------------------------------------------
# phase 7: int8 serving of the full-width model
# ---------------------------------------------------------------------------

INT8_PER_FORWARD = {"window_attention": 34, "block_attention": 2, "adapter_bottleneck": 48,
                    "int8_linear": 430}
INT8_ELIGIBLE = 431     # eligible linears of towers and adapters; HTS-AT's head is never called
INT8_TOWERS_ONLY = 142  # K4 a forward with the towers alone quantized
INT8_ATTN_K1 = 10       # K1 a forward with int8_attn: HTS-AT stages 1-3 only
# f32 int8 forward, kernels against the plain path: max |delta| over the logit
# spread, per output. K1-K3 differ from their plain versions by ~1e-6, and the
# int8 forward amplifies any difference that carries a value across a rounding
# boundary of a quantize. The bounds sit between two sets of readings of this
# seeded forward on the H100: above the sound kernels' (7.2e-3, 2.3e-2) and the
# plain path's own move under a 1e-6 relative change of its inputs (5.6e-3,
# 4.7e-2, printed beside), and below what K1 gave while it read unwritten TF32
# halves of its pad rows (event_scores 0.025-0.106, is_event_scores 0.086-0.46).
# Every K4 call of the forward is also held against the plain version on the
# very input it was given (TOL).
INT8_TOL = {"event_scores": 0.02, "is_event_scores": 0.07}
INT8_NUDGE = 1e-6  # relative change of the frames for the sensitivity


def int8_variants(scales):
    """(name, engine options, launches a forward) of the other int8 runs."""
    return (("towers only", dict(int8_towers=True, act_scales=scales),
             dict(INT8_PER_FORWARD, int8_linear=INT8_TOWERS_ONLY)),
            ("dynamic scales", dict(int8_towers=True, int8_adapters=True, act_scales=None),
             INT8_PER_FORWARD),
            ("int8_attn", dict(int8_towers=True, int8_adapters=True, act_scales=scales,
                               int8_attn=True),
             dict(INT8_PER_FORWARD, window_attention=INT8_ATTN_K1)))


def spread_err(got, ref):
    """max |got - ref| over max |ref|."""
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def check_int8_calls(qp, towers, forward, what):
    """One forward (`forward(tree)`, kernels on) of the quantized tree `qp`, in
    which every quantized linear of `towers` also sends its input through K4
    and its plain version side by side (a tag on each, as calibration
    records): (calls, max abs error). Fatal beyond TOL."""
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.ops.kernels import int8_linear as K4

    ordered = quant._ordered_towers(qp, towers)
    nodes = quant.eligible_linears(ordered)

    class Check(quant.Recorder):
        def record(self, qid, x):
            p = nodes[qid]
            args = (x.reshape(-1, x.shape[-1]), p["kernel_q"], p["kscale"], p.get("ascale"),
                    p.get("bias"))
            got, ref = K4.int8_linear(*args), K4.linear_int8_plain(*args)
            diff = torch.nan_to_num((got - ref).abs(), nan=math.inf)
            worst = (diff / (TOL[x.dtype][0] + TOL[x.dtype][1] * ref.abs())).max()
            bad_x = (~torch.isfinite(x)).sum()
            self.calls.append((qid, torch.stack([diff.max(), worst, bad_x.float()])))

    check = Check()
    tagged = dict(qp)
    tagged.update(quant.attach_qtags(ordered, recorder=check))
    with torch.inference_mode():
        forward(tagged)
    stats = torch.stack([e for _, e in check.calls]).cpu()
    order = stats[:, 1].argsort(descending=True)[:3].tolist()
    for i in order:
        qid = check.calls[i][0]
        print(f"{what}: K4 call of qid {qid} {tuple(nodes[qid]['kernel_q'].shape)}: max abs "
              f"err {stats[i, 0]:.3e}, error/tolerance {stats[i, 1]:.3e}, non-finite inputs "
              f"{int(stats[i, 2])}", flush=True)
    err, worst = stats[:, 0].max().item(), stats[:, 1].max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{what}: a K4 call of the forward disagrees with the plain "
                             f"version ({err:.3e})")
    return len(check.calls), err


def run_int8(cfg, device="cuda"):
    """Phase 7: calibrate on a seeded batch, serve the full-width model in int8
    (towers and adapters, static scales) in turns with a bf16 engine on the
    same weights and requests; drift, a profiled forward, the f32 int8
    forward with kernels against the plain one, and the other int8 options.
    Returns the int8 engine's launch counts over its REQUESTS requests."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.ops.basic import normalize_frames_u8
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVEInferenceEngine
    from dg_sct_tpu_torch.utils.tree import tree_paths

    torch.cuda.empty_cache()
    params, state = seeded_model(cfg, device)
    bf = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, device=device)
    # the calibration batch of bench.py:666-674, in bf16
    rs = np.random.RandomState(7)
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    cw = torch.as_tensor((rs.randn(BATCH, T, L) * 0.1).astype(np.float32), device=device)
    ci = torch.as_tensor(rs.rand(BATCH, T, S, S, 3).astype(np.float32), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scales = quant.calibrate_ave(bf.params, bf.state, bf.cfg, cw.to(torch.bfloat16),
                                 ci.to(torch.bfloat16), towers=INT8_TOWERS, gelu=bf.gelu,
                                 device=device)
    dt = time.perf_counter() - t0
    shapes = quant.qid_shape_map(quant._ordered_towers(bf.params, INT8_TOWERS))
    if len(shapes) != INT8_ELIGIBLE or len(scales) != INT8_PER_FORWARD["int8_linear"]:
        raise AssertionError(f"int8: {len(scales)} scales for {len(shapes)} eligible linears")
    print(f"int8: calibrated {len(scales)} activation scales of {len(shapes)} eligible linears "
          f"in {dt:.3f} s (one plain bf16 forward of {BATCH} clips); absmax "
          f"{min(scales.values()):.4g} to {max(scales.values()):.4g}", flush=True)

    q8 = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, device=device,
                            int8_towers=True, int8_adapters=True, act_scales=scales)
    engines = {"bf16": (bf, PER_FORWARD), "int8": (q8, INT8_PER_FORWARD)}
    requests = seeded_requests(cfg)
    for eng, _ in engines.values():
        eng.predict(*requests[0])  # warm-up
    weights = {k: sum(t.nbytes for _, t in tree_paths(eng.params) if torch.is_tensor(t))
               for k, (eng, _) in engines.items()}
    secs, work, outs = {k: 0.0 for k in engines}, {k: 0 for k in engines}, {k: [] for k in engines}
    int8_counts = dict.fromkeys(INT8_PER_FORWARD, 0)
    for r, req in enumerate(requests):  # in turns: bf16 int8, int8 bf16, bf16 int8
        for name in ("bf16", "int8") if r % 2 == 0 else ("int8", "bf16"):
            eng, want = engines[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = eng.predict(*req)
            secs[name] += time.perf_counter() - t0
            counts = launch_counts()
            work[name] = max(work[name], torch.cuda.max_memory_allocated() - resident)
            if counts != want:
                raise AssertionError(f"int8: {name} request {r}: launches {counts}, "
                                     f"expected {want}")
            if name == "int8":
                int8_counts = {k: int8_counts[k] + v for k, v in counts.items()}
            if not all(np.isfinite(v).all() for v in out.values()):
                raise AssertionError(f"int8: {name} request {r}: non-finite outputs")
            if out["event_scores"].shape != (BATCH, cfg.num_classes):
                raise AssertionError(f"int8: {name}: event_scores {out['event_scores'].shape}")
            outs[name].append(out)
    n = BATCH * len(requests)
    print(f"int8: {len(requests)} requests of {BATCH} clips in turns with bf16: int8 "
          f"{n / secs['int8']:.3f} clips/s, bf16 {n / secs['bf16']:.3f} clips/s; weights + a "
          f"request's peak above what was resident: int8 {weights['int8'] / 2**30:.3f} + "
          f"{work['int8'] / 2**30:.3f} GiB, bf16 {weights['bf16'] / 2**30:.3f} + "
          f"{work['bf16'] / 2**30:.3f} GiB; launches a forward int8 {INT8_PER_FORWARD}, bf16 "
          f"{PER_FORWARD}; card {torch.cuda.get_device_name(0)}", flush=True)
    cat = lambda name, k: np.concatenate([o[k] for o in outs[name]])
    agree = float((cat("int8", "segment_preds") == cat("bf16", "segment_preds")).mean())
    print(f"int8: drift against bf16 over {n} clips: max |delta event_scores| / max |event_scores| "
          f"{spread_err(cat('int8', 'event_scores'), cat('bf16', 'event_scores')):.4f}, "
          f"is_event_scores "
          f"{spread_err(cat('int8', 'is_event_scores'), cat('bf16', 'is_event_scores')):.4f}; "
          f"segment_preds agree {100.0 * agree:.1f}%", flush=True)

    profile_run(lambda: q8.forward_batch(*requests[0]), f"one int8 forward of {BATCH} clips",
                "int8 profile")
    del q8, engines

    # float32: the int8 forward with kernels against the int8 plain path
    fp, fs = fold_adapters_eval(params, state, cfg)
    qp = quant.quantize_eval_params(fp, towers=INT8_TOWERS, act_scales=scales)
    wave = torch.as_tensor(requests[0][0], device=device)
    frames = normalize_frames_u8(torch.as_tensor(requests[0][1], device=device), torch.float32)
    gen = torch.Generator(device).manual_seed(3)
    nudge = lambda t: t * (1.0 + INT8_NUDGE * torch.randn(t.shape, device=device, generator=gen))
    with torch.inference_mode():
        reset_launch_counts()
        got = ave.forward(qp, fs, wave, frames, cfg, kernels=True, device=device)
        counts = launch_counts()
        ref = ave.forward(qp, fs, wave, frames, cfg, kernels=False, device=device)
        near = ave.forward(qp, fs, nudge(wave), nudge(frames), cfg, kernels=False, device=device)
        flt = ave.forward(fp, fs, wave, frames, cfg, kernels=False, device=device)
    if counts != INT8_PER_FORWARD:
        raise AssertionError(f"int8 f32: launches {counts}, expected {INT8_PER_FORWARD}")
    calls, err = check_int8_calls(
        qp, INT8_TOWERS,
        lambda t: ave.forward(t, fs, wave, frames, cfg, kernels=True, device=device),
        "int8 f32")
    print(f"int8 f32: each of the {calls} K4 calls of a forward against the plain version on "
          f"its own input: max abs err {err:.3e} (atol/rtol {TOL[torch.float32]})", flush=True)
    bad = []
    for k, bound in INT8_TOL.items():
        g, r = got[k].float().cpu().numpy(), ref[k].float().cpu().numpy()
        err = spread_err(g, r)
        print(f"int8 f32 {k}: kernels vs plain max |delta| / max |plain| {err:.3e} (bound "
              f"{bound}), max abs diff {np.abs(g - r).max():.3e}; the plain path moves "
              f"{spread_err(near[k].float().cpu().numpy(), r):.3e} with wave and frames "
              f"changed by {INT8_NUDGE:g} (relative); int8 against float (plain, f32) "
              f"{spread_err(r, flt[k].float().cpu().numpy()):.3e}", flush=True)
        if not np.isfinite(g).all() or err > bound:
            bad.append(f"{k} ({err:.3e})")
    if bad:
        raise AssertionError(f"int8 f32: kernels and plain path disagree: {', '.join(bad)}")
    del fp, fs, qp, got, ref, near, flt

    for name, opts, want in int8_variants(scales):
        eng = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, device=device, **opts)
        eng.predict(*requests[1])  # warm-up
        reset_launch_counts()
        out = eng.predict(*requests[1])
        counts = launch_counts()
        if counts != want or not all(np.isfinite(v).all() for v in out.values()):
            raise AssertionError(f"int8 {name}: launches {counts} (expected {want}) or "
                                 f"non-finite outputs")
        print(f"int8 {name}: launches {counts}, finite; event_scores against bf16 "
              f"{spread_err(out['event_scores'], outs['bf16'][1]['event_scores']):.4f} of the "
              f"spread", flush=True)
        del eng
    return int8_counts


# ---------------------------------------------------------------------------
# phase 8: AVS serving at full width
# ---------------------------------------------------------------------------

AVS_CENSUS = Path(__file__).resolve().parent / "tests" / "golden" / "census_avs_s4.json"
AVS_PER_FORWARD = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 0,
                   "int8_linear": 0}  # AVS adapters stay off K3, as in the JAX package
AVS_INT8_PER_FORWARD = {"window_attention": 34, "block_attention": 2, "adapter_bottleneck": 0,
                        "int8_linear": 142}
AVS_STREAM_CLIPS = 16
AVS_INT8_TOWERS = ("swin", "htsat")  # what the AVS engine's int8_towers quantizes
# f32 engine with kernels against the plain one, max |delta logit| over max
# |logit|: above the plain path's own move under a 1e-6 relative change of
# its inputs and above the sound kernels' readings (printed beside), below
# the readings of the faults PLANTED in front of K2.
AVS_F32_TOL = 1e-3
# the f32 int8-towers forward (B=2 clips) with kernels against the plain one,
# mean |delta logit| over mean |logit| (its max moves with the int8 roundings
# that a 1e-6 change of the inputs flips, as far as a planted fault moves it):
# above the sound kernels' reading and the plain path's move under the nudge,
# below the faults planted in front of K1, which runs the 32 quantized blocks'
# attention (readings in PERF.md, section 6, PR 9)
AVS_INT8_TOL = 1.25e-2
MASK_U8_TOL = 0.5 / 255 + 1e-6
# known faults put in front of a kernel, each read against a bound above:
# the relative-position bias as a float32 kernel that staged it in bf16
# would see it, and as an off-by-one in its key index would
PLANTED = {"bias rounded to bf16": lambda b: b.to(torch.bfloat16).to(b.dtype),
           "bias rolled by one key": lambda b: b.roll(1, -1).contiguous()}


def avs_op_group(e):
    """The AVS profile's host-op groups: every kernel under a convolution
    (cuDNN), and TPAVI's two products, the forward's only direct torch.bmm
    calls (einsum's and matmul's bmm run under those ops)."""
    op = e
    while op is not None:
        if op.name == "aten::convolution":
            return "cuDNN conv"
        op = op.cpu_parent
    if e.name == "aten::bmm" and e.cpu_parent is None:
        return "TPAVI products"
    return None


def write_avs_tree(root, videos, cfg, seed=0):
    """An AVSBench tree: T PNG frames and binary masks (mask_size^2) a video
    and a float32 wave of T x clip_samples."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    T, S, L = cfg.num_frames, cfg.mask_size, cfg.htsat.frontend.clip_samples
    (root / "audio_wav").mkdir(parents=True)
    for cat, vid in videos:
        fdir = root / "visual_frames" / "test" / cat / vid
        mdir = root / "gt_masks" / "test" / cat / vid
        fdir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        for t in range(T):
            Image.fromarray(rs.randint(0, 256, (S, S, 3), dtype=np.uint8)).save(
                fdir / f"{vid}_{t}.png")
            Image.fromarray(((rs.rand(S, S) > 0.5) * 255).astype(np.uint8)).save(
                mdir / f"{vid}_{t}.png")
        np.save(root / "audio_wav" / f"{vid}.npy",
                np.clip(0.3 * rs.randn(T * L), -1, 1).astype(np.float32))
    return root


class Nudged:
    """A dataset's items with float image and wave scaled by (1 + rel * N(0, 1))."""

    def __init__(self, ds, rel, seed):
        self.ds, self.rel, self.seed = ds, rel, seed

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = dict(self.ds[i])
        rs = np.random.RandomState(self.seed + i)
        for k in ("image", "wave"):
            v = item[k].astype(np.float32)
            item[k] = (v * (1.0 + self.rel * rs.randn(*v.shape))).astype(np.float32)
        return item


class intercept:
    """Within the block, every call of K1 or K2 (`kernel`) from the model's
    attention (`ops.windows`) goes through `wrap(kernel's wrapper)`."""

    ATTR = {"window_attention": "window_attention", "block_attention": "fused_attn_half_block"}

    def __init__(self, kernel, wrap):
        from dg_sct_tpu_torch.ops import windows

        self.mod, self.attr, self.wrap = windows, self.ATTR[kernel], wrap

    def __enter__(self):
        self.real = getattr(self.mod, self.attr)
        setattr(self.mod, self.attr, self.wrap(self.real))

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.real)


def planted(kernel, fault):
    """K1 or K2 handed its relative-position bias through `fault` (a value of
    PLANTED); the kernel itself still launches."""
    pos = {"window_attention": 3, "block_attention": 5}[kernel]

    def wrap(real):
        def faulty(*args, **kw):
            args = list(args)
            args[pos] = fault(args[pos])
            return real(*args, **kw)
        return faulty

    return intercept(kernel, wrap)


def side_by_side(kernel, calls):
    """Each call of K1 or K2 also runs the plain version on the same inputs;
    (max abs err, error/tolerance) of each goes to `calls`, on the card."""
    from dg_sct_tpu_torch.ops.kernels import block_attention as K2
    from dg_sct_tpu_torch.ops.kernels import window_attention as K1

    plain = {"window_attention": K1.window_attention_plain,
             "block_attention": K2.fused_attn_half_block_plain}[kernel]

    def wrap(real):
        def paired(*args, **kw):
            got = real(*args, **kw)
            ref = plain(*args, **kw).float()
            atol, rtol = TOL[got.dtype]
            diff = torch.nan_to_num((got.float() - ref).abs(), nan=math.inf)
            calls.append(torch.stack([diff.max(), (diff / (atol + rtol * ref.abs())).max()]))
            return got
        return paired

    return intercept(kernel, wrap)


def report_calls(what, kernel, calls, bad):
    """Print and check what `side_by_side` collected."""
    if not calls:
        bad.append(f"{what}: no {kernel} call to check")
        return
    stats = torch.stack(calls).cpu()
    err, worst = stats[:, 0].max().item(), stats[:, 1].max().item()
    print(f"{what}: each of the {len(calls)} {kernel} calls against the plain version on its "
          f"own input: max abs err {err:.3e}, error/tolerance {worst:.3e} (atol/rtol "
          f"{TOL[torch.float32]})", flush=True)
    if not worst <= 1.0:
        bad.append(f"{what}: a {kernel} call disagrees with the plain version ({err:.3e})")


def mean_err(got, ref):
    """mean |got - ref| over mean |ref|."""
    return float(np.abs(got - ref).mean() / max(np.abs(ref).mean(), 1e-12))


def read_planted(kernel, run, ref, bound, what, bad, stat=spread_err):
    """`run()` under each PLANTED fault in front of `kernel`, read against
    `ref` by `stat`; a reading at or below `bound` goes to `bad` (the bound
    would pass that fault)."""
    for name, fault in PLANTED.items():
        with planted(kernel, fault):
            out = run()
        err = stat(out, ref)
        print(f"{what}: planted fault, {kernel} {name}: {stat.__name__} {err:.3e} (bound "
              f"{bound:g}, must be above it); spread_err {spread_err(out, ref):.3e}, mean_err "
              f"{mean_err(out, ref):.3e}", flush=True)
        if not err > bound:
            bad.append(f"{what}: the bound passes a planted fault ({kernel}, {name}: {err:.3e})")


def stream_all(eng, ds):
    """stream_masks over the whole dataset -> (masks, metas, launch counts)."""
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = list(eng.stream_masks(ds))
    return (np.concatenate([m for m, _ in out]), [x for _, row in out for x in row],
            launch_counts())


def import_avs_census_model(cfg):
    """The AVS S4 census state dict through the port's import path:
    converter, key census (0 unexplained), `from_jax` onto the card."""
    from dg_sct_tpu_torch.utils import torch_convert as TC
    from dg_sct_tpu_torch.weights import from_jax

    t0 = time.perf_counter()
    sd = TC.track(census_state_dict(AVS_CENSUS))
    params, state, pvt = TC.convert_avs_model(sd)
    report = TC.census_report(sd, TC.AVS_CKPT_IGNORED_PATTERNS)
    if report["unexplained"] or pvt is None:
        raise AssertionError(f"avs census: unexplained keys {report['unexplained'][:10]}")
    params, state = from_jax(params, state, cfg, device="cuda")
    print(f"avs import: {len(sd)} keys of {AVS_CENSUS.name}: {len(report['consumed'])} "
          f"consumed (PVT-v2-b5 tower converted, bypassed), {len(report['ignored'])} ignored, "
          f"0 unexplained; on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    return params, state


def run_avs(device="cuda"):
    """Phase 8: the census-built full-width AVS model served through
    `stream_masks` from an on-disk tree (B=2, chunk=2, bf16), the float32
    engine with kernels against the plain one, clips/s in two wire formats,
    a profiled forward, and int8 towers (in float32 too, each K4 call held
    against its plain version)."""
    import tempfile

    from dg_sct_tpu_torch.configs import AVSModelConfig
    from dg_sct_tpu_torch.data.avs import S4Dataset
    from dg_sct_tpu_torch.models import avs
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVSInferenceEngine

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = AVSModelConfig()
    params, state = import_avs_census_model(cfg)
    eng = AVSInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device=device)
    T, S = cfg.num_frames, cfg.mask_size
    forwards = -(-CLIPS // BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_avs_") as tmp:
        videos = [(f"cat{i % 3}", f"v{i:03d}") for i in range(CLIPS)]
        root = write_avs_tree(Path(tmp), videos, cfg)
        ds = S4Dataset(str(root), "test", mask_num=T, img_size=S, num_frames=T,
                       segment_samples=cfg.htsat.frontend.clip_samples)
        disk = [ds[i] for i in range(len(ds))]  # decoded once; the checks below reuse them
    stream_all(eng, disk)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    masks, metas, counts = stream_all(eng, disk)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * forwards for k, v in AVS_PER_FORWARD.items()}
    if counts != want:
        raise AssertionError(f"avs: launch counts {counts}, expected {want}")
    if masks.shape != (CLIPS, T, S, S) or not np.isfinite(masks).all():
        raise AssertionError(f"avs: masks {masks.shape} or non-finite")
    if masks.min() < 0.0 or masks.max() > 1.0:
        raise AssertionError("avs: mask probabilities outside [0, 1]")
    if metas != sorted(videos):
        raise AssertionError(f"avs: metas {metas[:3]}... not in dataset order")
    print(f"avs serve: {CLIPS} clips from disk (PNG frames {S}x{S}, .npy waves {T}x"
          f"{cfg.htsat.frontend.clip_samples}) through stream_masks in {dt:.3f} s (B={BATCH}, "
          f"chunk 2, bf16): masks {masks.shape} finite in [{masks.min():.4f}, {masks.max():.4f}], "
          f"mean {masks.mean():.4f}; metas in dataset order; launches {counts} ({forwards} "
          f"forwards); peak memory {peak / 2**30:.3f} GiB; card "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # float32: the engine with kernels against the plain one on the same clips
    bad = []  # bound checks, fatal at the end of the phase once every reading is printed
    f32 = dict(batch_size=BATCH, chunk=2, device=device, compute_dtype=torch.float32)
    plain = AVSInferenceEngine(cfg, params, state, kernels=False, mask_u8=False, **f32)
    kern = AVSInferenceEngine(cfg, params, state, mask_u8=False, **f32)
    ref, _, _ = stream_all(plain, disk)
    k1_calls, k2_calls = [], []
    with side_by_side("window_attention", k1_calls), side_by_side("block_attention", k2_calls):
        got, _, counts = stream_all(kern, disk)
    if counts != want:
        raise AssertionError(f"avs f32: launch counts {counts}, expected {want}")
    report_calls("avs f32", "window_attention", k1_calls, bad)
    report_calls("avs f32", "block_attention", k2_calls, bad)
    near, _, _ = stream_all(plain, Nudged(disk, INT8_NUDGE, seed=21))
    err, sens = spread_err(got, ref), spread_err(near, ref)
    print(f"avs f32: kernels vs plain max |delta logit| / max |logit| {err:.3e} (bound "
          f"{AVS_F32_TOL:g}), max abs diff {np.abs(got - ref).max():.3e}, max |logit| "
          f"{np.abs(ref).max():.3e}; the plain path moves {sens:.3e} with frames and wave "
          f"changed by {INT8_NUDGE:g} (relative); launches {counts}", flush=True)
    if not np.isfinite(got).all() or err > AVS_F32_TOL:
        bad.append(f"avs f32: kernels and plain path disagree ({err:.3e})")
    read_planted("block_attention", lambda: stream_all(kern, disk)[0], ref, AVS_F32_TOL,
                 "avs f32", bad)
    u8, _, _ = stream_all(AVSInferenceEngine(cfg, params, state, **f32), disk)
    u8_err = np.abs(u8 - 1.0 / (1.0 + np.exp(-got.astype(np.float64)))).max()
    print(f"avs f32: mask_u8 against sigmoid(logits) max abs diff {u8_err:.6e} (bound "
          f"{MASK_U8_TOL:.6e})", flush=True)
    if u8_err > MASK_U8_TOL:
        bad.append(f"avs: mask_u8 off sigmoid(logits) by {u8_err:.3e}")
    del plain, kern, ref, got, near, u8

    # clips/s in two wire formats, and a profiled forward
    clips = Clips(AVS_STREAM_CLIPS, cfg, seed=13, size=S, named=True)
    s4 = [disk[i % CLIPS] for i in range(AVS_STREAM_CLIPS)]  # S4Dataset's items, in memory
    formats = (("uint8 frames, int16 wave", clips),
               ("S4Dataset's float32 normalized frames and float32 wave", s4))
    for fmt, data in formats:
        staged = BATCH * sum(data[0][k].nbytes for k in ("wave", "image"))
        for rnd in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream_all(eng, data)
            dt = time.perf_counter() - t0
            print(f"avs stream: {fmt} ({staged / 1e6:.3f} MB host to device a forward): run "
                  f"{rnd}: {AVS_STREAM_CLIPS} clips in {dt:.3f} s = {AVS_STREAM_CLIPS / dt:.3f} "
                  f"clips/s (B={BATCH}, chunk 2, bf16, uint8 masks)", flush=True)
    one = clips[0]
    wave = np.stack([one["wave"]] * BATCH)
    frames = np.stack([one["image"]] * BATCH)
    eng.forward_batch(wave, frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profile_run(lambda: eng.forward_batch(wave, frames), f"one AVS forward of {BATCH} clips",
                "avs profile", op_group=avs_op_group)
    print(f"avs profile: peak memory of the profiled forward "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    # int8 towers with scales calibrated on a seeded batch
    rs = np.random.RandomState(7)
    cw = torch.as_tensor((rs.randn(BATCH, T, cfg.htsat.frontend.clip_samples) * 0.1).astype(
        np.float32), device=device).to(torch.bfloat16)
    ci = torch.as_tensor(rs.rand(BATCH, T, S, S, 3).astype(np.float32), device=device).to(
        torch.bfloat16)
    t0 = time.perf_counter()
    scales = quant.calibrate_avs(eng.params, eng.state, eng.cfg, cw, ci, gelu=eng.gelu,
                                 device=device)
    print(f"avs int8: calibrated {len(scales)} activation scales in "
          f"{time.perf_counter() - t0:.3f} s (one plain bf16 forward of {BATCH} clips)",
          flush=True)
    del eng
    q8 = AVSInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device=device,
                            int8_towers=True, act_scales=scales)
    q_masks, _, counts = stream_all(q8, disk)
    want = {k: v * forwards for k, v in AVS_INT8_PER_FORWARD.items()}
    if counts != want or not np.isfinite(q_masks).all():
        raise AssertionError(f"avs int8: launches {counts} (expected {want}) or non-finite")
    agree = float(((q_masks > 0.5) == (masks > 0.5)).mean())
    print(f"avs int8: launches {counts} ({forwards} forwards); drift against bf16 over "
          f"{CLIPS} clips: max |delta prob| {np.abs(q_masks - masks).max():.4f}, mean "
          f"{np.abs(q_masks - masks).mean():.5f}; mask pixels agreeing at 0.5: "
          f"{100.0 * agree:.3f}%", flush=True)
    del q8

    # float32: the int8-towers forward with kernels against the int8 plain one
    fp, fs = fold_adapters_eval(params, state, cfg)
    qp = quant.quantize_eval_params(fp, towers=AVS_INT8_TOWERS, act_scales=scales)
    del params, state
    frames = torch.as_tensor(np.stack([d["image"] for d in disk[:BATCH]]), device=device)
    wave = torch.as_tensor(np.stack([d["wave"] for d in disk[:BATCH]]), device=device)
    gen = torch.Generator(device).manual_seed(3)
    nudge = lambda t: t * (1.0 + INT8_NUDGE * torch.randn(t.shape, device=device, generator=gen))

    def fwd(p, w, f, kernels):
        with torch.inference_mode():
            out = avs.forward(p, fs, f, w, cfg, kernels=kernels, device=device)
        return out["pred"].float().cpu().numpy()

    reset_launch_counts()
    k1_calls = []
    with side_by_side("window_attention", k1_calls):
        got = fwd(qp, wave, frames, True)
    counts = launch_counts()
    report_calls("avs int8 f32", "window_attention", k1_calls, bad)
    if counts != AVS_INT8_PER_FORWARD:
        raise AssertionError(f"avs int8 f32: launches {counts}, expected {AVS_INT8_PER_FORWARD}")
    ref = fwd(qp, wave, frames, False)
    near = [fwd(qp, nudge(wave), nudge(frames), False) for _ in range(2)]
    flt = fwd(fp, wave, frames, False)
    calls, kerr = check_int8_calls(
        qp, AVS_INT8_TOWERS,
        lambda t: avs.forward(t, fs, frames, wave, cfg, kernels=True, device=device),
        "avs int8 f32")
    print(f"avs int8 f32: each of the {calls} K4 calls of a forward against the plain version "
          f"on its own input: max abs err {kerr:.3e} (atol/rtol {TOL[torch.float32]})",
          flush=True)
    err = mean_err(got, ref)
    print(f"avs int8 f32: {BATCH} clips, kernels vs plain mean |delta logit| / mean |logit| "
          f"{err:.3e} (bound {AVS_INT8_TOL:g}; max |delta| / max |logit| "
          f"{spread_err(got, ref):.3e}); the plain path moves "
          f"{', '.join(f'{mean_err(n, ref):.3e} ({spread_err(n, ref):.3e})' for n in near)} "
          f"with wave and frames changed by {INT8_NUDGE:g} (relative, two draws); int8 "
          f"against float (plain, f32) {mean_err(ref, flt):.3e} "
          f"({spread_err(ref, flt):.3e}); launches {counts}", flush=True)
    if not np.isfinite(got).all() or err > AVS_INT8_TOL:
        bad.append(f"avs int8 f32: kernels and plain path disagree ({err:.3e})")
    read_planted("window_attention", lambda: fwd(qp, wave, frames, True), ref, AVS_INT8_TOL,
                 "avs int8 f32", bad, stat=mean_err)
    del fp, fs, qp
    torch.cuda.empty_cache()
    print(f"avs: phase 8 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", action="append", choices=sorted(SOURCES) + ["avs"],
                    help="check and time only this kernel (repeatable), or run only phase "
                         "8 (avs); skips the other phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dg_sct_tpu_torch.configs import AVEModelConfig
    from dg_sct_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s "
          f"({build.build_dir()})", flush=True)
    for name in libs:
        entry = "?"
        for line in (build.build_dir() / f"{name}.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "Used" in line or "spill" in line:
                print(f"ptxas {name} {entry[:100]}: {line.strip()}")

    cfg = AVEModelConfig()
    rows = check_kernels(cfg, args.only)
    if args.only:
        if "avs" in args.only:
            run_avs()
        print(json.dumps(kernels_line(rows, {name: None for name in SOURCES})))
        print(card)
        print(f"partial run ({', '.join(args.only)}): no ok line", flush=True)
        return 0
    counts = run_model(cfg)
    run_serving(cfg)
    t0 = time.perf_counter()
    run_training(cfg)
    print(f"train: phase 6 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    int8_counts = run_int8(cfg)
    print(f"int8: phase 7 in {time.perf_counter() - t0:.1f} s", flush=True)
    counts["int8_linear"] = int8_counts["int8_linear"]  # K4's main path is phase 7
    run_avs()
    print(json.dumps(kernels_line(rows, counts)))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
