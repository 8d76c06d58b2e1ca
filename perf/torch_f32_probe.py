#!/usr/bin/env python3
"""Capture adapter calls of the port's full-width AVE float64 train step.

    python3 perf/torch_f32_probe.py --capture 46 47 --piece K [--out-dir DIR]
    python3 perf/torch_f32_probe.py --capture 46 47 --f32-grads [--out-dir DIR]

On one CUDA card (PyTorch only, no JAX). The step is `chip_smoke.py`'s phase-18
one-process reference (`par_dp_step`): `AVEModelConfig()` from seed 0 with its
seeded adapter gates, the global batch of 4 clips with mixup lambdas, no
draws, remat "full", in float64, its loss differentiated (no optimizer).
For each adapter call named by `--capture` (counted in forward order; 46 and
47 are the last paired step's `a_p2` and `v_p2`, whose maps pool the towers
for the heads) it keeps, in float64, the call's inputs x and other, its
parameters and BN state, and the gradients that flow into its two outputs
(residual and maps). Parameters come from float32 weights and are stored in
float32 where that is exact; a tensor that two calls share (`a_p2`'s x is
`v_p2`'s other) is stored once.

Everything together is more than one chip call may bring back, so the
arrays are packed, in a fixed order, into pieces of at most PIECE_MIB each;
`--piece K` writes piece K (`capture_piece{K}.npz`) and the manifest
(`capture.json`: which array is which call's what, the adapter
configuration, each input's per-token |mean| / std). Run once a piece (the
manifest says how many there are) into one directory, then hold the
captured calls in both packages on the CPU with `perf/f32_adapter_vjp.py`.
`--f32-grads` runs the same step in float32 instead and keeps only the
captured calls' output gradients, so that the CPU script can carry the
float32 step's own error in them back through each package's VJP.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

PIECE_MIB = 48


def token_ratio(x):
    """Per token (a row over the channels): |mean| / std, as (median, max)."""
    x = x.double().reshape(-1, x.shape[-1])
    r = x.mean(-1).abs() / x.std(-1, correction=0)
    return float(r.median()), float(r.max())


def capture_step(cfg, device, wanted, dtype=torch.float64):
    """The step in `dtype` with adapter calls `wanted` recorded -> ({call:
    record}, loss, adapter calls). A record holds x, other, params, state
    (tensors) and the output gradients g_res, g_maps."""
    from dg_sct_tpu_torch.models import adapter as A
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.train import ave_train, losses
    from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    params, state = (tree_map(cast, t) for t in CS.seeded_model(cfg, device=device))
    tr, fr = ave_train.partition_params(params)
    batch = {k: cast(torch.as_tensor(v, device=device)) for k, v in CS.par_dp_batch(cfg).items()}
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tr)]
    merged = ave_train.merge_params(tree_unflatten(tr, leaves), fr)

    records, outputs, calls, recording = {}, [], [0], [True]
    adapter = A.adapter

    def recorded(params, state, x, other, acfg, **kw):
        res, maps, st = adapter(params, state, x, other, acfg, **kw)
        if recording[0]:  # not the checkpointed steps' recompute in the backward
            n = calls[0]
            calls[0] += 1
            if n in wanted:
                detach = lambda tree: tree_map(lambda t: t.detach(), tree)
                records[n] = dict(x=x.detach(), other=other.detach(), params=detach(params),
                                  state=detach(state), cfg=dataclasses.asdict(acfg),
                                  kw={k: v for k, v in kw.items() if k in ("train", "kernels")})
                outputs.append((n, res, maps))
        return res, maps, st

    A.adapter = recorded
    try:
        out, _ = ave.forward(merged, tree_map(cast, state), batch["wave"], batch["image"],
                             dataclasses.replace(cfg, compute_dtype=dtype), train=True,
                             device=device, gen=None, mixup_lambda=batch["mixup_lambda"],
                             remat_policy="full")
        loss = losses.ave_loss(out, batch["gt"])
        recording[0] = False
        missing = set(wanted) - set(records)
        if missing:
            raise ValueError(f"adapter calls {sorted(missing)} not made ({calls[0]} calls)")
        outs = [t for _, r, m in outputs for t in (r, m)]
        grads = torch.autograd.grad(loss, outs, allow_unused=True)  # a p1 call's maps are unused
    finally:
        A.adapter = adapter
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(outs, grads)]
    for i, (n, _, _) in enumerate(outputs):
        records[n]["g_res"], records[n]["g_maps"] = grads[2 * i], grads[2 * i + 1]
    return records, loss.item(), calls[0]


def flatten(records):
    """-> ({array name: numpy array}, {call: {field: array name}}): each
    distinct tensor once; parameters and state in float32 where exact."""
    from dg_sct_tpu_torch.utils.tree import tree_paths

    arrays, seen, index = {}, {}, {}
    for n, rec in sorted(records.items()):
        fields = {}
        items = [(f, rec[f]) for f in ("x", "other", "g_res", "g_maps")]
        for part in ("params", "state"):
            items += [(f"{part}/" + "/".join(map(str, p)), t) for p, t in tree_paths(rec[part])]
        for field, t in items:
            key = (t.data_ptr(), tuple(t.shape), t.dtype)
            if key not in seen:
                a = t.cpu().numpy()
                if a.dtype == np.float64 and np.array_equal(a.astype(np.float32), a):
                    a = a.astype(np.float32)
                seen[key] = name = f"a{len(arrays)}"
                arrays[name] = a
            fields[field] = seen[key]
        index[n] = fields
    return arrays, index


def pieces(arrays):
    """Array names packed largest first into pieces of at most PIECE_MIB."""
    cap = PIECE_MIB * 2 ** 20
    out = []
    for name in sorted(arrays, key=lambda k: (-arrays[k].nbytes, k)):
        size = arrays[name].nbytes
        for p in out:
            if p[0] + size <= cap:
                p[0] += size
                p[1].append(name)
                break
        else:
            out.append([size, [name]])
    return [names for _, names in out]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--capture", type=int, nargs="+", required=True,
                    help="adapter calls to capture, in forward order (46 47: the last pair's p2)")
    ap.add_argument("--piece", type=int, help="which piece of the float64 capture to write")
    ap.add_argument("--f32-grads", action="store_true",
                    help="instead, run the step in float32 and write only the captured calls' "
                         "output gradients (capture_f32_grads.npz): the error that arrives with them")
    ap.add_argument("--out-dir", default="perf/torch_probe_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    from dg_sct_tpu_torch.configs import AVEModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    t0 = time.perf_counter()
    if args.f32_grads:
        records, loss, _ = capture_step(AVEModelConfig(), torch.device("cuda", 0),
                                        set(args.capture), torch.float32)
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.savez(out / "capture_f32_grads.npz",
                 **{f"{n}/{f}": r[f].cpu().numpy() for n, r in records.items()
                    for f in ("g_res", "g_maps")})
        print(f"f32 capture: {card}; float32 step, loss {loss:.9f}, {time.perf_counter() - t0:.1f}"
              f" s; output gradients of calls {sorted(records)} -> {out}", flush=True)
        return 0
    if args.piece is None:
        ap.error("--piece or --f32-grads")
    records, loss, ncalls = capture_step(AVEModelConfig(), torch.device("cuda", 0),
                                         set(args.capture))
    wrote = write_piece(records, dict(card=card, loss_f64=loss, adapter_calls=ncalls,
                                      batch=CS.PAR_BATCH), Path(args.out_dir), args.piece)
    if wrote is None:
        return 2
    names, npieces, mib = wrote
    print(f"f32 capture: {card}; float64 step, B={CS.PAR_BATCH}, no draws, remat full, loss "
          f"{loss:.12f}, {ncalls} adapter calls, {time.perf_counter() - t0:.1f} s; piece "
          f"{args.piece} of {npieces}: {len(names)} arrays, {mib:.1f} MiB -> {args.out_dir}",
          flush=True)
    for n in sorted(records):
        r = {f: token_ratio(records[n][f]) for f in ("x", "other")}
        print(f"f32 capture: adapter call {n}: x {tuple(records[n]['x'].shape)}, other "
              f"{tuple(records[n]['other'].shape)}; per-token |mean| / std (median, max): x "
              f"{r['x'][0]:.3f}, {r['x'][1]:.3f}; other {r['other'][0]:.3f}, {r['other'][1]:.3f}",
              flush=True)
    return 0


def write_piece(records, meta, out, piece):
    """The manifest and piece `piece` of the records into `out` -> (its array
    names, the number of pieces, MiB), or None if there is no such piece."""
    arrays, index = flatten(records)
    packed = pieces(arrays)
    if not 0 <= piece < len(packed):
        print(f"torch_f32_probe: piece {piece} of {len(packed)}", file=sys.stderr)
        return None
    out.mkdir(parents=True, exist_ok=True)
    manifest = dict(meta, calls={str(n): dict(
        fields=index[n], cfg=records[n]["cfg"], kw=records[n]["kw"],
        token_mean_over_std={f: token_ratio(records[n][f]) for f in ("x", "other")})
        for n in records},
        pieces=packed, dtypes={k: str(a.dtype) for k, a in arrays.items()},
        shapes={k: list(a.shape) for k, a in arrays.items()})
    (out / "capture.json").write_text(json.dumps(manifest, indent=1))
    names = packed[piece]
    np.savez(out / f"capture_piece{piece}.npz", **{k: arrays[k] for k in names})
    return names, len(packed), sum(arrays[k].nbytes for k in names) / 2 ** 20


if __name__ == "__main__":
    sys.exit(main())
