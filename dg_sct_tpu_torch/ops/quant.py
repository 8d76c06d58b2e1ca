"""Int8 serving of the AVE and AVS models: static per-column int8 weights,
symmetric int8 activations, int32 sums (`dg_sct_tpu/ops/quant.py`, AVE and
AVS parts).

  * weights: per-output-column absmax scales, quantized once at load
    (`quantize_linear`, `quantize_tree`, `quantize_eval_params`);
  * activations: a static scale per linear from calibration
    (`calibrate_ave`, "ascale"), or dynamic per-row absmax scales;
  * `linear_int8`: clip(rint(x / ascale), +-127) . W_q in int32, then
    * (ascale * kscale) + bias in float32, cast to x's type. On the card
    with `kernels` it runs as K4 (`ops/kernels/int8_linear.py`).

`ops.basic.linear` dispatches on "kernel_q", so every call site picks the
path up. Only linears with min(in, out) >= `min_dim` are quantized.

The qids of a walk tie calibration scales to layers and must be the JAX
package's: the towers in the order asked at the top, then, below, dict keys
sorted (JAX rebuilds its dicts key-sorted) and list items in order.
Calibration records through the tagged tree itself (`attach_qtags` hangs a
`QTag` on each eligible linear, which `linear` calls), with nothing patched.
"""
from __future__ import annotations

import json

import torch

from .kernels.int8_linear import div_exact, int8_linear, linear_int8_plain

SYM_CLIP = 127.0


def quantize_linear(p, *, sym_clip=SYM_CLIP):
    """{"kernel": (I, O), "bias"?} -> {"kernel_q": int8 (I, O), "kscale":
    float32 (O,), "bias"?}. kernel_q is a (I, O) view of an (O, I) contiguous
    tensor, the layout K4 reads; its values are JAX's."""
    w = p["kernel"].to(torch.float32)
    kscale = div_exact(torch.clamp(w.abs().amax(0), min=1e-8), sym_clip)
    wq = torch.clamp(torch.round(w / kscale[None, :]), -sym_clip, sym_clip).to(torch.int8)
    out = {"kernel_q": wq.t().contiguous().t(), "kscale": kscale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def linear_int8(p, x, *, kernels=True):
    """Int8 linear: x (..., I) -> (..., O) in x's type. A static "ascale" (a
    float32 scalar) if the dict has one, else dynamic per-row scales over
    the last axis. `kernels`: K4 (its plain version on a CPU tensor)."""
    lead, K = x.shape[:-1], x.shape[-1]
    fn = int8_linear if kernels else linear_int8_plain
    y = fn(x.reshape(-1, K), p["kernel_q"], p["kscale"], p.get("ascale"), p.get("bias"))
    return y.reshape(lead + (y.shape[-1],))


# ---------------------------------------------------------------------------
# the walk over eligible linears
# ---------------------------------------------------------------------------

def _walk_eligible(tree, visit, *, min_dim, skip_keys=()):
    """Depth-first walk; every linear-like dict (plain or quantized) whose 2-D
    kernel has min(shape) >= min_dim becomes `visit(node, qid)`, qids in walk
    order. The top level is walked in its own order (the towers asked for),
    every dict below in sorted key order, as the JAX package's key-sorted
    trees are; the result keeps each dict's own key order."""
    counter = [0]

    def go(node, key=None, top=False):
        if key in skip_keys:
            return node
        if isinstance(node, dict) and ("kernel" in node or "kernel_q" in node):
            k = node.get("kernel", node.get("kernel_q"))
            if getattr(k, "ndim", 0) == 2 and min(k.shape) >= min_dim:
                qid = counter[0]
                counter[0] += 1
                return visit(node, qid)
            return node
        if isinstance(node, dict):
            done = {kk: go(node[kk], kk) for kk in (node if top else sorted(node))}
            return {kk: done[kk] for kk in node}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return node

    return go(tree, top=True)


def _ordered_towers(params, towers):
    return {t: params[t] for t in towers if t in params}


def quantize_tree(tree, *, min_dim=192, skip_keys=(), act_scales=None):
    """Every eligible linear quantized; with `act_scales` ({qid: activation
    absmax}) a static float32 "ascale" = absmax / 127 is baked in."""
    def visit(node, qid):
        if "kernel_q" in node:  # already quantized: only refresh ascale
            q = dict(node)
        else:
            q = quantize_linear(node)
            q.update({k: v for k, v in node.items() if k not in ("kernel", "bias")})
        if act_scales is not None and qid in act_scales:
            dev = q["kernel_q"].device
            q["ascale"] = torch.tensor(max(act_scales[qid], 1e-8) / SYM_CLIP,
                                       dtype=torch.float32, device=dev)
        return q

    return _walk_eligible(tree, visit, min_dim=min_dim, skip_keys=skip_keys)


def eligible_linears(tree, *, min_dim=192, skip_keys=()):
    """{qid: linear dict} of every eligible linear, in walk order."""
    nodes = {}

    def visit(node, qid):
        nodes[qid] = node
        return node

    _walk_eligible(tree, visit, min_dim=min_dim, skip_keys=skip_keys)
    return nodes


def qid_shape_map(tree, *, min_dim=192, skip_keys=()):
    """{qid: (in_dim, out_dim)} of every eligible linear: the fingerprint of a
    calibration-scale file."""
    return {qid: tuple(int(d) for d in node.get("kernel", node.get("kernel_q")).shape)
            for qid, node in eligible_linears(tree, min_dim=min_dim,
                                              skip_keys=skip_keys).items()}


def save_scales(path, scales, shapes):
    """Write a calibration-scale file with its qid -> shape fingerprint."""
    with open(path, "w") as f:
        json.dump({"scales": {str(k): v for k, v in scales.items()},
                   "shapes": {str(k): list(v) for k, v in shapes.items()}}, f)


def load_scales(path, expect_shapes=None):
    """{qid: absmax} of a scale file, or None if its fingerprint differs from
    `expect_shapes` (stale: recalibrate). A legacy flat {qid: absmax} file is
    checked by its count of qids only."""
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, dict) and "scales" in raw:
        if expect_shapes is not None:
            got = {int(k): tuple(v) for k, v in raw["shapes"].items()}
            if got != dict(expect_shapes):
                return None
        return {int(k): v for k, v in raw["scales"].items()}
    if expect_shapes is not None and len(raw) != len(expect_shapes):
        return None
    return {int(k): v for k, v in raw.items()}


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

class Recorder:
    """(qid, absmax of the input) of each call of a tagged linear, the absmax
    kept on the device until `scales` fetches them all at once."""

    def __init__(self):
        self.calls = []

    def record(self, qid, x):
        self.calls.append((qid, x.detach().abs().amax().to(torch.float32)))

    def scales(self) -> dict:
        """{qid: the largest absmax recorded for it}."""
        if not self.calls:
            return {}
        vals = torch.stack([a for _, a in self.calls]).cpu().tolist()
        out = {}
        for (q, _), a in zip(self.calls, vals):
            out[q] = max(out.get(q, 0.0), a)
        return out


class QTag:
    """Hung on a tagged linear under "qtag"; `ops.basic.linear` calls it with
    the linear's input."""

    def __init__(self, qid, recorder):
        self.qid, self.recorder = qid, recorder

    def __call__(self, x):
        self.recorder.record(self.qid, x)


def attach_qtags(tree, *, recorder, min_dim=192, skip_keys=()):
    """A copy of `tree` with a `QTag(qid, recorder)` in every eligible linear."""
    return _walk_eligible(tree, lambda node, qid: {**node, "qtag": QTag(qid, recorder)},
                          min_dim=min_dim, skip_keys=skip_keys)


def _calibrate(params, towers, min_dim, run):
    """Tag every eligible linear of `towers`, `run(tagged params)` once in
    inference mode -> {qid: activation absmax}."""
    recorder = Recorder()
    tagged = dict(params)
    tagged.update(attach_qtags(_ordered_towers(params, towers), recorder=recorder,
                               min_dim=min_dim))
    with torch.inference_mode():
        run(tagged)
        return recorder.scales()


def calibrate_ave(params, state, cfg, wave, images, *, towers=("swin", "htsat"), min_dim=192,
                  gelu="exact", device=None):
    """One-shot activation calibration of the AVE eval forward: tag every
    eligible linear of `towers`, run the forward once on (wave, images) and
    return {qid: activation absmax}. The forward runs the plain path (no
    kernel), as the JAX package calibrates through XLA: K2 would consume its
    blocks' qkv and proj without calling `linear`. With "adapters" in
    `towers`, the adapters' qids follow the towers', so a towers-only scale
    file stays a valid prefix. `gelu` and `device` as `models.ave.forward`
    takes them."""
    from ..models import ave

    return _calibrate(params, towers, min_dim, lambda p: ave.forward(
        p, state, wave, images, cfg, train=False, kernels=False, gelu=gelu, device=device))


def calibrate_avs(params, state, cfg, wave, images, *, towers=("swin", "htsat"), min_dim=192,
                  gelu="exact", device=None):
    """`calibrate_ave` for the AVS eval forward (`models.avs.forward`, which
    takes images before wave)."""
    from ..models import avs

    return _calibrate(params, towers, min_dim, lambda p: avs.forward(
        p, state, images, wave, cfg, kernels=False, gelu=gelu, device=device))


def quantize_eval_params(params, *, towers=("swin", "htsat"), min_dim=192, act_scales=None):
    """A full AVE or AVS param tree with the eligible linears of `towers`
    quantized (heads stay float). Run it after `fold_adapters_eval` and after
    the cast to the serving type. With `act_scales` from `calibrate_ave` (or
    `calibrate_avs`), the activations take static scales."""
    out = dict(params)
    out.update(quantize_tree(_ordered_towers(params, towers), min_dim=min_dim,
                             act_scales=act_scales))
    return out
