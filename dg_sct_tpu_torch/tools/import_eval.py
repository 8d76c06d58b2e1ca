"""One command: import a DG-SCT AVE, AVS, AVVP or AVQA checkpoint into the
port, and score AVE.

    python -m dg_sct_tpu_torch.tools.import_eval \\
        --ave-ckpt /path/to/best_82.18.pt \\
        --meta /path/to/AVE --frames /path/to/frames --audio /path/to/audio \\
        [--htsat-ckpt /path/to/HTSAT_AudioSet_Saved_1.ckpt] \\
        [--save converted.npz] [--census-only] [--split test] [--device cuda]

Steps:
  1. `torch.load` the MMIL_Net state dict (`best_82.18.pt`, saved at
     `DG-SCT/AVE/main_trans.py:298`) and convert it with
     `utils.torch_convert.convert_ave_model`;
  2. key census: every checkpoint key is consumed or matches
     `AVE_CKPT_IGNORED_PATTERNS`; unexplained keys exit with code 2
     (`--lax`: a warning);
  3. `--htsat-ckpt` overlays the audio tower with the pre-finetune weights
     (`sed_model.` stripped, as `net_trans.py:740-743` loads them);
  4. shape audit: `weights.from_jax` against the port's tree at
     `AVEModelConfig()`; a missing, extra or misshapen leaf exits with 3;
  5. `--save` writes the converted tree as an npz bundle {"params", "state"}
     that both packages read;
  6. unless `--census-only`: the split through the engine's `predict_clips`
     in float32 with exact GELU and float32 frames, and the accuracy, the
     per-clip-weighted mean of `train.metrics.ave_accuracy`, beside 82.18.

`--census-only` audits shapes on the "meta" device and needs no card; the
eval runs on `--device` (default: the card).

`--task avs` (the AVS S4 `Pred_endecoder`, `S4_pvt_best.pth`) does what the
JAX tool does for it: the census against `AVS_CKPT_IGNORED_PATTERNS` (exit 2),
the shape audit through `from_jax` at `AVSModelConfig()` on the "meta"
device (exit 3), and `--save` (the bundle adds "pvt_backbone", the bypassed
PVT-v2-b5 tower, where the checkpoint has it); it scores no metric.
`--task avvp` (the AVVP `MGN_Net`, `MGN_Net.pt`) likewise: the census
against `AVVP_CKPT_IGNORED_PATTERNS` (exit 2), the shape audit at
`AVVPModelConfig()` (exit 3) and `--save`; no metric. `--task avqa` (the
stage-2 `AVQA_Fusion_Net`, `avst_best.pt`, adapters of 4 channel groups) and
`--task avqa_grounding` (the stage-1 `AVQA_AVatt_Grounding`,
`lavish_grounding_gen_best.pt`) likewise, against
`AVQA_CKPT_IGNORED_PATTERNS` and `AVQA_GROUNDING_CKPT_IGNORED_PATTERNS`, the
shapes at `AVQAModelConfig()`. As in the JAX tool, the converter runs before
the census, so a checkpoint of another family stops at its first missing
key (KeyError).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..configs import (AVEModelConfig, AVQAModelConfig, AVSModelConfig, AVVPModelConfig,
                       ave_adapter_dims)
from ..data.ave import AVEDataset
from ..serve import AVEInferenceEngine
from ..train.metrics import ave_accuracy
from ..utils import checkpoint as ckpt_lib
from ..utils import torch_convert as TC
from ..weights import from_jax

REFERENCE_ACC = 82.18


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="ave",
                   choices=("ave", "avvp", "avs", "avqa", "avqa_grounding"),
                   help="checkpoint family")
    p.add_argument("--ave-ckpt", "--ckpt", required=True, dest="ckpt", metavar="CKPT",
                   help="the trained checkpoint (best_82.18.pt, S4_pvt_best.pth with "
                        "--task avs, MGN_Net.pt with --task avvp, avst_best.pt with --task "
                        "avqa, lavish_grounding_gen_best.pt with --task avqa_grounding)")
    p.add_argument("--htsat-ckpt", default=None,
                   help="HTSAT_AudioSet_Saved_1.ckpt (overlays the frozen audio tower "
                        "with pre-finetune weights)")
    p.add_argument("--meta", default=None, help="AVE annotations root")
    p.add_argument("--frames", default=None)
    p.add_argument("--audio", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--save", default=None, help="write the converted npz")
    p.add_argument("--census-only", action="store_true",
                   help="stop after the key census and the shape audit (no data, no card)")
    p.add_argument("--lax", action="store_true",
                   help="warn instead of fail on unexplained keys")
    p.add_argument("--device", default=None, help="eval device (default: the card)")
    return p.parse_args(argv)


def _census(sd, what, lax, out, ignored=TC.AVE_CKPT_IGNORED_PATTERNS):
    out = out or sys.stdout
    report = TC.census_report(sd, ignored)
    print(f"{what}: {len(report['consumed'])} consumed, {len(report['ignored'])} ignored "
          f"(documented), {len(report['unexplained'])} UNEXPLAINED", file=out)
    for k in report["unexplained"][:20]:
        print(f"  unexplained: {k}", file=out)
    if report["unexplained"] and not lax:
        raise SystemExit(2)
    return report


def import_ave_checkpoint(ave_ckpt: str, htsat_ckpt: str | None = None,
                          cfg: AVEModelConfig | None = None, lax=False, out=None):
    """-> (params, state, report): the converted numpy tree and the census
    of `ave_ckpt`. Raises SystemExit(2) on unexplained keys unless `lax`."""
    cfg = cfg or AVEModelConfig()
    sd = TC.track(TC.load_torch_file(ave_ckpt))
    n_adapters = len(ave_adapter_dims(cfg.swin, cfg.htsat))
    params, state = TC.convert_ave_model(sd, n_adapters, cfg.adapter.num_conv_group)
    report = _census(sd, "census", lax, out)
    if htsat_ckpt:
        hsd = TC.track(TC.strip_prefix(TC.load_torch_file(htsat_ckpt), "sed_model."))
        params["htsat"], state["htsat"] = TC.convert_htsat(hsd)
        _census(hsd, "htsat census", lax, out)
    return params, state, report


def import_avs_checkpoint(ckpt: str, cfg: AVSModelConfig | None = None, lax=False, out=None):
    """-> (params, state, pvt, report): the converted numpy tree, the
    bypassed PVT-v2-b5 tree (or None) and the census of `ckpt`. Raises
    SystemExit(2) on unexplained keys unless `lax`."""
    cfg = cfg or AVSModelConfig()
    sd = TC.track(TC.load_torch_file(ckpt))
    n_adapters = len(ave_adapter_dims(cfg.swin, cfg.htsat))
    params, state, pvt = TC.convert_avs_model(sd, n_adapters, cfg.adapter.num_conv_group,
                                              cfg.tpavi_stages)
    report = _census(sd, "census", lax, out, TC.AVS_CKPT_IGNORED_PATTERNS)
    return params, state, pvt, report


def import_avvp_checkpoint(ckpt: str, cfg: AVVPModelConfig | None = None, lax=False, out=None):
    """-> (params, state, report): the converted numpy tree and the census of
    `ckpt`. Raises SystemExit(2) on unexplained keys unless `lax`."""
    cfg = cfg or AVVPModelConfig()
    sd = TC.track(TC.load_torch_file(ckpt))
    n_adapters = len(ave_adapter_dims(cfg.swin, cfg.htsat))
    params, state = TC.convert_avvp_model(sd, n_adapters, cfg.adapter.num_conv_group,
                                          (cfg.depth_aud, cfg.depth_vis, cfg.depth_av))
    report = _census(sd, "census", lax, out, TC.AVVP_CKPT_IGNORED_PATTERNS)
    return params, state, report


def import_avqa_checkpoint(ckpt: str, cfg: AVQAModelConfig | None = None, *, grounding=False,
                           lax=False, out=None):
    """-> (params, state, report): the converted numpy tree of an AVQA stage-2
    checkpoint (or, with `grounding`, of a stage-1 one) and its census.
    Raises SystemExit(2) on unexplained keys unless `lax`."""
    cfg = cfg or AVQAModelConfig()
    sd = TC.track(TC.load_torch_file(ckpt))
    if grounding:
        params, state = TC.convert_avqa_grounding(sd)
        ignored = TC.AVQA_GROUNDING_CKPT_IGNORED_PATTERNS
    else:
        params, state = TC.convert_avqa_fusion(sd, len(ave_adapter_dims(cfg.swin, cfg.htsat)),
                                               cfg.adapter.num_conv_group)
        ignored = TC.AVQA_CKPT_IGNORED_PATTERNS
    report = _census(sd, "census", lax, out, ignored)
    return params, state, report


def _audit(params, state, cfg, device, **kw):
    """The shape audit: the converted tree through `from_jax` (`kw`: its
    `grounding`); exit 3 on a missing, extra or misshapen leaf."""
    try:
        tree = from_jax(params, state, cfg, device=device, **kw)
    except ValueError as e:
        print(f"shape audit: {e}")
        raise SystemExit(3) from e
    print("shape audit: OK (converted tree == the port's tree)")
    return tree


def _save(path, bundle):
    if path:
        ckpt_lib.save_params(path, bundle)
        print(f"saved converted checkpoint -> {path}")


def main(argv=None,
         cfg: AVEModelConfig | AVSModelConfig | AVVPModelConfig | AVQAModelConfig | None = None):
    """Runs the steps above; returns the accuracy in % when it scored a
    split, else None."""
    args = parse_args(argv)
    if args.task == "avs":
        params, state, pvt, _ = import_avs_checkpoint(args.ckpt, cfg, lax=args.lax)
        _audit(params, state, cfg or AVSModelConfig(), "meta")
        _save(args.save, {"params": params, "state": state,
                          **({} if pvt is None else {"pvt_backbone": pvt})})
        return None
    if args.task == "avvp":
        params, state, _ = import_avvp_checkpoint(args.ckpt, cfg, lax=args.lax)
        _audit(params, state, cfg or AVVPModelConfig(), "meta")
        _save(args.save, {"params": params, "state": state})
        return None
    if args.task in ("avqa", "avqa_grounding"):
        grounding = args.task == "avqa_grounding"
        params, state, _ = import_avqa_checkpoint(args.ckpt, cfg, grounding=grounding,
                                                  lax=args.lax)
        _audit(params, state, cfg or AVQAModelConfig(), "meta", grounding=grounding)
        _save(args.save, {"params": params, "state": state})
        return None
    cfg = cfg or AVEModelConfig()
    params, state, _ = import_ave_checkpoint(args.ckpt, args.htsat_ckpt, cfg, lax=args.lax)
    params_t, state_t = _audit(params, state, cfg,
                               "meta" if args.census_only else args.device)
    _save(args.save, {"params": params, "state": state})
    if args.census_only:
        return None
    if not args.meta:
        print("no --meta given: stopping after import (pass --census-only to silence this)")
        return None
    del params, state
    ds = AVEDataset(args.meta, args.split, frame_dir=args.frames, audio_dir=args.audio,
                    img_size=cfg.swin.img_size, num_frames=cfg.num_frames,
                    segment_samples=cfg.htsat.frontend.clip_samples)
    eng = AVEInferenceEngine(cfg, params_t, state_t, batch_size=args.batch_size,
                             device=params_t["swin"]["norm"]["scale"].device,
                             compute_dtype=torch.float32, gelu="exact")
    ev, ie, _ = eng.predict_clips(ds)
    gt = np.stack([ds.label(i) for i in range(len(ds))])
    acc = ave_accuracy(ie, ev, gt)
    print(f"AVE {args.split} accuracy: {acc:.2f}%  (reference best_82.18.pt: "
          f"{REFERENCE_ACC:.2f}%, delta {acc - REFERENCE_ACC:+.2f})")
    return acc


if __name__ == "__main__":
    main()
