"""AVVP training and evaluation entry point on one card
(`dg_sct_tpu/train/avvp_main.py`; the reference's is `DG-SCT/AVVP/main.py`).

    python -m dg_sct_tpu_torch.train.avvp_main --mode smoke --device cpu
    python -m dg_sct_tpu_torch.train.avvp_main --mode train --frames DIR --audio DIR \\
        --st DIR --label-train AVVP_train.csv --label-val AVVP_val_pd.csv \\
        --label-test AVVP_test_pd.csv --eval-csv-dir DIR --save-dir ckpts/
    python -m dg_sct_tpu_torch.train.avvp_main --mode eval --ckpt ckpts/MGN_Net.npz \\
        --frames DIR --audio DIR --st DIR --label-test AVVP_test_pd.csv --eval-csv-dir DIR

`smoke` takes `--synthetic-steps` mini-steps on seeded synthetic batches
(`data.avvp.synthetic_batch`, sized to the model's frames and samples) and
scores one synthetic clip. `eval` reports the test split's segment-level
and event-level F1, batch 1, against the second-level annotations of
`AVVP_eval_audio.csv` and `AVVP_eval_visual.csv` in `--eval-csv-dir`.
`train` scores the val split after each epoch, saves the full train state
as `MGN_Net.npz` whenever the segment-level type average does not fall,
and reports the test split with the best weights. The LLP csv files are
arguments. Without `--device` it runs on the card and fails without one.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import AVVPModelConfig, TrainConfig
from ..data import ave as ave_data
from ..data import avvp as avvp_data
from ..device import resolve_device
from ..models import avvp as avvp_model
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics_log import MetricsLogger, snapshot_run
from . import avvp_eval, avvp_train
from .optim import count_params

BATCH_KEYS = ("wave", "image", "video_st", "target")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AVVP training and evaluation on one card")
    p.add_argument("--mode", choices=["train", "eval", "smoke"], default="smoke")
    p.add_argument("--label-train", default=None, help="AVVP_train.csv")
    p.add_argument("--label-val", default=None, help="AVVP_val_pd.csv")
    p.add_argument("--label-test", default=None, help="AVVP_test_pd.csv")
    p.add_argument("--eval-csv-dir", default=None,
                   help="the directory of AVVP_eval_audio.csv and AVVP_eval_visual.csv")
    p.add_argument("--frames", default=None)
    p.add_argument("--audio", default=None)
    p.add_argument("--st", default=None, help="r2plus1d features, <id>.npy")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--save-dir", default="checkpoints/avvp")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--synthetic-steps", type=int, default=2)
    p.add_argument("--device", default=None, help="e.g. cpu; default: the card")
    return p.parse_args(argv)


def make_dataset(args, label_csv, cfg: AVVPModelConfig):
    return avvp_data.LLPDataset(label_csv, frame_dir=args.frames, audio_dir=args.audio,
                                st_dir=args.st, img_size=cfg.swin.img_size,
                                num_frames=cfg.num_frames,
                                segment_samples=cfg.htsat.frontend.clip_samples)


def to_device(batch, device) -> dict:
    """A loader's numpy batch as tensors on `device` (int16 PCM wave scaled
    to [-1, 1])."""
    out = {}
    for k in BATCH_KEYS:
        if k in batch:
            v = np.asarray(batch[k])
            if k == "wave" and v.dtype == np.int16:
                v = v.astype(np.float32) / 32767.0
            out[k] = torch.as_tensor(v, device=device)
    return out


def evaluate(estep, tr, fr, state, dataset, eval_csv_dir, device, *, logger=None, step=0,
             tag="val", num_segments=10):
    """Batch-1 F1 over a split -> the summary dict (`avvp_eval.summarize`);
    the best-model criterion is `segment_type_avg`."""
    ann_a = avvp_data.parse_eval_csv(os.path.join(eval_csv_dir, "AVVP_eval_audio.csv"),
                                     num_segments)
    ann_v = avvp_data.parse_eval_csv(os.path.join(eval_csv_dir, "AVVP_eval_visual.csv"),
                                     num_segments)
    empty = np.zeros((len(avvp_data.CATEGORIES), num_segments), np.int64)
    per_video = []
    for batch in ave_data.batched_iterator(dataset, 1, shuffle=False, drop_last=False):
        vid = batch["video"][0]
        out = estep(tr, fr, state, to_device(batch, device))
        per_video.append(avvp_eval.evaluate_video(out, ann_a.get(vid, empty),
                                                  ann_v.get(vid, empty)))
    summary = avvp_eval.summarize(per_video)
    if logger is not None:
        logger.log(summary, step=step, prefix=f"{tag}/")
    for k, v in summary.items():
        print(f"  {tag} {k}: {v:.1f}")
    return summary


def _need(args, *names):
    missing = [f"--{n.replace('_', '-')}" for n in names if not getattr(args, n)]
    if missing:
        raise SystemExit(f"--mode {args.mode} needs {' '.join(missing)}")


def main(argv=None, cfg: AVVPModelConfig | None = None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg or AVVPModelConfig()
    params, state = avvp_model.init_avvp_model(cfg, seed=args.seed, device=device)
    total, trainable_n, _ = count_params(params)
    print(f"####### Trainable params: {trainable_n * 100 / total:.4f}% #######")
    if args.ckpt:
        lp, ls = ckpt_lib.load_params_and_state(args.ckpt)
        params = ckpt_lib.restore_structure(params, lp)
        if ls is not None:
            state = ckpt_lib.restore_structure(state, ls)
    tr, fr = avvp_train.partition_params(params)
    del params
    tcfg = TrainConfig(batch_size=args.batch_size, lr=args.lr, epochs=args.epochs,
                       accum_steps=1)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    estep = avvp_train.make_eval_step(cfg, device=device)
    T = cfg.num_frames
    synth = dict(img_size=cfg.swin.img_size, num_frames=T, sr=cfg.htsat.frontend.clip_samples)

    if args.mode == "smoke":
        opt = avvp_train.make_optimizer(tr, tcfg, steps_per_epoch=100)
        opt_state = opt.init(tr)
        step = avvp_train.make_train_step(cfg, opt, device=device)
        for i in range(args.synthetic_steps):
            batch = to_device(avvp_data.synthetic_batch(args.batch_size, seed=i, **synth), device)
            t0 = time.time()
            tr, state, opt_state, m = step(tr, fr, state, opt_state, batch, gen)
            print(f"step {i}: loss={float(m['loss']):.4f} ({time.time() - t0:.1f}s)")
        out = estep(tr, fr, state, to_device(avvp_data.synthetic_batch(1, **synth), device))
        empty = np.zeros((len(avvp_data.CATEGORIES), T), np.int64)
        scores = avvp_eval.evaluate_video(out, empty, empty)
        print("smoke eval:", {k: round(v, 3) for k, v in scores.items()})
        return scores

    if args.mode == "eval":
        _need(args, "label_test", "eval_csv_dir")
        return evaluate(estep, tr, fr, state, make_dataset(args, args.label_test, cfg),
                        args.eval_csv_dir, device, tag="test", num_segments=T)

    _need(args, "label_train", "label_val", "label_test", "eval_csv_dir")
    train_ds = make_dataset(args, args.label_train, cfg)
    val_ds = make_dataset(args, args.label_val, cfg)
    steps_per_epoch = max(len(train_ds) // tcfg.batch_size, 1)
    opt = avvp_train.make_optimizer(tr, tcfg, steps_per_epoch=steps_per_epoch)
    opt_state = opt.init(tr)
    step = avvp_train.make_train_step(cfg, opt, device=device)
    logger = MetricsLogger(args.save_dir, run_name="avvp", config=vars(args))
    snapshot_run(args.save_dir, config=vars(args))
    best_F, best_path, gstep = -1.0, None, 0
    try:
        for epoch in range(1, tcfg.epochs + 1):
            for batch in ave_data.batched_iterator(train_ds, tcfg.batch_size,
                                                   seed=args.seed + epoch):
                tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                               to_device(batch, device), gen)
                if gstep % args.log_every == 0:
                    loss = float(m["loss"])
                    print(f"epoch {epoch} step {gstep}: loss={loss:.4f}")
                    logger.log({"loss": loss}, step=gstep, prefix="train/")
                gstep += 1
            summary = evaluate(estep, tr, fr, state, val_ds, args.eval_csv_dir, device,
                               logger=logger, step=gstep, num_segments=T)
            F = summary["segment_type_avg"]
            if F >= best_F:
                best_F = F
                os.makedirs(args.save_dir, exist_ok=True)
                best_path = os.path.join(args.save_dir, "MGN_Net.npz")
                ckpt_lib.save_train_state(
                    best_path, params=avvp_train.merge_params(tr, fr), state=state,
                    opt_state=opt_state, rng_state=gen.get_state(), step=gstep,
                    metadata={"epoch": epoch, "segment_type_avg": F})
                print(f"  saved best (F={F:.2f}) -> {best_path}")

        # the test report with the best weights
        if best_path:
            lp, ls = ckpt_lib.load_params_and_state(best_path)
            tr, fr = avvp_train.partition_params(
                ckpt_lib.restore_structure(avvp_train.merge_params(tr, fr), lp))
            state = ckpt_lib.restore_structure(state, ls)
        return evaluate(estep, tr, fr, state, make_dataset(args, args.label_test, cfg),
                        args.eval_csv_dir, device, logger=logger, step=gstep, tag="test",
                        num_segments=T)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
