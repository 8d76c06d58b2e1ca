"""Pretrain entry point on one card (`dg_sct_tpu/train/pretrain_main.py`; the
reference's `pretrain/main_trans.py`).

    python -m dg_sct_tpu_torch.train.pretrain_main --mode smoke --device cpu
    python -m dg_sct_tpu_torch.train.pretrain_main --mode train --root VGG_META \\
        --frames DIR --audio DIR [--shot K] [--save-dir DIR]
    python -m dg_sct_tpu_torch.train.pretrain_main --mode eval --root VGG_META \\
        --frames DIR --audio DIR --ckpt pretrain_best.npz

Trains the CLIP x CLAP prompt-adapter model on VGGSound-AVEL-40K with the
dynamically weighted loss, scores the test split's weak clip accuracy after
each epoch and saves the full train state as `pretrain_best.npz` whenever
it does not fall: the checkpoint the few-shot and zero-shot entry points read.
`smoke` takes one step on a seeded synthetic batch of B=2. Without
`--device` it runs on the card and fails without one.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import PretrainModelConfig
from ..data import ave as ave_data
from ..data import vggsound as vgg_data
from ..device import resolve_device
from ..models import pretrain as PT
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics_log import MetricsLogger, snapshot_run
from .ave_train import merge_params
from .pretrain_train import (feed, make_pretrain_eval_step, make_pretrain_step,
                             partition_pretrain_params, plain_adam, weak_accuracy)

CATEGORIES_FILE = "VggsoundAVEL40kCategories.txt"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="pretrain on one card")
    p.add_argument("--mode", choices=["train", "eval", "smoke"], default="smoke")
    p.add_argument("--root", default=None,
                   help="VGGSound-AVEL meta directory (labels csv and categories txt)")
    p.add_argument("--frames", default=None)
    p.add_argument("--audio", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--save-dir", default="checkpoints/pretrain")
    p.add_argument("--shot", type=int, default=0,
                   help="K-shot subsampling of the train split; 0: the full set")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--device", default=None, help="e.g. cpu; default: the card")
    return p.parse_args(argv)


def make_dataset(args, split, cfg: PretrainModelConfig):
    return vgg_data.VGGSoundAVELDataset(
        args.root, split, frame_dir=args.frames, audio_dir=args.audio,
        img_size=cfg.clip.image_size, num_frames=cfg.num_frames,
        segment_samples=cfg.htsat.frontend.clip_samples, shot=args.shot)


def evaluate(estep, tr, fr, state, dataset, num_frames, device, *, batch_size=8):
    """Weak clip accuracy, %, over a split."""
    total, n = 0.0, 0
    for batch in ave_data.batched_iterator(dataset, batch_size, shuffle=False, drop_last=False):
        scores = estep(tr, fr, state, feed(batch, device))
        b = len(batch["gt"])
        total += weak_accuracy(scores, vgg_data.weak_labels(batch["gt"]),
                               num_frames=num_frames) * b
        n += b
    return total / max(n, 1)


def main(argv=None, cfg: PretrainModelConfig | None = None, classnames=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if cfg is None:
        classnames = classnames or (
            vgg_data.load_categories(os.path.join(args.root, CATEGORIES_FILE)) if args.root
            else [f"class {i}" for i in range(PretrainModelConfig().num_classes)])
        cfg = PretrainModelConfig(num_classes=len(classnames))
    if classnames is None or len(classnames) != cfg.num_classes:
        raise ValueError(f"{cfg.num_classes} classes need as many class names")
    params, state, buffers = PT.init_pretrain_model(cfg, classnames, seed=args.seed,
                                                    device=device)
    if args.ckpt:
        lp, ls = ckpt_lib.load_params_and_state(args.ckpt)
        params = ckpt_lib.restore_structure(params, lp)
        if ls is not None:
            state = ckpt_lib.restore_structure(state, ls)
    tr, fr = partition_pretrain_params(params)
    del params
    opt = plain_adam(args.lr)
    opt_state = opt.init(tr)
    step = make_pretrain_step(cfg, buffers, opt, device=device)
    estep = make_pretrain_eval_step(cfg, buffers, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    if args.mode == "smoke":
        rs = np.random.RandomState(0)
        B, T, S = 2, cfg.num_frames, cfg.clip.image_size
        batch = {"wave": rs.randn(B, T, cfg.htsat.frontend.clip_samples).astype(np.float32),
                 "image": rs.rand(B, T, S, S, 3).astype(np.float32),
                 "label": np.eye(cfg.num_classes, dtype=np.float32)[
                     rs.randint(cfg.num_classes, size=B)]}
        batch = feed(batch, device, keys=("wave", "image", "label"))
        t0 = time.time()
        tr, state, opt_state, m = step(tr, fr, state, opt_state, batch, gen, epoch=1)
        loss = float(m["loss"])
        print(f"pretrain smoke: loss={loss:.4f} ({time.time() - t0:.1f}s)")
        return loss

    if args.mode == "eval":
        acc = evaluate(estep, tr, fr, state, make_dataset(args, "test", cfg), cfg.num_frames,
                       device, batch_size=args.batch_size)
        print(f"test weak accuracy: {acc:.2f} %")
        return acc

    train_ds = make_dataset(args, "train", cfg)
    test_ds = make_dataset(args, "test", cfg)
    print(f"{len(train_ds)} train / {len(test_ds)} test clips, {cfg.num_classes} classes")
    logger = MetricsLogger(args.save_dir, run_name="pretrain", config=vars(args))
    snapshot_run(args.save_dir, config=vars(args))
    best, best_path, gstep = -1.0, None, 0
    try:
        for epoch in range(1, args.epochs + 1):
            for batch in ave_data.batched_iterator(train_ds, args.batch_size,
                                                   seed=args.seed + epoch):
                batch["label"] = vgg_data.weak_labels(batch["gt"])
                tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                               feed(batch, device, ("wave", "image", "label")),
                                               gen, epoch=epoch)
                if gstep % args.log_every == 0:
                    loss = float(m["loss"])
                    print(f"epoch {epoch} step {gstep}: loss={loss:.4f}")
                    logger.log({"loss": loss}, step=gstep, prefix="train/")
                gstep += 1
            acc = evaluate(estep, tr, fr, state, test_ds, cfg.num_frames, device,
                           batch_size=args.batch_size)
            print(f"epoch {epoch}: weak accuracy {acc:.2f} %")
            logger.log({"weak_acc": acc}, step=gstep, prefix="val/")
            if acc >= best:
                best = acc
                best_path = os.path.join(args.save_dir, "pretrain_best.npz")
                ckpt_lib.save_train_state(
                    best_path, params=merge_params(tr, fr), state=state, opt_state=opt_state,
                    rng_state=gen.get_state(), step=gstep,
                    metadata={"epoch": epoch, "weak_acc": acc})
                print(f"  saved best -> {best_path}")
    finally:
        logger.close()
    return best_path


if __name__ == "__main__":
    main()
