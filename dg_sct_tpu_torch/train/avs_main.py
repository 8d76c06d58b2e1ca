"""AVS (S4 and MS3) training and evaluation entry point on one card
(`dg_sct_tpu/train/avs_main.py`; the reference's are AVSBench's
`avs_s4/train.py` and `avs_ms3/train.py`).

    python -m dg_sct_tpu_torch.train.avs_main --mode smoke --task s4 --device cpu
    python -m dg_sct_tpu_torch.train.avs_main --mode train --task ms3 --root AVSBench \\
        --save-dir ckpts/
    python -m dg_sct_tpu_torch.train.avs_main --mode eval --task s4 --root AVSBench \\
        --ckpt ckpts/s4_best.npz --save-pred-mask

`smoke` takes `--synthetic-steps` mini-steps on seeded synthetic batches
(`data.avs.synthetic_batch`, sized to the model's frames, mask size and
samples) and one eval. `eval` reports the test split's mIoU and F-score and,
with `--save-pred-mask`, writes the thresholded masks as PNGs. `train`
scores the val split's mIoU after each epoch (the test split where there
is no val split), saves the full train state as `{task}_best.npz` at each
new best, stops after `--early-stop` epochs without one, and reports the
test split with the best weights. S4 trains on each clip's first mask and
MS3 on all of them. Both tasks read the S4 tree layout of `data.avs`.
Without `--device` it runs on the card and fails without one.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ..configs import AVSModelConfig, TrainConfig
from ..data import ave as ave_data
from ..data import avs as avs_data
from ..device import resolve_device
from ..models import avs as avs_model
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics_log import MetricsLogger, snapshot_run
from . import avs_train
from .metrics import f_measure, mask_iou, save_masks
from .optim import count_params


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AVS (S4 / MS3) training and evaluation on one card")
    p.add_argument("--mode", choices=["train", "eval", "smoke"], default="smoke")
    p.add_argument("--task", choices=list(avs_train.TASKS), default="s4")
    p.add_argument("--root", default=None, help="AVSBench tree (data.avs.S4Dataset's layout)")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--save-dir", default="checkpoints/avs")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--early-stop", type=int, default=5)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--synthetic-steps", type=int, default=1)
    p.add_argument("--save-pred-mask", action="store_true",
                   help="write thresholded prediction PNGs in --mode eval")
    p.add_argument("--device", default=None, help="e.g. cpu; default: the card")
    return p.parse_args(argv)


def make_dataset(args, split, mask_num, cfg: AVSModelConfig):
    return avs_data.S4Dataset(args.root, split, mask_num=mask_num, img_size=cfg.mask_size,
                              num_frames=cfg.num_frames,
                              segment_samples=cfg.htsat.frontend.clip_samples)


def prep_batch(batch, task, device) -> dict:
    """A loader's batch as tensors on `device`, the mask (B, mask_num, H, W,
    1) in the loss's layout: S4's first frame (B, H, W, 1), MS3's every frame
    (B*T, H, W, 1)."""
    out = {k: torch.as_tensor(batch[k], device=device) for k in ("image", "wave")}
    m = batch["mask"]
    out["mask"] = torch.as_tensor(m[:, 0] if task == "s4" else m.reshape(-1, *m.shape[2:]),
                                  device=device)
    return out


def evaluate(estep, tr, fr, state, dataset, device, *, batch_size=4, with_f=False,
             save_dir=None, num_frames=5):
    """mIoU over every frame of `dataset`, each batch weighted by its frames;
    with `with_f` also the F-score, -> (mIoU, F). `save_dir`: write each
    prediction as a thresholded PNG (`metrics.save_masks`)."""
    ious, fs, n = [], [], 0
    for batch in ave_data.batched_iterator(dataset, batch_size, shuffle=False,
                                           drop_last=False):
        gt = batch["mask"].reshape(-1, *batch["mask"].shape[2:])[..., 0]      # (B*T, H, W)
        feed = {k: torch.as_tensor(batch[k], device=device) for k in ("image", "wave")}
        pred = estep(tr, fr, state, feed)[..., 0].cpu().numpy()
        ious.append(mask_iou(pred, gt) * len(pred))
        if with_f:
            fs.append(f_measure(pred, gt) * len(pred))
        if save_dir is not None:
            save_masks(pred, save_dir, batch["category"], batch["video"], num_frames)
        n += len(pred)
    miou = sum(ious) / max(n, 1)
    return (miou, sum(fs) / max(n, 1)) if with_f else miou


def main(argv=None, cfg: AVSModelConfig | None = None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg or AVSModelConfig()
    params, state = avs_model.init_avs_model(cfg, seed=args.seed, device=device)
    total, trainable_n, _ = count_params(params)
    print(f"####### Trainable params: {trainable_n * 100 / total:.4f}% #######")
    if args.ckpt:
        lp, ls = ckpt_lib.load_params_and_state(args.ckpt)
        params = ckpt_lib.restore_structure(params, lp)
        if ls is not None:
            state = ckpt_lib.restore_structure(state, ls)
    tr, fr = avs_train.partition_params(params)
    del params
    tcfg = TrainConfig(batch_size=args.batch_size, lr=args.lr, epochs=args.epochs,
                       accum_steps=1)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    estep = avs_train.make_eval_step(cfg, device=device)
    T = cfg.num_frames
    synth = dict(img_size=cfg.mask_size, num_frames=T, sr=cfg.htsat.frontend.clip_samples)

    if args.mode == "smoke":
        opt = avs_train.make_optimizer(tr, tcfg, steps_per_epoch=100)
        opt_state = opt.init(tr)
        step = avs_train.make_train_step(cfg, opt, task=args.task, device=device)
        mask_frames = 1 if args.task == "s4" else T
        for i in range(args.synthetic_steps):
            b = avs_data.synthetic_batch(args.batch_size, seed=i, mask_frames=mask_frames,
                                         **synth)
            batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
            t0 = time.time()
            tr, state, opt_state, m = step(tr, fr, state, opt_state, batch, gen)
            print(f"step {i}: loss={float(m['loss']):.4f} ({time.time() - t0:.1f}s)")
        b = avs_data.synthetic_batch(1, mask_frames=T, **synth)
        pred = estep(tr, fr, state, {k: b[k] for k in ("image", "wave")})[..., 0].cpu().numpy()
        miou = mask_iou(pred, b["mask"][..., 0])
        f = f_measure(pred, b["mask"][..., 0])
        print(f"smoke eval: mIoU={miou:.4f} F={f:.4f}")
        return {"miou": miou, "f_score": f}

    if not args.root:
        raise SystemExit("--mode train and eval need --root")
    if args.mode == "eval":
        test_ds = make_dataset(args, "test", T, cfg)
        save_dir = os.path.join(args.save_dir, "pred_masks") if args.save_pred_mask else None
        miou, f = evaluate(estep, tr, fr, state, test_ds, device, batch_size=args.batch_size,
                           with_f=True, save_dir=save_dir, num_frames=T)
        print(f"test mIoU: {miou:.4f}  F-score: {f:.4f}")
        return {"miou": miou, "f_score": f}

    train_ds = make_dataset(args, "train", 1 if args.task == "s4" else T, cfg)
    val_ds = make_dataset(args, "val", T, cfg)
    if len(val_ds) == 0:
        val_ds = make_dataset(args, "test", T, cfg)
    steps_per_epoch = max(len(train_ds) // tcfg.batch_size, 1)
    opt = avs_train.make_optimizer(tr, tcfg, steps_per_epoch=steps_per_epoch)
    opt_state = opt.init(tr)
    step = avs_train.make_train_step(cfg, opt, task=args.task, device=device)
    logger = MetricsLogger(args.save_dir, run_name=f"avs_{args.task}", config=vars(args))
    snapshot_run(args.save_dir, config=vars(args))
    max_miou, stale, best_path, gstep = -1.0, 0, None, 0
    try:
        for epoch in range(1, tcfg.epochs + 1):
            for batch in ave_data.batched_iterator(train_ds, tcfg.batch_size,
                                                   seed=args.seed + epoch):
                tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                               prep_batch(batch, args.task, device), gen)
                if gstep % args.log_every == 0:
                    loss = float(m["loss"])
                    print(f"epoch {epoch} step {gstep}: loss={loss:.4f}")
                    logger.log({"loss": loss}, step=gstep, prefix="train/")
                gstep += 1
            miou = evaluate(estep, tr, fr, state, val_ds, device, batch_size=args.batch_size)
            print(f"epoch {epoch}: val mIoU {miou:.4f}")
            logger.log({"miou": miou}, step=gstep, prefix="val/")
            if miou > max_miou:
                max_miou, stale = miou, 0
                best_path = os.path.join(args.save_dir, f"{args.task}_best.npz")
                ckpt_lib.save_train_state(
                    best_path, params=avs_train.merge_params(tr, fr), state=state,
                    opt_state=opt_state, rng_state=gen.get_state(), step=gstep,
                    metadata={"epoch": epoch, "miou": miou})
                print(f"  saved best (mIoU={miou:.4f}) -> {best_path}")
            else:
                stale += 1
                if stale >= args.early_stop:
                    print("early stop")
                    break

        # the test report with the best weights
        if best_path:
            lp, ls = ckpt_lib.load_params_and_state(best_path)
            tr, fr = avs_train.partition_params(
                ckpt_lib.restore_structure(avs_train.merge_params(tr, fr), lp))
            state = ckpt_lib.restore_structure(state, ls)
        test_ds = make_dataset(args, "test", T, cfg)
        result = None
        if len(test_ds):
            miou, f = evaluate(estep, tr, fr, state, test_ds, device,
                               batch_size=args.batch_size, with_f=True)
            print(f"test mIoU: {miou:.4f}  F-score: {f:.4f}")
            logger.log({"miou": miou, "f_score": f}, step=gstep, prefix="test/")
            result = {"miou": miou, "f_score": f}
    finally:
        logger.close()
    return result


if __name__ == "__main__":
    main()
