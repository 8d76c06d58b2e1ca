"""AVE training and evaluation entry point on one card (`dg_sct_tpu/train/ave_main.py`;
the reference's is `DG-SCT/AVE/main_trans.py`).

    python -m dg_sct_tpu_torch.train.ave_main --mode smoke --device cpu
    python -m dg_sct_tpu_torch.train.ave_main --mode train --meta DIR --frames DIR \\
        --audio DIR --save-dir ckpts/
    python -m dg_sct_tpu_torch.train.ave_main --mode eval --meta DIR --frames DIR \\
        --audio DIR --ckpt ckpts/best_NN.NN.npz

`smoke` takes `--synthetic-steps` mini-steps on seeded synthetic batches
(`data.ave.synthetic_batch`, sized to the model's frames and samples) and
one eval step. `train` saves the full train state as `best_{acc:.2f}.npz`
whenever the test accuracy does not fall, and stops after `--early-stop`
epochs without a new best. `--batch-size` is per card; the data-parallel
mesh of the JAX entry point is ROADMAP queue 1, item 8 (the parallel
modes). Without `--device` it runs on the card and fails without one.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import AVEModelConfig, TrainConfig
from ..data import ave as ave_data
from ..device import resolve_device
from ..models import ave as ave_model
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics_log import MetricsLogger, snapshot_run
from . import ave_train
from .optim import count_params


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AVE training and evaluation on one card")
    p.add_argument("--mode", choices=["train", "eval", "smoke"], default="smoke")
    p.add_argument("--meta", default=None, help="AVE root with the split and annotation files")
    p.add_argument("--frames", default=None)
    p.add_argument("--audio", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--save-dir", default="checkpoints")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--accum", type=int, default=2)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--early-stop", type=int, default=10)
    p.add_argument("--synthetic-steps", type=int, default=2)
    p.add_argument("--device", default=None, help="e.g. cpu; default: the card")
    return p.parse_args(argv)


def to_device(batch, device) -> dict:
    """A loader's numpy batch as float32 tensors on `device` (int16 PCM wave
    scaled to [-1, 1]); labels and lambdas as they are."""
    out = {}
    for k in ("wave", "image", "gt", "mixup_lambda"):
        if k in batch:
            v = np.asarray(batch[k])
            if k == "wave" and v.dtype == np.int16:
                v = v.astype(np.float32) / 32767.0
            out[k] = torch.as_tensor(v, device=device)
    return out


def evaluate(eval_step, tr, fr, state, batches, device) -> float:
    """Mean accuracy (%) over the clips of `batches`."""
    correct, n = 0.0, 0
    for batch in batches:
        m = eval_step(tr, fr, state, to_device(batch, device))
        correct += float(m["correct_frac"]) * batch["gt"].shape[0]
        n += batch["gt"].shape[0]
    return 100.0 * correct / max(n, 1)


def main(argv=None, cfg: AVEModelConfig | None = None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg or AVEModelConfig()
    tcfg = TrainConfig(batch_size=args.batch_size, accum_steps=args.accum, lr=args.lr,
                       epochs=args.epochs, seed=args.seed, early_stop=args.early_stop)

    params, state = ave_model.init_ave_model(cfg, seed=tcfg.seed, device=device)
    total, trainable, frozen = count_params(params)
    print(f"####### Trainable params: {trainable * 100 / total:.4f}% #######")
    print(f"####### Additional params: {trainable * 100 / frozen:.4f}% #######")
    print(f"####### Total params in M: {total / 1e6:.1f} M #######")
    if args.ckpt:
        lp, ls = ckpt_lib.load_params_and_state(args.ckpt)
        params = ckpt_lib.restore_structure(params, lp)
        if ls is not None:
            state = ckpt_lib.restore_structure(state, ls)
    tr, fr = ave_train.partition_params(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(tcfg.seed)
    estep = ave_train.make_eval_step(cfg, device=device)
    T = cfg.num_frames
    synth = dict(img_size=cfg.swin.img_size, num_segments=T,
                 sr=cfg.htsat.frontend.clip_samples)

    if args.mode == "smoke":
        opt = ave_train.make_optimizer(tr, tcfg, steps_per_epoch=args.synthetic_steps)
        opt_state = opt.init(tr)
        step = ave_train.make_train_step(cfg, opt, device=device)
        for i in range(args.synthetic_steps):
            batch = ave_data.synthetic_batch(args.batch_size, seed=i, **synth)
            batch["mixup_lambda"] = np.random.RandomState(i).beta(
                0.5, 0.5, size=(args.batch_size * T,)).astype(np.float32)
            t0 = time.time()
            tr, state, opt_state, m = step(tr, fr, state, opt_state, to_device(batch, device),
                                           gen)
            print(f"step {i}: loss={float(m['loss']):.4f} acc={float(m['acc']):.2f} "
                  f"({time.time() - t0:.1f}s)")
        m = estep(tr, fr, state, to_device(ave_data.synthetic_batch(args.batch_size, **synth),
                                           device))
        print(f"eval correct_frac={float(m['correct_frac']):.4f}")
        return

    if not (args.meta and args.frames and args.audio):
        raise SystemExit("--mode train and eval need --meta, --frames and --audio")
    ds_kw = dict(frame_dir=args.frames, audio_dir=args.audio, img_size=cfg.swin.img_size,
                 num_frames=T, segment_samples=cfg.htsat.frontend.clip_samples)
    test_ds = ave_data.AVEDataset(args.meta, "test", **ds_kw)
    if args.mode == "eval":
        acc = evaluate(estep, tr, fr, state,
                       ave_data.batched_iterator(test_ds, 4, shuffle=False), device)
        print(f"val acc: {acc:.2f}")
        return acc

    train_ds = ave_data.AVEDataset(args.meta, "train", **ds_kw)
    steps_per_epoch = len(train_ds) // tcfg.batch_size
    opt = ave_train.make_optimizer(tr, tcfg, steps_per_epoch=steps_per_epoch)
    opt_state = opt.init(tr)
    step = ave_train.make_train_step(cfg, opt, device=device)
    lam_rs = np.random.RandomState(tcfg.seed)
    logger = MetricsLogger(args.save_dir, run_name="ave", config=vars(args))
    snapshot_run(args.save_dir, config=vars(args))
    best, stale = 0.0, 0
    try:
        for epoch in range(1, tcfg.epochs + 1):
            for i, batch in enumerate(ave_data.batched_iterator(
                    train_ds, tcfg.batch_size, seed=tcfg.seed + epoch)):
                batch["mixup_lambda"] = lam_rs.beta(
                    tcfg.mixup_alpha, tcfg.mixup_alpha,
                    size=(batch["gt"].shape[0] * T,)).astype(np.float32)
                tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                               to_device(batch, device), gen)
                if i % 50 == 0:
                    print(f"epoch {epoch} step {i}: loss={float(m['loss']):.4f}")
                    logger.log({"loss": m["loss"], "acc": m["acc"]},
                               step=(epoch - 1) * steps_per_epoch + i, prefix="train/")
            acc = evaluate(estep, tr, fr, state, ave_data.batched_iterator(
                test_ds, tcfg.batch_size, shuffle=False), device)
            print(f"epoch {epoch}: val acc {acc:.2f}")
            logger.log({"acc": acc}, step=epoch * steps_per_epoch, prefix="val/")
            if acc >= best:
                best, stale = acc, 0
                ckpt_lib.save_train_state(
                    os.path.join(args.save_dir, f"best_{acc:.2f}.npz"),
                    params=ave_train.merge_params(tr, fr), state=state, opt_state=opt_state,
                    rng_state=gen.get_state(), step=epoch * steps_per_epoch,
                    metadata={"epoch": epoch, "acc": acc})
            else:
                stale += 1
                if stale >= tcfg.early_stop:
                    print("early stop")
                    break
    finally:
        logger.close()
    return best


if __name__ == "__main__":
    main()
