"""AVE training and evaluation entry point (`dg_sct_tpu/train/ave_main.py`;
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
epochs without a new best. Without `--device` it runs on the card and
fails without one.

Data parallelism, as the JAX entry point's data mesh: under torchrun, one
rank a card,

    torchrun --nproc-per-node 4 -m dg_sct_tpu_torch.train.ave_main --mode train ...

(NCCL, card LOCAL_RANK), or with `--world-size N --rank R --init-method
tcp://HOST:PORT` (or file://PATH) in each of N processes, `--device`
naming the rank's card; `--dist-backend gloo` runs several ranks on one
card (NCCL refuses two ranks on one device). `--batch-size` is then the
global batch, split over the most ranks that divide it (the others
idle, as the JAX entry point's data mesh leaves devices out): every rank
of the mesh orders the same
batches from the same seed and loads only its rows, the step averages the
gradients and spans BN statistics, mixup and the random draws over the
global batch (it equals one process's step on it), the test clips are
shared out so that each one the single process scores is scored once (no
padding) and the counts summed, and only rank 0 writes checkpoints and
logs.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import AVEModelConfig, TrainConfig
from ..data import ave as ave_data
from ..device import resolve_device
from ..models import ave as ave_model
from ..parallel import mesh
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics_log import MetricsLogger, snapshot_run
from . import ave_train
from .optim import count_params


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AVE training and evaluation")
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
    p.add_argument("--world-size", type=int, default=None,
                   help="data-parallel ranks (default: torchrun's WORLD_SIZE, else none)")
    p.add_argument("--rank", type=int, default=None, help="this process's rank")
    p.add_argument("--init-method", default=None,
                   help="tcp://HOST:PORT or file://PATH (default: torchrun's env://)")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default="nccl")
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


def evaluate(eval_step, tr, fr, state, batches, device, group=None) -> float:
    """Mean accuracy (%) over the clips of `batches`; with `group`, over
    every rank's clips (the counts summed)."""
    correct, n = 0.0, 0
    for batch in batches:
        m = eval_step(tr, fr, state, to_device(batch, device))
        correct += float(m["correct_frac"]) * batch["gt"].shape[0]
        n += batch["gt"].shape[0]
    if group is not None:
        counts = torch.tensor([correct, n], dtype=torch.float64, device=device)
        dist.all_reduce(counts, group=group)
        correct, n = counts.tolist()
    return 100.0 * correct / max(n, 1)


def data_parallel(args, device):
    """The data mesh of a data-parallel run (torchrun's environment or
    --world-size) over the most ranks that split the global batch, as the
    JAX entry point's `make_data_mesh_for`; None without a world."""
    if args.world_size is None and "WORLD_SIZE" not in os.environ:
        return None
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    mesh.init_world(args.dist_backend, args.init_method, args.rank, args.world_size)
    return mesh.make_data_mesh_for(args.batch_size)


def main(argv=None, cfg: AVEModelConfig | None = None):
    args = parse_args(argv)
    device = resolve_device(args.device, index=mesh.local_rank())
    data = data_parallel(args, device)
    if data is not None and not data.member:
        print(f"rank {dist.get_rank()}: outside the data mesh of "
              f"{data.size(mesh.DATA_AXIS)} ranks that split --batch-size {args.batch_size}; idle")
        return None
    group = None if data is None else data.group(mesh.DATA_AXIS)
    rank = 0 if data is None else data.index(mesh.DATA_AXIS)
    shard = None if data is None else (rank, data.size(mesh.DATA_AXIS))
    rows = (lambda b: b) if data is None else (lambda b: mesh.shard_batch(b, data))
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = cfg or AVEModelConfig()
    tcfg = TrainConfig(batch_size=args.batch_size, accum_steps=args.accum, lr=args.lr,
                       epochs=args.epochs, seed=args.seed, early_stop=args.early_stop)

    params, state = ave_model.init_ave_model(cfg, seed=tcfg.seed, device=device)
    total, trainable, frozen = count_params(params)
    say(f"####### Trainable params: {trainable * 100 / total:.4f}% #######")
    say(f"####### Additional params: {trainable * 100 / frozen:.4f}% #######")
    say(f"####### Total params in M: {total / 1e6:.1f} M #######")
    if args.ckpt:
        lp, ls = ckpt_lib.load_params_and_state(args.ckpt)
        params = ckpt_lib.restore_structure(params, lp)
        if ls is not None:
            state = ckpt_lib.restore_structure(state, ls)
    tr, fr = ave_train.partition_params(params)
    if group is not None:  # every rank starts from rank 0's trainable leaves and state
        mesh.replicate((tr, state), group)
    gen = torch.Generator(device=device)
    gen.manual_seed(tcfg.seed)
    estep = ave_train.make_eval_step(cfg, device=device)
    T = cfg.num_frames
    synth = dict(img_size=cfg.swin.img_size, num_segments=T,
                 sr=cfg.htsat.frontend.clip_samples)

    if args.mode == "smoke":
        opt = ave_train.make_optimizer(tr, tcfg, steps_per_epoch=args.synthetic_steps)
        opt_state = opt.init(tr)
        step = ave_train.make_train_step(cfg, opt, device=device, group=group)
        for i in range(args.synthetic_steps):
            batch = ave_data.synthetic_batch(args.batch_size, seed=i, **synth)
            batch["mixup_lambda"] = np.random.RandomState(i).beta(
                0.5, 0.5, size=(args.batch_size * T,)).astype(np.float32)
            t0 = time.time()
            tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                           to_device(rows(batch), device), gen)
            say(f"step {i}: loss={float(m['loss']):.4f} acc={float(m['acc']):.2f} "
                f"({time.time() - t0:.1f}s)")
        acc = evaluate(estep, tr, fr, state,
                       [rows(ave_data.synthetic_batch(args.batch_size, **synth))], device, group)
        say(f"eval correct_frac={acc / 100.0:.4f}")
        return {"trainable": tr, "state": state, "loss": float(m["loss"]), "eval_acc": acc}

    if not (args.meta and args.frames and args.audio):
        raise SystemExit("--mode train and eval need --meta, --frames and --audio")
    ds_kw = dict(frame_dir=args.frames, audio_dir=args.audio, img_size=cfg.swin.img_size,
                 num_frames=T, segment_samples=cfg.htsat.frontend.clip_samples)
    test_ds = ave_data.AVEDataset(args.meta, "test", **ds_kw)
    if args.mode == "eval":
        acc = evaluate(estep, tr, fr, state,
                       ave_data.batched_iterator(test_ds, 4, shuffle=False, shard=shard),
                       device, group)
        say(f"val acc: {acc:.2f}")
        return acc

    train_ds = ave_data.AVEDataset(args.meta, "train", **ds_kw)
    steps_per_epoch = len(train_ds) // tcfg.batch_size
    opt = ave_train.make_optimizer(tr, tcfg, steps_per_epoch=steps_per_epoch)
    opt_state = opt.init(tr)
    step = ave_train.make_train_step(cfg, opt, device=device, group=group)
    lam_rs = np.random.RandomState(tcfg.seed)
    logger = None
    if rank == 0:
        logger = MetricsLogger(args.save_dir, run_name="ave", config=vars(args))
        snapshot_run(args.save_dir, config=vars(args))
    best, stale = 0.0, 0
    try:
        for epoch in range(1, tcfg.epochs + 1):
            for i, batch in enumerate(ave_data.batched_iterator(
                    train_ds, tcfg.batch_size, seed=tcfg.seed + epoch, shard=shard)):
                lam = lam_rs.beta(tcfg.mixup_alpha, tcfg.mixup_alpha,
                                  size=(tcfg.batch_size * T,)).astype(np.float32)
                batch["mixup_lambda"] = rows({"l": lam})["l"]
                tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                               to_device(batch, device), gen)
                if i % 50 == 0:
                    say(f"epoch {epoch} step {i}: loss={float(m['loss']):.4f}")
                    if logger is not None:
                        logger.log({"loss": m["loss"], "acc": m["acc"]},
                                   step=(epoch - 1) * steps_per_epoch + i, prefix="train/")
            acc = evaluate(estep, tr, fr, state, ave_data.batched_iterator(
                test_ds, tcfg.batch_size, shuffle=False, shard=shard), device, group)
            say(f"epoch {epoch}: val acc {acc:.2f}")
            if logger is not None:
                logger.log({"acc": acc}, step=epoch * steps_per_epoch, prefix="val/")
            if acc >= best:
                best, stale = acc, 0
                if rank == 0:
                    ckpt_lib.save_train_state(
                        os.path.join(args.save_dir, f"best_{acc:.2f}.npz"),
                        params=ave_train.merge_params(tr, fr), state=state,
                        opt_state=opt_state, rng_state=gen.get_state(),
                        step=epoch * steps_per_epoch, metadata={"epoch": epoch, "acc": acc})
            else:
                stale += 1
                if stale >= tcfg.early_stop:
                    say("early stop")
                    break
    finally:
        if logger is not None:
            logger.close()
    return best


if __name__ == "__main__":
    main()
