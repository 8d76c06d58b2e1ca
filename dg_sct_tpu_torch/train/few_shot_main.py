"""Few-shot fine-tuning entry point on one card (`dg_sct_tpu/train/few_shot_main.py`;
the reference's `few-shot/main_AVE*.py` and `main_LLP_class.py`).

    python -m dg_sct_tpu_torch.train.few_shot_main --mode smoke --device cpu --meta AVE/
    python -m dg_sct_tpu_torch.train.few_shot_main --mode train --dataset AVE \\
        [--task cls|events] --k-shot 16 --meta AVE/ --frames DIR --audio DIR \\
        [--ckpt pretrain_best.npz]
    python -m dg_sct_tpu_torch.train.few_shot_main --mode train --dataset LLP \\
        --label-train AVVP_train.csv --label-test AVVP_test_pd.csv --frames DIR --audio DIR

Fine-tunes the pretrain model on K examples a class (`few_shot_subsample`)
with the reference's staged weighting: the event loss at 500x for the first
`--stage-epochs` epochs, 5x after. `cls` scores clips (AVE: the first
foreground segment's class; LLP: its single-label rows); `events` scores
AVE's segments against their (T, 29) grids with a "background" prompt
appended (`PromptConfig(weak=False)`). Each step clips the gradients by
their global norm exactly as `optax.clip_by_global_norm` does, then Adam.
A pretrain checkpoint is restored leaf by leaf where the shapes agree. The
csv and meta paths are arguments. Without `--device` it runs on the card
and fails without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..configs import PretrainModelConfig, PromptConfig
from ..data import ave as ave_data
from ..data import avvp as avvp_data
from ..data.vggsound import weak_labels
from ..device import resolve_device
from ..models import pretrain as PT
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics_log import MetricsLogger
from . import losses
from .ave_train import merge_params
from .optim import ClippedAdam
from .pretrain_train import (clip_scores, contrastive_terms, feed, few_shot_subsample,
                             make_pretrain_eval_step, make_pretrain_step,
                             partition_pretrain_params, segment_accuracy, soft_cross_entropy,
                             weak_accuracy)
from .zero_shot_main import classnames_for, restore_checkpoint

W_EARLY, W_LATE = 500.0, 5.0   # the event loss's weight up to stage_epochs, then after


def event_weight(epoch, stage_epochs):
    return W_EARLY if epoch <= stage_epochs else W_LATE


def few_shot_loss(out, labels, *, epoch, num_frames=10, stage_epochs=4):
    """Clip classification: labels (B, n_cls) one-hot; CE of the event
    scores meaned over segments, weighted by stage, plus the contrastive
    terms."""
    labels = torch.as_tensor(labels, device=out["event_scores"].device)
    ev = clip_scores(out["event_scores"], labels.shape[0], num_frames)
    loss_ai, loss_ia = contrastive_terms(out)
    return (event_weight(epoch, stage_epochs) * losses.cross_entropy(ev, labels.argmax(-1))
            + loss_ai + loss_ia)


def few_shot_event_loss(out, labels, *, epoch, num_frames=10, stage_epochs=4):
    """Event localization: labels (B, T, n_cls + 1) segment grids; the
    per-segment soft CE, weighted by stage, plus the contrastive terms."""
    labels = torch.as_tensor(labels, device=out["event_scores"].device)
    loss_event = soft_cross_entropy(out["event_scores"], labels.reshape(-1, labels.shape[-1]))
    loss_ai, loss_ia = contrastive_terms(out)
    return event_weight(epoch, stage_epochs) * loss_event + loss_ai + loss_ia


def make_few_shot_step(cfg, buffers, opt, loss=few_shot_loss, *, device=None):
    """The pretrain step (`make_pretrain_step`) with a few-shot loss; `opt`
    is a `ClippedAdam`."""
    return make_pretrain_step(cfg, buffers, opt, device=device, loss=loss)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="few-shot fine-tuning on one card")
    p.add_argument("--mode", choices=["train", "smoke"], default="smoke")
    p.add_argument("--task", choices=["cls", "events"], default="cls",
                   help="cls: clip classification; events: AVE per-segment event localization")
    p.add_argument("--k-shot", type=int, default=16)
    p.add_argument("--dataset", choices=["AVE", "LLP"], default="AVE")
    p.add_argument("--meta", default=None, help="the AVE meta directory")
    p.add_argument("--label-train", default=None, help="AVVP_train.csv (LLP)")
    p.add_argument("--label-test", default=None, help="AVVP_test_pd.csv (LLP)")
    p.add_argument("--frames", default=None)
    p.add_argument("--audio", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--save-dir", default="checkpoints/few_shot")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--stage-epochs", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None, help="e.g. cpu; default: the card")
    return p.parse_args(argv)


class _Subset:
    def __init__(self, ds, idxs):
        self.ds, self.idxs = ds, list(idxs)

    def __len__(self):
        return len(self.idxs)

    def __getitem__(self, i):
        return self.ds[self.idxs[i]]


def build_datasets(args, cfg):
    """(the K-shot train subset, the test set, the batch -> weak label map).
    AVE: a clip's class is its first foreground segment's; LLP: the
    single-label rows only."""
    kw = dict(frame_dir=args.frames, audio_dir=args.audio, img_size=cfg.clip.image_size,
              num_frames=cfg.num_frames, segment_samples=cfg.htsat.frontend.clip_samples)
    if args.dataset == "AVE":
        train = ave_data.AVEDataset(args.meta, "train", **kw)
        test = ave_data.AVEDataset(args.meta, "test", **kw)
        cls_of = [int(np.argmax(weak_labels(train.labels[v][None])[0])) for v in train.ids]
        label_fn = lambda b: weak_labels(b["gt"])
    else:
        train = avvp_data.LLPDataset(args.label_train, st_dir=None, **kw)
        test = avvp_data.LLPDataset(args.label_test, st_dir=None, **kw)
        train = _Subset(train, [i for i, (_, t) in enumerate(train.samples) if t.sum() == 1])
        cls_of = [int(np.argmax(train.ds.samples[i][1])) for i in train.idxs]
        label_fn = lambda b: b["target"]
    keep = few_shot_subsample(np.asarray(cls_of), args.k_shot, seed=args.seed)
    return _Subset(train, keep), test, label_fn


def main(argv=None, cfg: PretrainModelConfig | None = None, classnames=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.task == "events" and args.dataset != "AVE":
        raise SystemExit("event localization is the AVE task")
    if cfg is None:
        names = classnames or classnames_for(args.dataset, args.meta)
        cfg = PretrainModelConfig(num_classes=len(names))
        if args.task == "events":
            cfg = dataclasses.replace(cfg, prompt=PromptConfig(weak=False))
    else:
        names = classnames
    if names is None or len(names) != cfg.num_classes:
        raise ValueError(f"{cfg.num_classes} classes need as many class names")
    params, state, buffers = PT.init_pretrain_model(cfg, names, seed=args.seed, device=device)
    if args.ckpt:
        params, state = restore_checkpoint(args.ckpt, params, state)
    tr, fr = partition_pretrain_params(params)
    del params
    opt = ClippedAdam({"train": lambda count: args.lr}, args.grad_clip)
    opt_state = opt.init(tr)
    loss = few_shot_event_loss if args.task == "events" else few_shot_loss
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    if args.mode == "smoke":
        B, T, S = 2, 2, cfg.clip.image_size
        step = make_few_shot_step(dataclasses.replace(cfg, num_frames=T), buffers, opt,
                                  device=device)
        rs = np.random.RandomState(0)
        batch = {"wave": rs.randn(B, T, cfg.htsat.frontend.clip_samples).astype(np.float32),
                 "image": rs.rand(B, T, S, S, 3).astype(np.float32),
                 "label": np.eye(len(names), dtype=np.float32)[rs.randint(len(names), size=B)]}
        t0 = time.time()
        tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                       feed(batch, device, ("wave", "image", "label")), gen)
        value = float(m["loss"])
        print(f"few-shot smoke: loss={value:.2f} ({time.time() - t0:.0f}s)")
        fake = np.repeat(np.arange(len(names)), 20)
        keep = few_shot_subsample(fake, args.k_shot, seed=args.seed)
        if len(keep) != args.k_shot * len(names):
            raise AssertionError(f"the K-shot sampler kept {len(keep)}")
        print(f"k-shot sampler: kept {len(keep)} of {len(fake)}")
        return value

    step = make_few_shot_step(cfg, buffers, opt, loss, device=device)
    train_ds, test_ds, label_fn = build_datasets(args, cfg)
    if args.task == "events":
        label_fn = lambda b: b["gt"]
    print(f"{len(train_ds)} K-shot train clips ({args.k_shot}/class), {len(test_ds)} test clips")
    estep = make_pretrain_eval_step(cfg, buffers, device=device)
    logger = MetricsLogger(args.save_dir, run_name=f"few_shot_{args.dataset}", config=vars(args))
    best, gstep = -1.0, 0
    try:
        for epoch in range(1, args.epochs + 1):
            for batch in ave_data.batched_iterator(train_ds, args.batch_size,
                                                   seed=args.seed + epoch, drop_last=False):
                batch["label"] = label_fn(batch)
                tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                               feed(batch, device, ("wave", "image", "label")),
                                               gen, epoch=min(epoch, args.stage_epochs + 1))
                if gstep % args.log_every == 0:
                    value = float(m["loss"])
                    print(f"epoch {epoch} step {gstep}: loss={value:.2f}")
                    logger.log({"loss": value}, step=gstep, prefix="train/")
                gstep += 1
            total, n = 0.0, 0
            for batch in ave_data.batched_iterator(test_ds, args.batch_size, shuffle=False,
                                                   drop_last=False):
                scores = estep(tr, fr, state, feed(batch, device))
                b = len(batch["wave"])
                if args.task == "events":
                    total += segment_accuracy(scores, batch["gt"]) * b
                else:
                    total += weak_accuracy(scores, label_fn(batch),
                                           num_frames=cfg.num_frames) * b
                n += b
            acc = total / max(n, 1)
            print(f"epoch {epoch}: test {args.task} accuracy {acc:.2f} %")
            logger.log({"cls_acc": acc}, step=gstep, prefix="test/")
            if acc >= best:
                best = acc
                ckpt_lib.save_train_state(
                    os.path.join(args.save_dir, f"few_shot_{args.dataset}_{args.task}_best.npz"),
                    params=merge_params(tr, fr), state=state, opt_state=opt_state,
                    rng_state=gen.get_state(), step=gstep, metadata={"epoch": epoch, "acc": acc})
    finally:
        logger.close()
    return best


if __name__ == "__main__":
    main()
