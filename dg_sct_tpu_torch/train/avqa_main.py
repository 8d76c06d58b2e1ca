"""AVQA two-stage training and evaluation entry point on one card
(`dg_sct_tpu/train/avqa_main.py`; the reference's are DG-SCT's
`grounding_gen/main_grd_gen.py` and `net_grd_avst/main_avst.py`).

    python -m dg_sct_tpu_torch.train.avqa_main --mode smoke --stage 1|2 --device cpu
    python -m dg_sct_tpu_torch.train.avqa_main --mode train --stage 1 --meta DIR \\
        --frames DIR --audio DIR --save-dir ckpts/
    python -m dg_sct_tpu_torch.train.avqa_main --mode train --stage 2 --meta DIR \\
        --frames DIR --audio DIR --stage1-ckpt ckpts/grounding_gen_best.npz --save-dir ckpts/
    python -m dg_sct_tpu_torch.train.avqa_main --mode eval --meta DIR --frames DIR \\
        --audio DIR --ckpt ckpts/avst_best.npz

Stage 1 trains the grounding generator's match classifier with plain Adam,
scores the val split's match accuracy after each epoch and saves the full
train state as `grounding_gen_best.npz` whenever it does not fall. Stage 2
takes the stage-1 heads over by name (`transfer_stage1`), trains with
CE(answer) + 0.5 CE(match) under StepLR, scores the val split after each
epoch, saves `avst_best.npz` whenever the average accuracy does not fall,
and reports the test split's accuracy per question type with the best
weights; `eval` reports it for `--ckpt`. `smoke` runs one step of the
stage on a seeded synthetic batch (`data.avqa.synthetic_batch`, waves of
32000 samples a segment as JAX's, or the model's clip length where that is
shorter).

`--meta` holds the vocabularies and the split jsons (`avqa-{split}.json`,
directly or under `json/`; `--train-json` etc. name others). The datasets
read waves of the model's clip length a segment (`clip_samples`). Without
`--device` it runs on the card and fails without one.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import AVQAModelConfig, TrainConfig
from ..data import ave as ave_data
from ..data import avqa as avqa_data
from ..device import resolve_device
from ..models import avqa as avqa_model
from ..models import avqa_grounding
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics_log import MetricsLogger, snapshot_run
from . import avqa_train, losses
from .optim import AccumulatedAdam, count_params

BATCH_KEYS = ("wave", "visual_posi", "visual_nega", "question", "answer")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AVQA two-stage training and evaluation on one card")
    p.add_argument("--mode", choices=["train", "eval", "smoke"], default="smoke")
    p.add_argument("--stage", type=int, choices=[1, 2], default=2)
    p.add_argument("--meta", default=None, help="vocabularies and split jsons")
    p.add_argument("--train-json", default=None, help="default <meta>/avqa-train.json")
    p.add_argument("--val-json", default=None)
    p.add_argument("--test-json", default=None)
    p.add_argument("--frames", default=None)
    p.add_argument("--audio", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--stage1-ckpt", default=None)
    p.add_argument("--save-dir", default="checkpoints/avqa")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--device", default=None, help="e.g. cpu; default: the card")
    return p.parse_args(argv)


def transfer_stage1(params, stage1_params):
    """The stage-1 heads of the same names (fc_a1, fc_a2, fc_gl, fc1-fc4)
    over the stage-2 model's, each on the stage-2 leaf's device and type;
    the rest of `params` as it is."""
    out = dict(params)
    for k in avqa_model.GROUNDING_HEADS:
        if k in stage1_params:
            out[k] = ckpt_lib.restore_structure(params[k], stage1_params[k])
    return out


def make_dataset(args, split_json, cfg: AVQAModelConfig, seed=0, with_nega=True):
    """`with_nega=False` for stage 2's val and test: its eval step reads no
    negative frames, so none are decoded or copied to the card."""
    return avqa_data.AVQADataset(args.meta, split_json, frame_dir=args.frames,
                                 audio_dir=args.audio, img_size=cfg.swin.img_size,
                                 num_frames=cfg.num_frames,
                                 segment_samples=cfg.htsat.frontend.clip_samples, seed=seed,
                                 with_nega=with_nega)


def _json_path(args, name, override):
    if override:
        return override
    for cand in (os.path.join(args.meta, "json", f"avqa-{name}.json"),
                 os.path.join(args.meta, f"avqa-{name}.json")):
        if os.path.exists(cand):
            return cand
    return os.path.join(args.meta, f"avqa-{name}.json")


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


def evaluate_stage2(estep, tr, fr, state, dataset, device, *, batch_size=2, logger=None, step=0,
                    tag="val"):
    """The accuracy per question type, per modality and over all ("Avg"),
    in %."""
    types, correct = [], []
    for batch in ave_data.batched_iterator(dataset, batch_size, shuffle=False, drop_last=False):
        pred = estep(tr, fr, state, to_device(batch, device)).argmax(-1).cpu().numpy()
        correct.extend((pred == np.asarray(batch["answer"])).tolist())
        types.extend(batch.get("type", [""] * len(pred)))
    accs = avqa_data.question_type_accuracies(types, correct)
    for k in sorted(accs):
        print(f"  {tag} {k} accuracy: {accs[k]:.2f} %")
    if logger is not None:
        logger.log(accs, step=step, prefix=f"{tag}/")
    return accs


# --------------------------- stage 1 ---------------------------

def stage1_labels(batch_size, device):
    """The grounding's match labels: [1, 0] per clip (positive, negative)."""
    return torch.tensor([1, 0], device=device).repeat(batch_size)


def make_stage1_steps(cfg: AVQAModelConfig, opt: AccumulatedAdam, *, device=None):
    """(train_step(trainable, frozen, state, opt_state, batch, gen=None) ->
    (trainable, new state, opt_state, {"loss", "acc"}), eval_step(trainable,
    frozen, state, batch) -> {"loss", "acc"}) of the grounding generator
    over frame 0 of the positive and of the negative clip. `gen` draws
    SpecAugment; None turns it off."""
    device = resolve_device(device)

    def loss_of(params, state, batch, train, gen):
        visual = torch.stack([torch.as_tensor(batch["visual_posi"], device=device)[:, 0],
                              torch.as_tensor(batch["visual_nega"], device=device)[:, 0]], dim=1)
        res = avqa_grounding.forward(params, state, batch["wave"], visual, cfg, train=train,
                                     device=device, gen=gen)
        logits, new_state = res if train else (res, state)
        labels = stage1_labels(logits.shape[0] // 2, device)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return losses.cross_entropy(logits.float(), labels), (acc, new_state)

    def train_step(trainable, frozen, state, opt_state, batch, gen=None):
        trainable, opt_state, loss, (acc, new_state) = avqa_train.update_step(
            opt, trainable, frozen, opt_state, lambda p: loss_of(p, state, batch, True, gen))
        return trainable, new_state, opt_state, {"loss": loss, "acc": acc}

    @torch.inference_mode()
    def eval_step(trainable, frozen, state, batch):
        loss, (acc, _) = loss_of(avqa_train.merge_params(trainable, frozen), state, batch,
                                 False, None)
        return {"loss": loss, "acc": acc}

    return train_step, eval_step


def plain_adam(lr):
    """Adam at a constant `lr` over every trainable group (stage 1's)."""
    return AccumulatedAdam({"train": lambda count: lr})


def run_stage1(args, cfg, device, gen):
    params, state = avqa_grounding.init_grounding_model(cfg, seed=args.seed, device=device)
    tr, fr = avqa_train.partition_params(params)
    del params
    opt = plain_adam(args.lr)
    opt_state = opt.init(tr)
    step, estep = make_stage1_steps(cfg, opt, device=device)
    train_ds = make_dataset(args, _json_path(args, "train", args.train_json), cfg, seed=args.seed)
    val_ds = make_dataset(args, _json_path(args, "val", args.val_json), cfg)
    logger = MetricsLogger(args.save_dir, run_name="avqa_grd", config=vars(args))
    best, best_path, gstep = -1.0, None, 0
    try:
        for epoch in range(1, args.epochs + 1):
            for batch in ave_data.batched_iterator(train_ds, args.batch_size,
                                                   seed=args.seed + epoch):
                tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                               to_device(batch, device), gen)
                if gstep % args.log_every == 0:
                    loss, acc = float(m["loss"]), float(m["acc"])
                    print(f"epoch {epoch} step {gstep}: loss={loss:.4f} acc={acc:.3f}")
                    logger.log({"loss": loss, "acc": acc}, step=gstep, prefix="train/")
                gstep += 1
            accs = [float(estep(tr, fr, state, to_device(b, device))["acc"])
                    for b in ave_data.batched_iterator(val_ds, args.batch_size, shuffle=False,
                                                       drop_last=False)]
            acc = 100.0 * float(np.mean(accs)) if accs else 0.0
            print(f"epoch {epoch}: val match acc {acc:.2f} %")
            logger.log({"match_acc": acc}, step=gstep, prefix="val/")
            if acc >= best:
                best = acc
                os.makedirs(args.save_dir, exist_ok=True)
                best_path = os.path.join(args.save_dir, "grounding_gen_best.npz")
                ckpt_lib.save_train_state(
                    best_path, params=avqa_train.merge_params(tr, fr), state=state,
                    opt_state=opt_state, rng_state=gen.get_state(), step=gstep,
                    metadata={"epoch": epoch, "match_acc": acc})
                print(f"  saved best -> {best_path}")
    finally:
        logger.close()
    return best_path


# --------------------------- stage 2 ---------------------------

def run_stage2(args, cfg, device, gen):
    params, state = avqa_model.init_avqa_model(cfg, seed=args.seed, device=device)
    if args.stage1_ckpt:
        params = transfer_stage1(params, ckpt_lib.load_params_and_state(args.stage1_ckpt)[0])
        print(f"transferred stage-1 heads from {args.stage1_ckpt}")
    if args.ckpt:
        lp, ls = ckpt_lib.load_params_and_state(args.ckpt)
        params = ckpt_lib.restore_structure(params, lp)
        if ls is not None:
            state = ckpt_lib.restore_structure(state, ls)
    total, trainable_n, _ = count_params(params)
    print(f"####### Trainable params: {trainable_n * 100 / total:.4f}% #######")
    tr, fr = avqa_train.partition_params(params)
    del params
    estep = avqa_train.make_eval_step(cfg, device=device)
    test_json = _json_path(args, "test", args.test_json)
    if args.mode == "eval":
        test_ds = make_dataset(args, test_json, cfg, with_nega=False)
        return evaluate_stage2(estep, tr, fr, state, test_ds, device, batch_size=args.batch_size,
                               tag="test")

    tcfg = TrainConfig(batch_size=args.batch_size, lr=args.lr, lr_mlp=args.lr,
                       epochs=args.epochs, accum_steps=1)
    train_ds = make_dataset(args, _json_path(args, "train", args.train_json), cfg, seed=args.seed)
    val_ds = make_dataset(args, _json_path(args, "val", args.val_json), cfg, with_nega=False)
    opt = avqa_train.make_optimizer(tr, tcfg, steps_per_epoch=max(len(train_ds) // tcfg.batch_size,
                                                                  1))
    opt_state = opt.init(tr)
    step = avqa_train.make_train_step(cfg, opt, device=device)
    logger = MetricsLogger(args.save_dir, run_name="avqa", config=vars(args))
    snapshot_run(args.save_dir, config=vars(args))
    best, best_path, gstep = -1.0, None, 0
    try:
        for epoch in range(1, tcfg.epochs + 1):
            for batch in ave_data.batched_iterator(train_ds, tcfg.batch_size,
                                                   seed=args.seed + epoch):
                tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                               to_device(batch, device), gen)
                if gstep % args.log_every == 0:
                    loss, acc = float(m["loss"]), float(m["qa_acc"])
                    print(f"epoch {epoch} step {gstep}: loss={loss:.4f} qa_acc={acc:.3f}")
                    logger.log({"loss": loss, "qa_acc": acc}, step=gstep, prefix="train/")
                gstep += 1
            acc = evaluate_stage2(estep, tr, fr, state, val_ds, device,
                                  batch_size=args.batch_size, logger=logger, step=gstep)["Avg"]
            if acc >= best:
                best = acc
                os.makedirs(args.save_dir, exist_ok=True)
                best_path = os.path.join(args.save_dir, "avst_best.npz")
                ckpt_lib.save_train_state(
                    best_path, params=avqa_train.merge_params(tr, fr), state=state,
                    opt_state=opt_state, rng_state=gen.get_state(), step=gstep,
                    metadata={"epoch": epoch, "acc": acc})
                print(f"  saved best (acc={acc:.2f}) -> {best_path}")

        # the test report with the best weights
        if best_path:
            lp, ls = ckpt_lib.load_params_and_state(best_path)
            tr, fr = avqa_train.partition_params(
                ckpt_lib.restore_structure(avqa_train.merge_params(tr, fr), lp))
            state = ckpt_lib.restore_structure(state, ls)
        test_ds = make_dataset(args, test_json, cfg, with_nega=False)
        return evaluate_stage2(estep, tr, fr, state, test_ds, device, batch_size=args.batch_size,
                               logger=logger, step=gstep, tag="test")
    finally:
        logger.close()


def smoke(args, cfg, device, gen):
    """One step of the stage on a seeded synthetic batch -> its metrics."""
    b = to_device(avqa_data.synthetic_batch(
        args.batch_size, img_size=cfg.swin.img_size, num_frames=cfg.num_frames,
        sr=min(32000, cfg.htsat.frontend.clip_samples)), device)
    t0 = time.time()
    if args.stage == 1:
        params, state = avqa_grounding.init_grounding_model(cfg, seed=args.seed, device=device)
        tr, fr = avqa_train.partition_params(params)
        opt = plain_adam(args.lr)
        step, _ = make_stage1_steps(cfg, opt, device=device)
        m = step(tr, fr, state, opt.init(tr), b, gen)[3]
        print(f"stage-1 smoke: match loss={float(m['loss']):.4f} ({time.time() - t0:.1f}s)")
        return {k: float(v) for k, v in m.items()}
    params, state = avqa_model.init_avqa_model(cfg, seed=args.seed, device=device)
    if args.stage1_ckpt:
        params = transfer_stage1(params, ckpt_lib.load_params_and_state(args.stage1_ckpt)[0])
    tr, fr = avqa_train.partition_params(params)
    tcfg = TrainConfig(batch_size=args.batch_size, lr=args.lr, lr_mlp=args.lr, accum_steps=1)
    opt = avqa_train.make_optimizer(tr, tcfg, steps_per_epoch=100)
    m = avqa_train.make_train_step(cfg, opt, device=device)(tr, fr, state, opt.init(tr), b,
                                                            gen)[3]
    print(f"stage-2 smoke: loss={float(m['loss']):.4f} qa_acc={float(m['qa_acc']):.3f} "
          f"({time.time() - t0:.1f}s)")
    return {k: float(v) for k, v in m.items()}


def main(argv=None, cfg: AVQAModelConfig | None = None):
    """Runs the mode; returns smoke's metrics, stage 1's best checkpoint path
    or stage 2's accuracies."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg or AVQAModelConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if args.mode == "smoke":
        return smoke(args, cfg, device, gen)
    if not args.meta:
        raise SystemExit(f"--mode {args.mode} needs --meta")
    if args.stage == 1:
        if args.mode == "eval":
            raise SystemExit("--mode eval scores stage 2; stage 1 reports its val match "
                             "accuracy while it trains")
        return run_stage1(args, cfg, device, gen)
    return run_stage2(args, cfg, device, gen)


if __name__ == "__main__":
    main()
