"""Zero-shot evaluation entry point on one card (`dg_sct_tpu/train/zero_shot_main.py`;
the reference's `zero-shot/zero_shot.py`).

    python -m dg_sct_tpu_torch.train.zero_shot_main --mode smoke --device cpu --meta AVE/
    python -m dg_sct_tpu_torch.train.zero_shot_main --mode eval --dataset AVE [--cls] \\
        --ckpt pretrain_best.npz --meta AVE/ --frames DIR --audio DIR
    python -m dg_sct_tpu_torch.train.zero_shot_main --mode eval --dataset LLP \\
        --ckpt pretrain_best.npz --label-test AVVP_test_pd.csv --frames DIR --audio DIR

AVE scores segments (the argmax of each segment's event scores against its
GT, whose background class the prompt set lacks) or, with `--cls`, clips;
LLP scores clips against the weak target's argmax. A pretrain checkpoint
is restored leaf by leaf where the shapes agree (`restore_matching`): a
class list other than the pretrain one keeps this model's prompt learner
and CLAP features. The prompt buffers come from the eval class names (AVE's
`categories.txt`, LLP's 25 categories). As in the JAX package, the datasets
read `cfg.htsat.frontend.clip_samples` samples a segment when a
configuration is passed and 32000 when none is, while the model's frontend
takes 320000 (the frontend's short-wave branch resizes a shorter wave).
Without `--device` it runs on the card and fails without one.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..configs import PretrainModelConfig
from ..data import ave as ave_data
from ..data import avvp as avvp_data
from ..data.vggsound import weak_labels
from ..device import resolve_device
from ..models import pretrain as PT
from ..utils import checkpoint as ckpt_lib
from .pretrain_train import (feed, make_pretrain_eval_step, partition_pretrain_params,
                             segment_accuracy, weak_accuracy, zero_shot_accuracy,
                             zero_shot_scores)

DATASET_SEGMENT = 32000   # the datasets' samples a segment when no configuration is passed


def classnames_for(dataset: str, meta=None):
    """AVE: `categories.txt` of the AVE meta directory (`meta` or
    `meta/data/AVE`, as AVEDataset finds it); LLP: the 25 categories."""
    if dataset == "LLP":
        return list(avvp_data.CATEGORIES)
    if dataset != "AVE":
        raise ValueError(dataset)
    if meta is None:
        raise SystemExit("the AVE class names need --meta")
    sub = os.path.join(meta, "data", "AVE")
    return ave_data.load_categories(os.path.join(sub if os.path.isdir(sub) else meta,
                                                 "categories.txt"))


def restore_checkpoint(path, params, state):
    """`restore_matching` of a saved bundle's params and state onto the
    model's; prints how many entries did not fit."""
    lp, ls = ckpt_lib.load_params_and_state(path)
    params, skipped = ckpt_lib.restore_matching(params, lp)
    if skipped:
        print(f"ckpt: skipped {len(skipped)} shape-mismatched entries")
    if ls is not None:
        state, _ = ckpt_lib.restore_matching(state, ls)
    return params, state


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="zero-shot evaluation on one card")
    p.add_argument("--mode", choices=["eval", "smoke"], default="smoke")
    p.add_argument("--dataset", choices=["AVE", "LLP"], default="AVE")
    p.add_argument("--cls", action="store_true",
                   help="AVE classification instead of per-segment events")
    p.add_argument("--meta", default=None, help="the AVE meta directory (categories.txt, "
                                                "Annotations.txt, the split files)")
    p.add_argument("--label-test", default=None, help="AVVP_test_pd.csv (LLP)")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--frames", default=None)
    p.add_argument("--audio", default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default=None, help="e.g. cpu; default: the card")
    return p.parse_args(argv)


def main(argv=None, cfg: PretrainModelConfig | None = None, classnames=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    kw = dict(frame_dir=args.frames, audio_dir=args.audio,
              img_size=cfg.clip.image_size if cfg else 224,
              num_frames=cfg.num_frames if cfg else 10,
              segment_samples=cfg.htsat.frontend.clip_samples if cfg else DATASET_SEGMENT)
    ds = None
    if args.mode == "eval" and args.dataset == "AVE":
        ds = ave_data.AVEDataset(args.meta, "test", **kw)
        names = classnames or ds.categories
    elif args.mode == "eval":
        if not args.label_test:
            raise SystemExit("--dataset LLP --mode eval needs --label-test")
        ds = avvp_data.LLPDataset(args.label_test, st_dir=None, **kw)
        names = classnames or classnames_for("LLP")
    else:
        names = classnames or classnames_for(args.dataset, args.meta)
    cfg = cfg or PretrainModelConfig(num_classes=len(names))
    params, state, buffers = PT.init_pretrain_model(cfg, names, seed=0, device=device)
    if args.ckpt:
        params, state = restore_checkpoint(args.ckpt, params, state)

    if args.mode == "smoke":
        B, T = 1, 2
        rs = np.random.RandomState(0)
        wave = rs.randn(B, T, cfg.htsat.frontend.clip_samples).astype(np.float32)
        imgs = rs.rand(B, T, cfg.clip.image_size, cfg.clip.image_size, 3).astype(np.float32)
        scores = zero_shot_scores(params, state, buffers, wave, imgs, cfg, device=device)
        gt = np.zeros((B, T, len(names)), np.float32)
        gt[..., 0] = 1
        acc = float(zero_shot_accuracy(scores, gt))
        print(f"zero-shot smoke: scores {tuple(scores.shape)}, acc={acc:.2f}")
        return acc

    tr, fr = partition_pretrain_params(params)
    estep = make_pretrain_eval_step(cfg, buffers, device=device)
    events = args.dataset == "AVE" and not args.cls
    total_acc, total_n = 0.0, 0
    for batch in ave_data.batched_iterator(ds, args.batch_size, shuffle=False, drop_last=False):
        scores = estep(tr, fr, state, feed(batch, device))
        B = len(batch["wave"])
        if events:
            acc, n = segment_accuracy(scores, batch["gt"]), B * cfg.num_frames
        elif args.dataset == "AVE":
            acc, n = weak_accuracy(scores, weak_labels(batch["gt"]),
                                   num_frames=cfg.num_frames), B
        else:
            acc, n = weak_accuracy(scores, batch["target"], num_frames=cfg.num_frames), B
        total_acc += acc * n
        total_n += n
    acc = total_acc / max(total_n, 1)
    print(f"zero-shot {args.dataset} {'events' if events else 'cls'} accuracy: {acc:.2f} %")
    return acc


if __name__ == "__main__":
    main()
