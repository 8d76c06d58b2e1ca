"""Pretrain, few-shot and zero-shot training and scoring
(`dg_sct_tpu/train/pretrain_train.py`).

The pretrain loss (the reference's `pretrain/main_trans.py:113-137`):
CE(event scores meaned over segments, the clip's label) and the symmetric
soft CE of the B x B audio <-> image logits against the identity, each
weighted by its share of (epoch + the three losses) plus 1 / epoch. The
weights carry gradient, as in the JAX package. Frozen: `visual`, `text`
(its logit_scale too), `htsat` and `clap_text_features`; the adapters, the
prompt learner's ctx, the two ClipAdapters, the audio projection,
logit_scale_a and the contrastive fc train with plain Adam in float32, no
remat (the JAX package has none here). The text tower runs in the graph,
because ctx trains. Zero-shot scores segments by the argmax of the event
scores (`zero-shot/zero_shot.py:151-177`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs import PretrainModelConfig
from ..device import resolve_device
from ..models import pretrain
from . import losses
from .ave_train import merge_params, update_step
from .optim import AccumulatedAdam

FROZEN_KEYS = ("visual", "text", "htsat", "clap_text_features")


def soft_cross_entropy(logits, soft_targets):
    """torch CrossEntropyLoss with probability targets."""
    return -(torch.log_softmax(logits, -1) * soft_targets).sum(-1).mean()


def contrastive_terms(out):
    """The soft CE of the audio -> image and image -> audio logits against
    the identity."""
    la, li = out["logits_audio_image"], out["logits_image_audio"]
    eye = torch.eye(la.shape[0], device=la.device, dtype=la.dtype)
    return soft_cross_entropy(la, eye), soft_cross_entropy(li, eye)


def clip_scores(event_scores, B, num_frames):
    """(B*T, n_cls) segment scores -> (B, n_cls), meaned over the segments."""
    return event_scores.reshape(B, num_frames, -1).mean(1)


def pretrain_loss(out, labels, *, epoch, num_frames=10, weak=True):
    """labels: (B, n_cls) clip-level one-hot."""
    labels = torch.as_tensor(labels, device=out["event_scores"].device)
    ev = out["event_scores"]
    B = labels.shape[0]
    if weak:
        ev = clip_scores(ev, B, num_frames)
    loss_event = losses.cross_entropy(ev, labels.argmax(-1))
    loss_ai, loss_ia = contrastive_terms(out)
    denom = epoch + loss_event + loss_ai + loss_ia
    w1 = loss_event / denom + 1.0 / epoch
    w2 = loss_ai / denom + 1.0 / epoch
    w3 = loss_ia / denom + 1.0 / epoch
    return w1 * loss_event + w2 * loss_ai + w3 * loss_ia


def partition_pretrain_params(params):
    """(trainable, frozen) top-level subtrees by the pretrain suite's policy."""
    trainable = {k: v for k, v in params.items() if k not in FROZEN_KEYS}
    frozen = {k: v for k, v in params.items() if k in FROZEN_KEYS}
    return trainable, frozen


def plain_adam(lr: float) -> AccumulatedAdam:
    """`optax.adam(lr)`: every trainable leaf at `lr`, one mini-step an update."""
    return AccumulatedAdam({"train": lambda count: lr})


def make_pretrain_step(cfg: PretrainModelConfig, buffers, opt, *, device=None,
                       loss=pretrain_loss):
    """step(trainable, frozen, state, opt_state, batch, gen=None, epoch=1) ->
    (trainable, new state, opt_state, {"loss"}). `batch` holds wave (B, T,
    L), image (B, T, H, W, 3), label (the targets of `loss`) and optionally
    mixup_lambda (B*T,); `gen`, a torch.Generator on `device` (None: the
    card), draws SpecAugment, and None turns it off. Nothing passed in is
    changed."""
    device = resolve_device(device)

    def step(trainable, frozen, state, opt_state, batch, gen=None, epoch=1):
        def loss_fn(params):
            out, new_state = pretrain.forward(params, state, buffers, batch["wave"],
                                              batch["image"], cfg, train=True, device=device,
                                              gen=gen, mixup_lambda=batch.get("mixup_lambda"))
            return loss(out, batch["label"], epoch=epoch, num_frames=cfg.num_frames), new_state

        trainable, opt_state, value, new_state = update_step(opt, trainable, frozen, opt_state,
                                                             loss_fn)
        return trainable, new_state, opt_state, {"loss": value}

    return step


def make_pretrain_eval_step(cfg: PretrainModelConfig, buffers, *, device=None):
    """eval_step(trainable, frozen, state, batch) -> event_scores (B*T,
    n_cls): the eval forward with kernels on the adapters as loaded
    (unfolded: K2 in HTS-AT's 12 blocks, no K3)."""
    device = resolve_device(device)

    @torch.inference_mode()
    def eval_step(trainable, frozen, state, batch):
        return pretrain.forward(merge_params(trainable, frozen), state, buffers, batch["wave"],
                                batch["image"], cfg, kernels=True,
                                device=device)["event_scores"]

    return eval_step


def feed(batch, device, keys=("wave", "image")) -> dict:
    """A loader's numpy batch as tensors on `device`, the `keys` only (int16
    PCM wave scaled to [-1, 1])."""
    out = {}
    for k in keys:
        v = np.asarray(batch[k])
        if k == "wave" and v.dtype == np.int16:
            v = v.astype(np.float32) / 32767.0
        out[k] = torch.as_tensor(v, device=device)
    return out


def weak_accuracy(event_scores, weak_labels, *, num_frames):
    """Clip-level accuracy, %: the event scores meaned over segments, argmax
    against the weak label's argmax."""
    scores = np.asarray(torch.as_tensor(event_scores).float().cpu())
    clip = scores.reshape(scores.shape[0] // num_frames, num_frames, -1).mean(axis=1)
    return 100.0 * float(np.mean(clip.argmax(-1) == np.asarray(weak_labels).argmax(-1)))


def segment_accuracy(event_scores, gt):
    """Segment-level accuracy, %: argmax of (B*T, n_cls) scores against the
    argmax of (B, T, n_gt) GT (the GT's trailing background class, which the
    prompt set may lack, kept as the reference keeps it)."""
    scores = np.asarray(torch.as_tensor(event_scores).float().cpu())
    gt = np.asarray(gt)
    return 100.0 * float(np.mean(scores.argmax(-1) == gt.reshape(-1, gt.shape[-1]).argmax(-1)))


@torch.inference_mode()
def zero_shot_scores(params, state, buffers, wave, images, cfg, *, device=None):
    """The eval forward's segment-level event scores (B*T, n_cls), kernels on."""
    return pretrain.forward(params, state, buffers, wave, images, cfg,
                            device=device)["event_scores"]


def zero_shot_accuracy(event_scores, gt):
    """Segment-level argmax accuracy, % (a tensor), against (B, T, n_cls)
    one-hot GT."""
    gt = torch.as_tensor(gt, device=event_scores.device)
    B, T, _ = gt.shape
    pred = event_scores.reshape(B, T, -1).argmax(-1)
    return 100.0 * (pred == gt.argmax(-1)).float().mean()


def few_shot_subsample(labels, k_shot, *, seed=0):
    """Sorted indices of a K-shot subset: per class in id order, the class's
    indices shuffled by one RandomState(seed), the first k_shot kept."""
    rs = np.random.RandomState(seed)
    by_class = {}
    for i, c in enumerate(np.asarray(labels)):
        by_class.setdefault(int(c), []).append(i)
    keep = []
    for _, idxs in sorted(by_class.items()):
        idxs = np.asarray(idxs)
        rs.shuffle(idxs)
        keep.extend(idxs[:k_shot].tolist())
    return sorted(keep)
