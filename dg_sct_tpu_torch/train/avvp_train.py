"""AVVP training: the loss and the train and eval steps
(`dg_sct_tpu/train/avvp_train.py`; the reference is `DG-SCT/AVVP/main.py`).

The loss is BCE on clamped probabilities for the clip (global), audio and
visual heads, the visual target smoothed to 0.9 t + 0.05, plus the
cross-entropy that makes each class token classify as its own class. The
partitioning, merging and optimizer are the AVE trainer's, as in the JAX
package: the swin and htsat towers are frozen and everything else (the
adapters, the projections, the temporal gates, the grouping heads, the
class tokens) trains at `lr` under StepLR. The model trains in
`cfg.compute_dtype`, float32 for `AVVPModelConfig()`.
"""
from __future__ import annotations

import torch

from ..configs import AVVPModelConfig
from ..device import resolve_device
from ..models import avvp
from . import losses
from .ave_train import make_optimizer, merge_params, partition_params  # noqa: F401  (shared)
from .ave_train import update_step
from .optim import AccumulatedAdam


def bce_probs(probs, targets):
    """Mean BCE of probabilities clamped to [1e-7, 1 - 1e-7] (torch's
    nn.BCELoss on clamped inputs)."""
    p = probs.clamp(1e-7, 1.0 - 1e-7)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p)).mean()


def avvp_loss(out, target):
    """target (B, 25) weak multi-label; the reference's audio smoothing is
    a = 1.0 (no change) and its visual one v = 0.9."""
    out = {k: v.float() for k, v in out.items()}
    target = torch.as_tensor(target, device=out["global_prob"].device).float()
    cls_target = torch.arange(out["aud_cls_prob"].shape[0], device=target.device)
    return (bce_probs(out["global_prob"], target)
            + bce_probs(out["a_prob"], target)
            + bce_probs(out["v_prob"], 0.9 * target + 0.05)
            + losses.cross_entropy(out["aud_cls_prob"], cls_target)
            + losses.cross_entropy(out["vis_cls_prob"], cls_target))


def make_train_step(cfg: AVVPModelConfig, opt: AccumulatedAdam, *, device=None,
                    remat_policy: str = "full"):
    """train_step(trainable, frozen, state, opt_state, batch, gen=None) ->
    (trainable, new state, opt_state, {"loss"}). `batch` holds wave (B, T,
    L), image (B, T, H, W, 3), video_st (B, T, 512), target (B, 25) and
    optionally mixup_lambda (B*T,); `gen`, a torch.Generator on `device`
    (None: the card), draws SpecAugment, drop_path, dropout and the HAN's
    Gumbel noise, and None turns them off. Nothing passed in is changed."""
    device = resolve_device(device)

    def train_step(trainable, frozen, state, opt_state, batch, gen=None):
        def loss_fn(params):
            out, new_state = avvp.forward(params, state, batch["wave"], batch["image"],
                                          batch["video_st"], cfg, train=True, device=device,
                                          gen=gen, mixup_lambda=batch.get("mixup_lambda"),
                                          remat_policy=remat_policy)
            return avvp_loss(out, batch["target"]), new_state

        trainable, opt_state, loss, new_state = update_step(opt, trainable, frozen, opt_state,
                                                            loss_fn)
        return trainable, new_state, opt_state, {"loss": loss}

    return train_step


def make_eval_step(cfg: AVVPModelConfig, *, device=None):
    """eval_step(trainable, frozen, state, batch) -> the eval forward's
    outputs, with kernels on (unfolded adapters: K1 and K2 run, K3 does
    not)."""
    device = resolve_device(device)

    @torch.inference_mode()
    def eval_step(trainable, frozen, state, batch):
        return avvp.forward(merge_params(trainable, frozen), state, batch["wave"], batch["image"],
                            batch["video_st"], cfg, kernels=True, device=device)

    return eval_step
