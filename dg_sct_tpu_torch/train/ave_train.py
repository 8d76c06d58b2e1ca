"""AVE train and eval steps (`dg_sct_tpu/train/ave_train.py`; the
reference's loop is `DG-SCT/AVE/main_trans.py:83-143`).

The frozen towers are partitioned out of the differentiated tree: their
leaves never take `requires_grad`, so the backward pass makes no weight
gradient for them, while activation gradients still flow through their
blocks to the adapters before them. Training computes in
`cfg.compute_dtype` over float32 Adam masters: the forward casts the
parameters, and the gradients come back through the cast in float32.
"""
from __future__ import annotations

import torch

from ..configs import AVEModelConfig, TrainConfig
from ..device import resolve_device
from ..models import ave
from ..models.ave import cast_for_compute  # noqa: F401  (the forward casts; JAX's name)
from ..parallel.comm import average_, mean_over
from ..parallel.mesh import shard_generator
from ..utils.tree import tree_leaves, tree_unflatten
from . import losses
from .metrics import ave_accuracy_tensor
from .optim import AccumulatedAdam, param_group, step_lr


def partition_params(params):
    """(trainable, frozen) top-level subtrees by the freezing policy."""
    trainable = {k: v for k, v in params.items() if param_group((k,)) != "frozen"}
    frozen = {k: v for k, v in params.items() if k not in trainable}
    return trainable, frozen


def merge_params(trainable, frozen):
    out = dict(frozen)
    out.update(trainable)
    return out


def make_optimizer(trainable, train_cfg: TrainConfig, steps_per_epoch: int) -> AccumulatedAdam:
    """Adam with StepLR per group (`mlp` at lr_mlp, the rest at lr) over
    `train_cfg.accum_steps` mini-steps an update."""
    del trainable  # the groups come from each leaf's path
    sched = lambda lr: step_lr(lr, train_cfg.decay_epoch, train_cfg.decay, steps_per_epoch)
    return AccumulatedAdam({"train": sched(train_cfg.lr), "mlp": sched(train_cfg.lr_mlp)},
                           every_k=max(train_cfg.accum_steps, 1))


def update_step(opt: AccumulatedAdam, trainable, frozen, opt_state, loss_fn, group=None):
    """One mini-step of `opt` on `trainable`: `loss_fn(params)` -> (loss, aux)
    on the merged tree whose trainable leaves take gradients -> (trainable,
    opt_state, the loss detached, aux). A leaf the loss never reads (weights
    kept for checkpoint parity) gets a zero gradient, as under jax.grad.
    Nothing passed in is changed.

    With `group` (data parallelism: each rank's loss is the mean over its
    equal share of the global batch) the gradients are averaged over the
    group before the update, so every rank applies the global batch's
    gradient and the ranks' parameters stay identical; the loss returned is
    the group's mean."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(trainable)]
    loss, aux = loss_fn(merge_params(tree_unflatten(trainable, leaves), frozen))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    loss = loss.detach()
    if group is not None:
        average_(grads, group)
        loss = mean_over(loss, group).to(loss.dtype)
    trainable, opt_state = opt.update(grads, opt_state, trainable)
    return trainable, opt_state, loss, aux


def make_train_step(cfg: AVEModelConfig, opt: AccumulatedAdam, *, device=None,
                    remat_policy: str = "full", group=None):
    """train_step(trainable, frozen, state, opt_state, batch, gen=None) ->
    (trainable, new state, opt_state, {"loss", "acc"}). `batch` holds wave
    (B, T, L), image (B, T, H, W, 3), gt (B, T, 29) and optionally
    mixup_lambda (B*T,); `gen`, a torch.Generator on `device` (None: the
    card), draws SpecAugment, drop_path and dropout, and None turns them
    off. Nothing passed in is changed.

    `group`: data parallelism. `batch` is this rank's rows of the global
    batch (`parallel.mesh.shard_batch`), `gen` holds the same seed on every
    rank and draws the global batch's draws, of which the rank keeps its
    rows; BN statistics and mixup span the global batch, the gradients are
    averaged and the metrics are the group's means. The step equals one
    process's step on the global batch."""
    device = resolve_device(device)

    def train_step(trainable, frozen, state, opt_state, batch, gen=None):
        gt = torch.as_tensor(batch["gt"], device=device)
        draws = shard_generator(gen, group)

        def loss_fn(params):
            out, new_state = ave.forward(params, state, batch["wave"], batch["image"], cfg,
                                         train=True, device=device, gen=draws,
                                         mixup_lambda=batch.get("mixup_lambda"),
                                         remat_policy=remat_policy, group=group)
            return losses.ave_loss(out, gt), (out, new_state)

        trainable, opt_state, loss, (out, new_state) = update_step(opt, trainable, frozen,
                                                                   opt_state, loss_fn, group)
        acc = ave_accuracy_tensor(out["is_event_scores"].detach(),
                                  out["event_scores"].detach(), gt)
        if group is not None:
            acc = mean_over(acc, group)
        return trainable, new_state, opt_state, {"loss": loss, "acc": acc}

    return train_step


def make_eval_step(cfg: AVEModelConfig, *, device=None):
    """eval_step(trainable, frozen, state, batch) -> {"correct_frac",
    "outputs"}: the eval forward with kernels on (unfolded adapters: K1 and
    K2 run, K3 does not)."""
    device = resolve_device(device)

    @torch.inference_mode()
    def eval_step(trainable, frozen, state, batch):
        out = ave.forward(merge_params(trainable, frozen), state, batch["wave"], batch["image"],
                          cfg, kernels=True, device=device)
        correct = ave_accuracy_tensor(out["is_event_scores"], out["event_scores"],
                                      torch.as_tensor(batch["gt"], device=device))
        return {"correct_frac": correct / 100.0, "outputs": out}

    return eval_step
