"""The reference's freezing policy and learning-rate schedule
(`DG-SCT/AVE/main_trans.py:211-279`), as `dg_sct_tpu/train/optim.py` has
them: the swin and htsat towers are frozen; `mlp_class` trains at `lr_mlp`,
every other root at `lr`; StepLR over optimizer updates."""
from __future__ import annotations

import math

import torch

from ..utils.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

FROZEN_ROOTS = ("swin", "htsat")
MLP_LR_ROOTS = ("mlp_class",)


def param_group(path) -> str:
    """A parameter path's group: "frozen", "mlp" or "train"."""
    root = str(path[0])
    if root in FROZEN_ROOTS:
        return "frozen"
    if root in MLP_LR_ROOTS:
        return "mlp"
    return "train"


def group_labels(params):
    """The tree of `params` with each leaf replaced by its group."""
    return tree_unflatten(params, [param_group(p) for p, _ in tree_paths(params)])


def step_lr(base_lr: float, decay_epoch: int, decay: float, steps_per_epoch: int):
    """StepLR(step_size=decay_epoch, gamma=decay) as a function of the
    optimizer's update count."""
    def sched(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * (decay ** (epoch // decay_epoch))
    return sched


class AccumulatedAdam:
    """Adam with optax's defaults over float32 masters, behind gradient
    accumulation as `optax.MultiSteps(adam, every_k)` does it.

    Each mini-step folds its gradients into a running mean (acc + (g - acc)
    / (n + 1)); on the every_k-th the mean goes through Adam (moments,
    bias correction, -lr * m / (sqrt(v) + eps)) and the parameters change,
    and on the others neither the parameters nor the moments do. The
    schedule of a leaf's group sees the count of applied updates, not of
    mini-steps. Functional: `update` returns new tensors and leaves its
    arguments as they were."""

    b1, b2, eps = 0.9, 0.999, 1e-8     # optax.adam's defaults (eps_root 0)

    def __init__(self, schedules: dict, every_k: int = 1):
        self.schedules = schedules      # group -> count -> lr
        self.every_k = every_k

    def init(self, params) -> dict:
        zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)
        return {"mini_step": 0, "gradient_step": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params), "acc": tree_map(zeros, params)}

    def update(self, grads, state, params):
        """grads: the gradient of each leaf of `params` in leaf order ->
        (new params, new state)."""
        n = state["mini_step"]
        acc = tree_leaves(state["acc"])
        acc = torch._foreach_add(acc, torch._foreach_div(torch._foreach_sub(list(grads), acc),
                                                         float(n + 1)))
        if n + 1 < self.every_k:
            return params, dict(state, mini_step=n + 1, acc=tree_unflatten(state["acc"], acc))
        count = state["gradient_step"]
        b1, b2, t = self.b1, self.b2, count + 1
        mu = torch._foreach_add(torch._foreach_mul(acc, 1.0 - b1),
                                torch._foreach_mul(tree_leaves(state["mu"]), b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(acc, acc), 1.0 - b2),
                                torch._foreach_mul(tree_leaves(state["nu"]), b2))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - b2 ** t)),
                                   self.eps)
        step = torch._foreach_div(torch._foreach_div(mu, 1.0 - b1 ** t), denom)
        paths = tree_paths(params)
        new = [None] * len(paths)
        for group, sched in self.schedules.items():
            idx = [i for i, (path, _) in enumerate(paths) if param_group(path) == group]
            if idx:
                moved = torch._foreach_add([paths[i][1] for i in idx], [step[i] for i in idx],
                                           alpha=-sched(count))
                for i, p in zip(idx, moved):
                    new[i] = p
        missing = [paths[i][0] for i, p in enumerate(new) if p is None]
        if missing:
            raise KeyError(f"no learning-rate schedule for {missing[:3]}")
        return tree_unflatten(params, new), {
            "mini_step": 0, "gradient_step": t, "mu": tree_unflatten(state["mu"], mu),
            "nu": tree_unflatten(state["nu"], nu),
            "acc": tree_map(torch.zeros_like, state["acc"])}


def clip_by_global_norm(grads, max_norm: float):
    """`optax.clip_by_global_norm`: where the global norm g of `grads` (a
    list of tensors) is at least `max_norm`, each gradient becomes t / g *
    max_norm; below it they stay as they are. No epsilon (unlike
    `torch.nn.utils.clip_grad_norm_`), and no host sync."""
    grads = list(grads)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]


class ClippedAdam(AccumulatedAdam):
    """`optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))`:
    each mini-step's gradients clipped by their global norm, then Adam (one
    mini-step an update)."""

    def __init__(self, schedules: dict, max_norm: float):
        super().__init__(schedules, every_k=1)
        self.max_norm = max_norm

    def update(self, grads, state, params):
        return super().update(clip_by_global_norm(grads, self.max_norm), state, params)


def count_params(params):
    """(total, trainable, frozen) parameter counts, the accounting printed at
    main_trans.py:271-273."""
    total = trainable = 0
    for path, leaf in tree_paths(params):
        n = math.prod(leaf.shape)
        total += n
        if param_group(path) != "frozen":
            trainable += n
    return total, trainable, total - trainable
