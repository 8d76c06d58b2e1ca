"""AVS training: the S4 and MS3 losses and the train and eval steps
(`dg_sct_tpu/train/avs_train.py`; the reference's losses are AVSBench's
`avs_s4/loss.py` and `avs_ms3/loss.py`).

The partitioning, merging and optimizer are the AVE trainer's, as in the
JAX package: the swin and htsat towers are frozen, everything else (the
adapters, the per-scale linears, the temporal head, TPAVI and the FPN
decoder) trains at `lr` under StepLR. The model trains in
`cfg.compute_dtype`, float32 for `AVSModelConfig()`. Mask tensors are
channels-last: logits (B*T, H, W, 1).
"""
from __future__ import annotations

import torch

from ..configs import AVSModelConfig
from ..device import resolve_device
from ..models import avs
from ..parallel.mesh import shard_generator
from .ave_train import make_optimizer, merge_params, partition_params  # noqa: F401  (shared)
from .ave_train import update_step
from .optim import AccumulatedAdam


def _bce_of_logits(logits, gt):
    """Mean BCE of sigmoid(logits) clipped to [1e-7, 1 - 1e-7]."""
    p = torch.sigmoid(logits).clamp(1e-7, 1 - 1e-7)
    return -(gt * torch.log(p) + (1 - gt) * torch.log1p(-p)).mean()


def f1_iou_bce_loss(pred_logits, first_gt_mask, num_frames=5):
    """BCE of each clip's first frame only (S4). pred (B*T, H, W, 1),
    first_gt_mask (B, H, W, 1)."""
    return _bce_of_logits(pred_logits[::num_frames], first_gt_mask)


def f5_iou_bce_loss(pred_logits, gt_masks):
    """BCE over every frame (MS3). pred and gt (B*T, H, W, 1)."""
    return _bce_of_logits(pred_logits, gt_masks)


def adaptive_avg_pool(x, H, W):
    """`nn.AdaptiveAvgPool2d((H, W))` for sizes that divide evenly (224 ->
    56/28/14/7): window means. x (N, H_in, W_in, C)."""
    N, H_in, W_in, C = x.shape
    assert H_in % H == 0 and W_in % W == 0, (H_in, W_in, H, W)
    return x.reshape(N, H, H_in // H, W, W_in // W, C).mean(dim=(2, 4))


def _unit(x, eps):
    return x / (x.norm(dim=-1, keepdim=True) + eps)


def masked_av_simm_loss(pred_logits, a_fea_list, v_map_list, count_stages):
    """The masked audio-visual similarity loss, S4's variant: sigmoid, pool to
    each stage's grid, threshold at 0.5; the mean of each visual map over
    its object against the audio feature, -log(relu(cos) + 1e-6), averaged
    over the stages."""
    pred = torch.sigmoid(pred_logits)
    total = 0.0
    for stage in count_stages:
        a_fea, v_map = a_fea_list[stage], v_map_list[stage]
        _, H, W, _ = v_map.shape
        m = (adaptive_avg_pool(pred, H, W) > 0.5).to(v_map.dtype)
        pooled = (v_map * m).sum((1, 2)) / (m.sum((1, 2)) + 1e-6)
        a = _unit(a_fea.reshape(-1, a_fea.shape[-1]), 1e-8)
        cos = torch.relu((a * _unit(pooled, 1e-8)).sum(-1)) + 1e-6
        total = total + (-torch.log(cos)).mean()
    return total / max(len(count_stages), 1)


def masked_av_kl_loss(pred_logits, a_fea_list, v_map_list, count_stages, *, norm_fea=True):
    """The masked audio-visual loss, MS3's KL variant: pool the raw logits to
    each stage's grid, then sigmoid (the reverse of S4's order); the soft-
    masked mean of the visual map and the audio feature, each L2-normalized,
    as KL(softmax(audio) || softmax(visual)) summed over the batch, averaged
    over the stages (`F.kl_div(log_softmax(v), softmax(a), reduction="sum")`)."""
    total = 0.0
    for stage in count_stages:
        a_fea, v_map = a_fea_list[stage], v_map_list[stage]
        _, H, W, _ = v_map.shape
        a = a_fea.reshape(-1, a_fea.shape[-1])
        masked_v = (v_map * torch.sigmoid(adaptive_avg_pool(pred_logits, H, W))).mean((1, 2))
        if norm_fea:
            a, masked_v = _unit(a, 1e-12), _unit(masked_v, 1e-12)
        p = torch.softmax(a, dim=-1)
        total = total + (p * (torch.log(p + 1e-20) - torch.log_softmax(masked_v, dim=-1))).sum()
    return total / max(len(count_stages), 1)


def iou_semantic_aware_loss(out, first_gt_mask, *, lambda_1=0.0, count_stages=(),
                            sa_loss_flag=False, num_frames=5):
    """S4's composition: first-frame BCE, plus lambda_1 times the similarity
    loss with `sa_loss_flag` (off in the reference's S4 recipe)."""
    loss = f1_iou_bce_loss(out["pred"], first_gt_mask, num_frames)
    if sa_loss_flag and count_stages:
        loss = loss + lambda_1 * masked_av_simm_loss(out["pred"], out["a_fea_list"],
                                                     out["feature_map_list"], count_stages)
    return loss


def ms3_loss(out, gt_masks, *, lambda_1=0.5, count_stages=(0, 1, 2, 3), sa_loss_flag=True):
    """MS3's composition (the reference's `avs_ms3/train.sh`): all-frame BCE
    plus 0.5 times the KL loss over the stages that have a TPAVI audio
    feature."""
    loss = f5_iou_bce_loss(out["pred"], gt_masks)
    count_stages = tuple(s for s in count_stages if out["a_fea_list"][s] is not None)
    if sa_loss_flag and count_stages:
        loss = loss + lambda_1 * masked_av_kl_loss(out["pred"], out["a_fea_list"],
                                                   out["feature_map_list"], count_stages)
    return loss


TASKS = ("s4", "ms3")


def make_train_step(cfg: AVSModelConfig, opt: AccumulatedAdam, *, task: str = "s4",
                    device=None, remat_policy: str = "full", group=None):
    """train_step(trainable, frozen, state, opt_state, batch, gen=None) ->
    (trainable, new state, opt_state, {"loss"}). `batch` holds image (B, T,
    H, W, 3), wave (B, T, L), mask (S4: (B, H, W, 1), the first frame; MS3:
    (B*T, H, W, 1)) and optionally mixup_lambda (B*T,); `gen`, a
    torch.Generator on `device` (None: the card), draws SpecAugment,
    drop_path and the head's dropout, and None turns them off. Nothing
    passed in is changed. `group`: data parallelism, as
    `ave_train.make_train_step` takes it."""
    if task not in TASKS:
        raise ValueError(f"task {task!r} not in {TASKS}")
    device = resolve_device(device)

    def train_step(trainable, frozen, state, opt_state, batch, gen=None):
        mask = torch.as_tensor(batch["mask"], device=device)

        def loss_fn(params):
            out, new_state = avs.forward(params, state, batch["image"], batch["wave"], cfg,
                                         train=True, device=device,
                                         gen=shard_generator(gen, group),
                                         mixup_lambda=batch.get("mixup_lambda"),
                                         remat_policy=remat_policy, group=group)
            loss = (f1_iou_bce_loss(out["pred"], mask, cfg.num_frames) if task == "s4"
                    else ms3_loss(out, mask))
            return loss, new_state

        # the leaves the forward never reads (the head's decoders, path4's skip
        # unit, the AVS adapters' ln_before and token_resample) take zero gradients
        trainable, opt_state, loss, new_state = update_step(opt, trainable, frozen, opt_state,
                                                            loss_fn, group)
        return trainable, new_state, opt_state, {"loss": loss}

    return train_step


def make_eval_step(cfg: AVSModelConfig, *, device=None):
    """eval_step(trainable, frozen, state, batch) -> sigmoid(pred) (B*T, H,
    W, 1): the eval forward with kernels on (K1 and K2 run; the AVS adapters
    never run K3)."""
    device = resolve_device(device)

    @torch.inference_mode()
    def eval_step(trainable, frozen, state, batch):
        out = avs.forward(merge_params(trainable, frozen), state, batch["image"], batch["wave"],
                          cfg, kernels=True, device=device)
        return torch.sigmoid(out["pred"])

    return eval_step
