"""AVQA training: the loss and the stage-2 train and eval steps
(`dg_sct_tpu/train/avqa_train.py`; the reference is DG-SCT's
`net_grd_avst/main_avst.py`).

The loss is CE(answer) + 0.5 CE(match), the match batch being the positive
pairs (label 1) then the negative ones (label 0). The partitioning, merging
and optimizer are the AVE trainer's, as in the JAX package: the swin and
htsat towers are frozen and everything else (the adapters, the question
encoder, the grounding, attention and fusion heads) trains at `lr` under
StepLR. The model trains in `cfg.compute_dtype`, float32 for
`AVQAModelConfig()`.
"""
from __future__ import annotations

import torch

from ..configs import AVQAModelConfig
from ..device import resolve_device
from ..models import avqa
from ..parallel.comm import mean_over
from ..parallel.mesh import shard_generator
from . import losses
from .ave_train import make_optimizer, merge_params, partition_params  # noqa: F401  (shared)
from .ave_train import update_step
from .optim import AccumulatedAdam


def match_labels(n_pos, device):
    """The match classifier's labels: n_pos ones, then n_pos zeros."""
    return torch.cat([torch.ones(n_pos, dtype=torch.long, device=device),
                      torch.zeros(n_pos, dtype=torch.long, device=device)])


def avqa_loss(out, answer):
    """answer (B,) int labels."""
    posi, nega = out["out_match_posi"].float(), out["out_match_nega"].float()
    answer = torch.as_tensor(answer, device=posi.device).long()
    return (losses.cross_entropy(out["out_qa"].float(), answer)
            + 0.5 * losses.cross_entropy(torch.cat([posi, nega]),
                                         match_labels(posi.shape[0], posi.device)))


def make_train_step(cfg: AVQAModelConfig, opt: AccumulatedAdam, *, device=None,
                    remat_policy: str = "full", group=None):
    """train_step(trainable, frozen, state, opt_state, batch, gen=None) ->
    (trainable, new state, opt_state, {"loss", "qa_acc"}). `batch` holds
    wave (B, T, L), visual_posi and visual_nega (B, T, H, W, 3), question
    (B, 14), answer (B,) and optionally mixup_lambda (B*T,); `gen`, a
    torch.Generator on `device` (None: the card), draws SpecAugment,
    drop_path and the heads' dropout, and None turns them off. The negative
    frames run the frozen Swin-V2 alone without gradients (K1 and K2 on the
    card). Nothing passed in is changed. `group`: data parallelism, as
    `ave_train.make_train_step` takes it."""
    device = resolve_device(device)

    def train_step(trainable, frozen, state, opt_state, batch, gen=None):
        answer = torch.as_tensor(batch["answer"], device=device).long()

        def loss_fn(params):
            out, new_state = avqa.forward(params, state, batch["wave"], batch["visual_posi"],
                                          batch["visual_nega"], batch["question"], cfg,
                                          train=True, device=device,
                                          gen=shard_generator(gen, group),
                                          mixup_lambda=batch.get("mixup_lambda"),
                                          remat_policy=remat_policy, group=group)
            return avqa_loss(out, answer), (out["out_qa"].detach(), new_state)

        trainable, opt_state, loss, (qa, new_state) = update_step(opt, trainable, frozen,
                                                                  opt_state, loss_fn, group)
        acc = (qa.argmax(-1) == answer).float().mean()
        if group is not None:
            acc = mean_over(acc, group)
        return trainable, new_state, opt_state, {"loss": loss, "qa_acc": acc}

    return train_step


def make_eval_step(cfg: AVQAModelConfig, *, device=None):
    """eval_step(trainable, frozen, state, batch) -> out_qa (B, ans_vocab):
    the eval forward without the negative branch, kernels on (unfolded
    adapters: K1 and K2 run, and K3 on the audio adapters, which have no BN
    and no gate to fold)."""
    device = resolve_device(device)

    @torch.inference_mode()
    def eval_step(trainable, frozen, state, batch):
        return avqa.forward(merge_params(trainable, frozen), state, batch["wave"],
                            batch["visual_posi"], None, batch["question"], cfg, kernels=True,
                            device=device)["out_qa"]

    return eval_step
