"""Loss library of `dg_sct_tpu/train/losses.py`.

The AVE loss (`DG-SCT/AVE/main_trans.py:119-130`): BCE(is_event, fg) +
BCE(gate, fg) + CE(event_scores, cls) + CE(av_score, cls). The others are
the criterion library's (`DG-SCT/AVE/criterion.py`), dormant in the
reference.
"""
from __future__ import annotations

import torch


def bce_with_logits(logits, targets, weight=None):
    """Mean BCE with logits (torch nn.BCEWithLogitsLoss semantics)."""
    loss = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if weight is not None:
        loss = loss * weight
    return loss.mean()


def cross_entropy(logits, labels):
    """Mean CE over integer labels (torch nn.CrossEntropyLoss semantics)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean()


def info_nce(features_a, features_b, temperature=0.07):
    """Symmetric InfoNCE over paired embeddings (criterion.py InfoNCELoss)."""
    a = features_a / (features_a.norm(dim=-1, keepdim=True) + 1e-8)
    b = features_b / (features_b.norm(dim=-1, keepdim=True) + 1e-8)
    logits = a @ b.T / temperature
    labels = torch.arange(a.shape[0], device=a.device)
    return 0.5 * (cross_entropy(logits, labels) + cross_entropy(logits.T, labels))


def contrastive_loss(x0, x1, y, margin=1.0):
    """Euclidean contrastive loss (criterion.py ContrastiveLoss). y: 1 =
    similar."""
    dist_sq = (x0 - x1).square().sum(1)
    mdist = torch.clamp(margin - torch.sqrt(dist_sq + 1e-12), min=0.0)
    return (y * dist_sq + (1.0 - y) * mdist.square()).mean() / 2.0


def mask_info_nce(q, k, mask, temperature=0.05):
    """Masked InfoNCE (criterion.py MaskInfoNCELoss): NCE over normalized
    q and k with the positives of each row selected by `mask`."""
    qn = q / (q.norm(dim=1, keepdim=True) + 1e-8)
    kn = k / (k.norm(dim=1, keepdim=True) + 1e-8)
    logp = torch.log_softmax(qn @ kn.T / temperature, dim=-1)
    pos = (logp * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
    return -pos.mean()


def ave_labels(gt):
    """gt: (B, T, 29) one-hot with background 28 -> (foreground flag (B, T),
    the clip's event class (B,): the max over segments of each segment's
    argmax over the foreground classes)."""
    fg = gt[:, :, :-1]
    return fg.amax(-1), fg.argmax(-1).amax(-1)


def ave_loss(outputs, gt):
    """The reference's composite AVE loss; the logits are reduced in
    float32 whatever the compute type (float64 for float64 logits)."""
    out = {k: v.to(torch.promote_types(v.dtype, torch.float32)) for k, v in outputs.items()}
    labels_bce, labels_event = ave_labels(torch.as_tensor(gt, device=out["event_scores"].device))
    return (bce_with_logits(out["is_event_scores"], labels_bce)
            + bce_with_logits(out["av_gate"], labels_bce)
            + cross_entropy(out["event_scores"], labels_event)
            + cross_entropy(out["av_score"], labels_event))
