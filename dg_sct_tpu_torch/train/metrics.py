"""Evaluation metrics. AVE accuracy mirrors `compute_accuracy_supervised`
(`DG-SCT/AVE/main_trans.py:309-325`)."""
from __future__ import annotations

import torch

BACKGROUND = 28


def ave_accuracy_tensor(is_event_scores, event_scores, gt):
    """is_event_scores (B, T) logits, event_scores (B, 28), gt (B, T, 29)
    one-hot; arrays or tensors. Each segment is predicted background (28)
    unless sigmoid(is_event) > 0.5, else the clip's argmax class. Returns
    the percentage of segments predicted right, a float32 tensor on gt's
    device (no wait for the device)."""
    ie, ev, gt = (torch.as_tensor(a) for a in (is_event_scores, event_scores, gt))
    targets = gt.argmax(-1)
    cls = ev.argmax(-1)[:, None].to(targets.device)
    pred = torch.where(torch.sigmoid(ie.float()).to(targets.device) > 0.5, cls,
                       torch.full_like(cls, BACKGROUND))
    return 100.0 * (pred == targets).float().mean()


def ave_accuracy(is_event_scores, event_scores, gt) -> float:
    """`ave_accuracy_tensor` as a Python float."""
    return ave_accuracy_tensor(is_event_scores, event_scores, gt).item()
