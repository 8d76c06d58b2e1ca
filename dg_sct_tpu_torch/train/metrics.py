"""Evaluation metrics. AVE accuracy mirrors `compute_accuracy_supervised`
(`DG-SCT/AVE/main_trans.py:309-325`); the AVS mask metrics (numpy) mirror
AVSBench's `utility.py` as `dg_sct_tpu/train/metrics.py` does."""
from __future__ import annotations

import os

import numpy as np
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


def mask_iou(pred_probs, gt, eps=1e-7):
    """Binary mask IoU at 0.5 averaged over the masks, (N, H, W) sigmoid
    probabilities against (N, H, W) ground truth; an all-background ground
    truth scores the background's agreement instead (AVS `utility.py:45-70`)."""
    pred = (np.asarray(pred_probs) > 0.5).astype(np.float32).reshape(len(pred_probs), -1)
    gt = (np.asarray(gt) > 0.5).astype(np.float32).reshape(len(gt), -1)
    inter = (pred * gt).sum(-1)
    union = np.maximum(pred, gt).sum(-1)
    no_obj = gt.sum(-1) == 0
    inter[no_obj] = ((1 - gt) * (1 - pred)).sum(-1)[no_obj]
    union[no_obj] = gt.shape[-1]
    return float(np.mean(inter / (union + eps)))


def f_measure(pred_probs, gt, beta2=0.3, pr_num=255):
    """AVS `Eval_Fmeasure` (`utility.py:88-120`): per mask, precision and
    recall at `pr_num` thresholds; the F-curves averaged over the masks with
    an object, and the curve's maximum. pred_probs: (N, H, W) probabilities."""
    pred = np.asarray(pred_probs).reshape(len(pred_probs), -1)
    gt = (np.asarray(gt).reshape(len(gt), -1) > 0.5).astype(np.float32)
    ths = np.linspace(0.0, 1.0 - 1e-10, pr_num)
    avg_f = np.zeros(pr_num)
    img_num = 0
    for i in range(len(pred)):
        if gt[i].mean() == 0.0:
            continue
        binary = pred[i][None, :] >= ths[:, None]
        tp = (binary * gt[i][None, :]).sum(-1)
        prec = tp / (binary.sum(-1) + 1e-20)
        rec = tp / (gt[i].sum() + 1e-20)
        with np.errstate(invalid="ignore"):  # 0/0 at empty thresholds -> nan -> 0
            f = (1 + beta2) * prec * rec / (beta2 * prec + rec)
        avg_f += np.nan_to_num(f)
        img_num += 1
    if img_num == 0:
        return 0.0
    return float((avg_f / img_num).max())


def save_masks(pred_probs, save_base_path, categories, video_names, num_frames=5):
    """Thresholded masks as P-mode PNGs,
    `<base>/<category>/<video>/<video>_<t>.png` (AVS `save_mask`).
    pred_probs: (B*T, H, W) probabilities."""
    from PIL import Image

    masks = (np.asarray(pred_probs) > 0.5).astype(np.uint8) * 255
    masks = masks.reshape(-1, num_frames, *masks.shape[-2:])
    for idx, (cat, vid) in enumerate(zip(categories, video_names)):
        d = os.path.join(save_base_path, cat, vid)
        os.makedirs(d, exist_ok=True)
        for t in range(num_frames):
            Image.fromarray(masks[idx, t]).convert("P").save(
                os.path.join(d, f"{vid}_{t}.png"), format="PNG")
