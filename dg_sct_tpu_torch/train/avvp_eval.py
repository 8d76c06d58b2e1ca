"""AVVP segment-level and event-level F1 (numpy), as
`dg_sct_tpu/train/avvp_eval.py` has them (the reference's
`DG-SCT/AVE/utils/eval_metrics.py` and the eval loop of
`DG-SCT/AVVP/main.py`). Every score works on (25, 10) binary
class-by-segment grids, one video at a time.
"""
from __future__ import annotations

import numpy as np


def _per_class_f1(TP, FP, FN):
    """Mean F1 over the classes that have a prediction or a ground truth;
    1.0 when every class is a true negative."""
    F = [2 * TP[i] / (2 * TP[i] + (FN + FP)[i]) for i in range(len(TP))
         if (TP + FP)[i] != 0 or (TP + FN)[i] != 0]
    return sum(F) / len(F) if F else 1.0


def _f1s(counts, SO_a, SO_v, SO_av, GT_a, GT_v, GT_av):
    """(audio, visual, audio and visual pooled, audio-visual) F1 of `counts`."""
    TP_a, FP_a, FN_a = counts(SO_a, GT_a)
    TP_v, FP_v, FN_v = counts(SO_v, GT_v)
    TP_av, FP_av, FN_av = counts(SO_av, GT_av)
    return (_per_class_f1(TP_a, FP_a, FN_a), _per_class_f1(TP_v, FP_v, FN_v),
            _per_class_f1(TP_a + TP_v, FP_a + FP_v, FN_a + FN_v),
            _per_class_f1(TP_av, FP_av, FN_av))


def _segment_counts(SO, GT):
    return (np.sum(SO * GT, axis=1), np.sum(SO * (1 - GT), axis=1),
            np.sum((1 - SO) * GT, axis=1))


def segment_level(SO_a, SO_v, SO_av, GT_a, GT_v, GT_av):
    """One video's segment-level F1: (audio, visual, pooled, audio-visual)."""
    return _f1s(_segment_counts, SO_a, SO_v, SO_av, GT_a, GT_v, GT_av)


def extract_events(seq):
    """The contiguous runs of 1 in a binary sequence, each as an indicator
    vector of the sequence's length; None without a run."""
    runs, start = [], None
    for t in range(len(seq)):
        if seq[t] == 1 and start is None:
            start = t
        if (seq[t] != 1 or t == len(seq) - 1) and start is not None:
            vec = np.zeros(len(seq))
            vec[start:t + 1 if seq[t] == 1 else t] = 1
            runs.append(vec)
            start = None
    return runs or None


def _matches(x1, others):
    """Whether run x1 overlaps one of `others` by IoU >= 0.5."""
    return others is not None and any(
        np.sum(x1 * x2) >= 0.5 * np.sum(np.maximum(x1, x2)) for x2 in others)


def _event_counts(SO, GT):
    TP, FP, FN = (np.zeros(SO.shape[0]) for _ in range(3))
    for n in range(SO.shape[0]):
        ep = extract_events(SO[n]) if SO[n].sum() != 0 else None
        eg = extract_events(GT[n]) if GT[n].sum() != 0 else None
        for x1 in ep or ():
            if _matches(x1, eg):
                TP[n] += 1
            else:
                FP[n] += 1
        FN[n] += sum(not _matches(x1, ep) for x1 in eg or ())
    return TP, FP, FN


def event_level(SO_a, SO_v, SO_av, GT_a, GT_v, GT_av):
    """One video's event-level F1 (runs matched at IoU >= 0.5): (audio,
    visual, pooled, audio-visual)."""
    return _f1s(_event_counts, SO_a, SO_v, SO_av, GT_a, GT_v, GT_av)


def evaluate_video(out, GT_a, GT_v):
    """One video's outputs -> its 8 F1 scores. `out` holds global_prob (1,
    25) and a_frame_prob / v_frame_prob (1, 10, 25), arrays or tensors;
    GT_a / GT_v are (25, 10) binary annotations. A class is on in a segment
    when its frame probability and the clip's global probability both reach
    0.5."""
    prob = lambda k: np.asarray(out[k].cpu() if hasattr(out[k], "cpu") else out[k])
    o = (prob("global_prob")[0] >= 0.5).astype(np.int64)
    SO_a = ((prob("a_frame_prob")[0] >= 0.5).astype(np.int64) * o[None, :]).T
    SO_v = ((prob("v_frame_prob")[0] >= 0.5).astype(np.int64) * o[None, :]).T
    grids = (SO_a, SO_v, SO_a * SO_v, GT_a, GT_v, GT_a * GT_v)
    seg, evt = segment_level(*grids), event_level(*grids)
    return {"seg_a": seg[0], "seg_v": seg[1], "seg": seg[2], "seg_av": seg[3],
            "evt_a": evt[0], "evt_v": evt[1], "evt": evt[2], "evt_av": evt[3]}


def summarize(per_video):
    """The per-video dicts -> the reference's report, in %."""
    m = {k: 100.0 * float(np.mean([v[k] for v in per_video])) for k in per_video[0]}
    return {
        "segment_a": m["seg_a"], "segment_v": m["seg_v"], "segment_av": m["seg_av"],
        "segment_type_avg": (m["seg_a"] + m["seg_v"] + m["seg_av"]) / 3.0,
        "segment_event_avg": m["seg"],
        "event_a": m["evt_a"], "event_v": m["evt_v"], "event_av": m["evt_av"],
        "event_type_avg": (m["evt_a"] + m["evt_v"] + m["evt_av"]) / 3.0,
        "event_event_avg": m["evt"],
    }
