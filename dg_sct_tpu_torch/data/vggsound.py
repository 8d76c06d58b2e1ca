"""VGGSound-AVEL-40K, the pretrain suite's training corpus
(`dg_sct_tpu/data/vggsound.py`; the reference's `pretrain/dataloader.py`,
vggsound branch).

`VggsoundAVEL40kCategories.txt` lists the classes; the labels csv has the
columns video_id, split, category and label, the last a Python list
literal of 10 per-second event flags. An item's `GT` is a (T, n_cls + 1)
one-hot grid with background last; `image` the T frames of the video's jpg
directory, `wave` (T, segment_samples). With `shot > 0` the train split
keeps the first `shot` rows of each category in csv order.

The csv is read with the standard `csv` module (the card machine has no
pandas) and ids as pandas reads them: when every `video_id` of the file is
a number, pandas makes the column integers, so "000123" and "123" both
name video 000123; otherwise each id stays as written, digit-only ones
zero-filled to 6 characters.
"""
from __future__ import annotations

import ast
import csv
import os
from typing import List, Optional

import numpy as np

from .ave import load_frames, load_wave


def load_categories(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def weak_labels(gt: np.ndarray) -> np.ndarray:
    """Clip-level labels from (B, T, n_cls + 1) segment grids: the background
    column dropped, the first frame with any event; all-background clips get
    a zero vector. -> (B, n_cls)."""
    gt = np.asarray(gt)[:, :, :-1]
    out = np.zeros(gt.shape[::2], dtype=gt.dtype)
    for b in range(gt.shape[0]):
        nz = np.nonzero(gt[b].max(axis=-1))[0]
        if len(nz):
            out[b] = gt[b, nz[0]]
    return out


def _video_names(ids: List[str]) -> List[str]:
    if ids and all(v.strip().isdigit() for v in ids):
        return [str(int(v)).zfill(6) for v in ids]
    return [v.zfill(6) if v.isdigit() else v for v in ids]


class VGGSoundAVELDataset:
    def __init__(self, root: str, split: str = "train", frame_dir: Optional[str] = None,
                 audio_dir: Optional[str] = None, img_size: int = 224, num_frames: int = 10,
                 segment_samples: int = 32000, shot: int = 0):
        self.categories = load_categories(os.path.join(root, "VggsoundAVEL40kCategories.txt"))
        self.cat_idx = {c: i for i, c in enumerate(self.categories)}
        with open(os.path.join(root, "vggsound-avel40k_labels.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        names = _video_names([r["video_id"] for r in rows])
        rows = [dict(r, name=n) for r, n in zip(rows, names) if r["split"] == split]
        if split == "train" and shot > 0:
            by_cat: dict = {}
            for i, r in enumerate(rows):
                by_cat.setdefault(r["category"], []).append(i)
            rows = [rows[i] for i in sorted(i for lst in by_cat.values() for i in lst[:shot])]
        self.rows = rows
        self.frame_dir = frame_dir
        self.audio_dir = audio_dir
        self.img_size = img_size
        self.num_frames = num_frames
        self.segment_samples = segment_samples

    @property
    def num_classes(self):
        return len(self.categories)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        row = self.rows[i]
        flags = np.asarray(ast.literal_eval(row["label"]))
        n = len(self.categories)
        gt = np.zeros((self.num_frames, n + 1), np.float32)
        cat = self.cat_idx[row["category"]]
        for t, src in enumerate(np.linspace(0, len(flags) - 1, self.num_frames).astype(int)):
            gt[t, cat if flags[src] == 1 else n] = 1.0
        return {"image": load_frames(self.frame_dir, row["name"], self.num_frames,
                                     img_size=self.img_size),
                "wave": load_wave(self.audio_dir, row["name"], self.num_frames,
                                  self.segment_samples),
                "GT": gt}
