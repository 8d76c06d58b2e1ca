"""LLP (AVVP) data: the 25 categories, the tab-separated label and
annotation files, the map-style dataset and a seeded synthetic batch
(`dg_sct_tpu/data/avvp.py`; the reference is `DG-SCT/AVVP/dataloader.py`).

Items: `image` (T, H, W, 3) ImageNet-normalized float32, `wave` (T, L)
(float32, or int16 PCM kept for the device), `target` (25,) weak
multi-label, `video` the 11-character YouTube id and, with an `st_dir`,
`video_st` (T, 512) r2plus1d features from `<id>.npy`.

The csv files are tab-separated with a header row. They are read with the
standard `csv` module (rows as pandas reads them: blank lines skipped,
onsets and offsets numbers, an empty label field labelling nothing).
"""
from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from .ave import load_frames, load_wave

CATEGORIES = [
    "Speech", "Car", "Cheering", "Dog", "Cat", "Frying_(food)", "Basketball_bounce",
    "Fire_alarm", "Chainsaw", "Cello", "Banjo", "Singing", "Chicken_rooster",
    "Violin_fiddle", "Vacuum_cleaner", "Baby_laughter", "Accordion", "Lawn_mower",
    "Motorcycle", "Helicopter", "Acoustic_guitar", "Telephone_bell_ringing",
    "Baby_cry_infant_cry", "Blender", "Clapping"]

CAT_IDX = {c: i for i, c in enumerate(CATEGORIES)}


def _rows(path: str):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def _labels(field):
    return [CAT_IDX[lab] for lab in (field or "").split(",") if lab in CAT_IDX]


def parse_label_csv(path: str):
    """Rows `filename<TAB>event_labels` -> [(video_id, multihot (25,))]."""
    out = []
    for row in _rows(path):
        target = np.zeros(len(CATEGORIES), np.float32)
        target[_labels(row["event_labels"])] = 1.0
        out.append((row["filename"], target))
    return out


def parse_eval_csv(path: str, num_segments: int = 10):
    """AVVP_eval_audio/visual.csv rows `filename, onset, offset,
    event_labels` (second-level annotations) -> {video id (11 characters):
    (25, num_segments) int64 grid}."""
    ann = {}
    for row in _rows(path):
        grid = ann.setdefault(row["filename"][:11],
                              np.zeros((len(CATEGORIES), num_segments), np.int64))
        labels = _labels(row["event_labels"])
        if labels:
            onset, offset = int(float(row["onset"])), int(float(row["offset"]))
            grid[labels, onset:min(offset, num_segments)] = 1
    return ann


class LLPDataset:
    def __init__(self, label_csv: str, frame_dir: Optional[str] = None,
                 audio_dir: Optional[str] = None, st_dir: Optional[str] = None,
                 img_size: int = 192, num_frames: int = 10, segment_samples: int = 32000):
        self.samples = parse_label_csv(label_csv)
        self.frame_dir = frame_dir
        self.audio_dir = audio_dir
        self.st_dir = st_dir
        self.img_size = img_size
        self.num_frames = num_frames
        self.segment_samples = segment_samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        vid, target = self.samples[i]
        name = vid[:11]
        out = {"image": load_frames(self.frame_dir, name, self.num_frames, img_size=self.img_size),
               "wave": load_wave(self.audio_dir, name, self.num_frames, self.segment_samples),
               "target": target,
               "video": name}
        if self.st_dir is not None:  # zero-shot LLP runs without r2plus1d features
            st = np.load(os.path.join(self.st_dir, f"{name}.npy")).astype(np.float32)
            if st.shape[0] != self.num_frames:
                st = st[np.linspace(0, st.shape[0] - 1, self.num_frames).astype(int)]
            out["video_st"] = st
        return out


def synthetic_batch(batch_size: int, *, img_size=192, seed=0, num_frames=10, sr=32000):
    """A seeded AVVP batch: waves (B, T, sr), frames in [0, 1), r2plus1d
    features and weak targets with class 0 always on (as JAX's, whose T and
    sr are fixed at 10 and 32000)."""
    rs = np.random.RandomState(seed)
    target = (rs.rand(batch_size, len(CATEGORIES)) > 0.8).astype(np.float32)
    target[:, 0] = 1.0
    return {
        "wave": rs.randn(batch_size, num_frames, sr).astype(np.float32) * 0.1,
        "image": rs.rand(batch_size, num_frames, img_size, img_size, 3).astype(np.float32),
        "video_st": rs.randn(batch_size, num_frames, 512).astype(np.float32),
        "target": target,
    }
