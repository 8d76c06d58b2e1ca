"""AVS (S4 / MS3) dataset in numpy, the port's copy of `dg_sct_tpu/data/avs.py`
(AVSBench's `avs_s4/dataloader.py`): 5 PNG frames a video at 224x224,
ImageNet-normalized float32; binary masks (S4 train: the first frame only;
test and MS3: all 5); the wave as (5, segment_samples) from a per-video
`.npy` (an array, or a dict keyed by the video), tiled when short.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from .ave import IMAGENET_MEAN, IMAGENET_STD, resize_bicubic

NUM_FRAMES = 5
SR = 32000


def load_image(path: str, size: int = 224, normalize: bool = True) -> np.ndarray:
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"))
    img = resize_bicubic(img, size).astype(np.float32) / 255.0
    if normalize:
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
    return img


def load_mask(path: str, size: int = 224) -> np.ndarray:
    from PIL import Image
    m = Image.open(path).convert("1").resize((size, size))
    return (np.asarray(m) > 0).astype(np.float32)[..., None]


def load_audio_log_mel(path: str) -> np.ndarray:
    """The reference loaders' precomputed VGGish log-mel field: a pickled
    tensor (5, 1, 96, 64) -> float32 numpy. The model does not read it."""
    with open(path, "rb") as f:
        t = pickle.load(f)
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


class S4Dataset:
    """An AVSBench tree: `<root>/visual_frames/<split>/<category>/<video>/*.png`
    (or .jpg), `<root>/gt_masks/<split>/<category>/<video>/*.png` and
    `<root>/audio_wav/<video>.npy`. Items: {"image" (T, S, S, 3), "mask"
    (mask_num, S, S, 1), "wave" (T, segment_samples), "category", "video"}.

    `with_log_mel=True` adds the reference's
    `<root>/audio_log_mel/<split>/<category>/<video>.pkl` field where it
    exists and the Kaldi-fbank stack `total_audio` (`data.fbank.wav2fbank`)."""

    def __init__(self, root: str, split: str = "train", mask_num: int = 1,
                 img_size: int = 224, num_frames: int = NUM_FRAMES,
                 segment_samples: int = SR, with_log_mel: bool = False):
        self.root = root
        self.split = split
        self.mask_num = mask_num
        self.img_size = img_size
        self.num_frames = num_frames
        self.segment_samples = segment_samples
        self.with_log_mel = with_log_mel
        self.videos = []
        vdir = os.path.join(root, "visual_frames", split)
        if os.path.isdir(vdir):
            for cat in sorted(os.listdir(vdir)):
                for vid in sorted(os.listdir(os.path.join(vdir, cat))):
                    self.videos.append((cat, vid))

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, i):
        cat, vid = self.videos[i]
        fdir = os.path.join(self.root, "visual_frames", self.split, cat, vid)
        mdir = os.path.join(self.root, "gt_masks", self.split, cat, vid)
        frames = sorted(f for f in os.listdir(fdir)
                        if f.endswith((".png", ".jpg")))[:self.num_frames]
        imgs = np.stack([load_image(os.path.join(fdir, f), self.img_size) for f in frames])
        mfiles = sorted(f for f in os.listdir(mdir) if f.endswith(".png"))[:self.mask_num]
        masks = np.stack([load_mask(os.path.join(mdir, f), self.img_size) for f in mfiles])
        wave = np.load(os.path.join(self.root, "audio_wav", f"{vid}.npy"), allow_pickle=True)
        if isinstance(wave, np.ndarray) and wave.dtype == object:
            wave = wave.item()[vid]
        wave = np.asarray(wave, np.float32).reshape(-1)
        need = self.num_frames * self.segment_samples
        if len(wave) < need:
            wave = np.tile(wave, need // max(len(wave), 1) + 1)
        wave = wave[:need].reshape(self.num_frames, self.segment_samples)
        out = {"image": imgs, "mask": masks, "wave": wave, "category": cat, "video": vid}
        if self.with_log_mel:
            from .fbank import wav2fbank
            lm_path = os.path.join(self.root, "audio_log_mel", self.split, cat, f"{vid}.pkl")
            if os.path.exists(lm_path):
                out["audio_log_mel"] = load_audio_log_mel(lm_path)
            flat = wave.reshape(-1)
            out["total_audio"] = np.stack([wav2fbank(flat, idx=s, sample_rate=self.segment_samples)
                                           for s in range(self.num_frames)])
        return out


def synthetic_batch(batch_size: int, *, img_size=224, seed=0, mask_frames=1,
                    num_frames=NUM_FRAMES, sr=SR):
    """A seeded AVS batch: images in [0, 1), waves of `sr` samples a frame,
    binary masks ((B, S, S, 1) for one mask frame, else (B * mask_frames, S,
    S, 1))."""
    rs = np.random.RandomState(seed)
    return {
        "image": rs.rand(batch_size, num_frames, img_size, img_size, 3).astype(np.float32),
        "wave": rs.randn(batch_size, num_frames, sr).astype(np.float32) * 0.1,
        "mask": (rs.rand(batch_size * mask_frames if mask_frames > 1 else batch_size,
                         img_size, img_size, 1) > 0.5).astype(np.float32),
    }
