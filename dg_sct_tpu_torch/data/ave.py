"""AVE dataset on disk, the threaded loader and the staging of batches on
the card.

As `dg_sct_tpu/data/ave.py` (after `DG-SCT/AVE/dataloader.py:33-186`): 10
frames a clip sampled with np.linspace over the decoded jpgs, resized to 192
bicubic and ImageNet-normalized; the `.npy` waveform tiled or cropped to
(10, 32000); one-hot labels (T=10, 29) with background class 28, rebuilt
from `Annotations.txt`. Decode runs in worker threads: the native core
releases the interpreter lock. `device_prefetch` stages fixed-shape batches
through a ring of pinned host buffers on a side CUDA stream.
"""
from __future__ import annotations

import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..ops.basic import encode_mulaw_u8
from ..utils.profiling import DEVICE, span

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

NUM_CLASSES = 28  # foreground; background = 28
NUM_SEGMENTS = 10
SAMPLE_RATE = 32000


def load_categories(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def parse_annotations(ann_path: str, categories: Sequence[str]):
    """Annotations.txt rows `Category&VideoID&Quality&Start&End` -> list of
    (video_id, one-hot (10, n_cls + 1)), background in the last column."""
    cat_idx = {c: i for i, c in enumerate(categories)}
    n_cls = len(categories)
    out = []
    with open(ann_path) as f:
        next(f)  # header
        for ln in f:
            parts = ln.strip().split("&")
            if len(parts) < 5:
                continue
            cat, vid, _, start, end = parts[:5]
            onehot = np.zeros((NUM_SEGMENTS, n_cls + 1), np.float32)
            onehot[:, n_cls] = 1.0
            c = cat_idx[cat]
            for t in range(max(int(float(start)), 0), min(int(float(end)), NUM_SEGMENTS)):
                onehot[t, n_cls] = 0.0
                onehot[t, c] = 1.0
            out.append((vid, onehot))
    return out


def load_split_ids(path: str) -> List[str]:
    """trainSet/testSet/valSet.txt rows share the annotation format."""
    ids = []
    with open(path) as f:
        for ln in f:
            parts = ln.strip().split("&")
            if len(parts) >= 2 and parts[1] != "VideoID":
                ids.append(parts[1])
    return ids


def resize_bicubic(img: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC))


def load_frames(frame_dir: str, video_id: str, num_frames=NUM_SEGMENTS, img_size=192,
                raw_u8=False, yuv420=False):
    """`num_frames` jpgs sampled with np.linspace (dataloader.py:162-171).

    Default: (T, H, W, 3) float32, ImageNet-normalized. `raw_u8`: (T, H, W, 3)
    uint8 for the device to normalize. `yuv420`: planes y (T, H, W) and uv
    (T, H/2, W/2, 2) uint8. The native core decodes when it is available
    and every frame is a jpg; otherwise PIL does."""
    vdir = os.path.join(frame_dir, video_id)
    files = sorted(f for f in os.listdir(vdir) if f.endswith((".jpg", ".png")))
    idxs = np.linspace(0, len(files) - 1, num_frames).astype(int)
    paths = [os.path.join(vdir, files[i]) for i in idxs]

    if native.available() and all(p.endswith(".jpg") for p in paths):
        if yuv420:
            return native.load_jpeg_batch_yuv420(paths, img_size)
        if raw_u8:
            return native.load_jpeg_batch_u8(paths, img_size)
        return native.load_jpeg_batch(paths, img_size, IMAGENET_MEAN, IMAGENET_STD)

    from PIL import Image
    if yuv420:
        ys, uvs = [], []
        for p in paths:
            ycc = resize_bicubic(np.asarray(Image.open(p).convert("YCbCr")), img_size)
            ys.append(ycc[..., 0].astype(np.uint8))
            uv = ycc[..., 1:].astype(np.float32)
            uv = uv.reshape(img_size // 2, 2, img_size // 2, 2, 2).mean((1, 3))
            uvs.append(np.round(uv).astype(np.uint8))
        return np.stack(ys), np.stack(uvs)
    frames = []
    for p in paths:
        img = resize_bicubic(np.asarray(Image.open(p).convert("RGB")), img_size)
        if raw_u8:
            frames.append(img.astype(np.uint8))
        else:
            frames.append((img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
    return np.stack(frames)


def load_wave(audio_dir: str, video_id: str, num_segments=NUM_SEGMENTS,
              sr=SAMPLE_RATE) -> np.ndarray:
    """`.npy` waveform tiled or cropped to (T, sr) (dataloader.py:174-179);
    int16 PCM stays int16 for the device to dequantize, other types become
    float32."""
    wave = np.load(os.path.join(audio_dir, f"{video_id}.npy")).reshape(-1)
    need = num_segments * sr
    if len(wave) < need:
        wave = np.tile(wave, need // max(len(wave), 1) + 1)
    wave = wave[:need].reshape(num_segments, sr)
    return wave if wave.dtype == np.int16 else wave.astype(np.float32)


class AVEDataset:
    """Map-style dataset over an AVE split. Items: `wave` (T, L) float32,
    int16 or, with `wave_mulaw`, mu-law uint8; `GT` (T, 29); and `image`
    (float32, or uint8 with `raw_u8`) or, with `yuv420`, `image_y` and
    `image_uv`."""

    def __init__(self, root: str, split: str = "train", img_size: int = 192,
                 frame_dir: Optional[str] = None, audio_dir: Optional[str] = None,
                 num_frames: int = NUM_SEGMENTS, segment_samples: int = SAMPLE_RATE,
                 raw_u8: bool = False, yuv420: bool = False, wave_mulaw: bool = False):
        meta = os.path.join(root, "data", "AVE")
        if not os.path.isdir(meta):
            meta = root
        self.categories = load_categories(os.path.join(meta, "categories.txt"))
        self.labels = dict(parse_annotations(os.path.join(meta, "Annotations.txt"),
                                             self.categories))
        split_file = {"train": "trainSet.txt", "test": "testSet.txt", "val": "valSet.txt"}[split]
        self.ids = [v for v in load_split_ids(os.path.join(meta, split_file))
                    if v in self.labels]
        self.frame_dir = frame_dir
        self.audio_dir = audio_dir
        self.img_size = img_size
        self.num_frames = num_frames
        self.segment_samples = segment_samples
        self.raw_u8 = raw_u8
        self.yuv420 = yuv420
        self.wave_mulaw = wave_mulaw

    def __len__(self):
        return len(self.ids)

    def label(self, i) -> np.ndarray:
        """Clip i's one-hot labels (num_frames, 29), without decoding it."""
        gt = self.labels[self.ids[i]]
        if gt.shape[0] != self.num_frames:
            gt = gt[np.linspace(0, gt.shape[0] - 1, self.num_frames).astype(int)]
        return gt

    def __getitem__(self, i):
        vid = self.ids[i]
        wave = load_wave(self.audio_dir, vid, self.num_frames, self.segment_samples)
        if self.wave_mulaw:
            wave = encode_mulaw_u8(wave)
        out = {"wave": wave, "GT": self.label(i)}
        if self.yuv420:
            out["image_y"], out["image_uv"] = load_frames(
                self.frame_dir, vid, self.num_frames, img_size=self.img_size, yuv420=True)
        else:
            out["image"] = load_frames(self.frame_dir, vid, self.num_frames,
                                       img_size=self.img_size, raw_u8=self.raw_u8)
        return out


def synthetic_batch(batch_size: int, *, img_size=192, num_segments=NUM_SEGMENTS,
                    sr=SAMPLE_RATE, seed=0):
    """Deterministic synthetic AVE batch (smoke runs and tests)."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((batch_size, num_segments, NUM_CLASSES + 1), np.float32)
    cls = rs.randint(0, NUM_CLASSES, size=batch_size)
    for b in range(batch_size):
        gt[b, :, cls[b]] = 1.0
    return {
        "wave": rs.randn(batch_size, num_segments, sr).astype(np.float32) * 0.1,
        "image": rs.rand(batch_size, num_segments, img_size, img_size, 3).astype(np.float32),
        "gt": gt,
    }


def default_collate(samples: Sequence[dict]) -> dict:
    """Stack numeric values into batch arrays and keep the others (strings)
    as lists; `GT` becomes `gt`."""
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out_key = "gt" if key == "GT" else key
        if isinstance(vals[0], (np.ndarray, np.number, int, float)):
            batch[out_key] = np.stack([np.asarray(v) for v in vals])
        else:
            batch[out_key] = list(vals)
    return batch


def _put(q, item, stop) -> bool:
    """Put unless the consumer has gone; True if the item was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue_mod.Full:
            continue
    return False


def _drain(q, producer, stop):
    """Generator over `q` fed by the thread `producer`: None ends it, an
    exception from the producer is raised here. Closing the generator stops
    the producer."""
    producer.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        producer.join(timeout=10)


def batched_iterator(dataset, batch_size: int, *, shuffle=True, seed=0, drop_last=True,
                     num_workers=4, prefetch=2, collate=default_collate,
                     shard=None) -> Iterator[dict]:
    """Threaded prefetching loader: a pool of `num_workers` threads decodes
    a batch's samples, the collator stacks them, and up to `prefetch` ready
    batches wait ahead of the consumer. Batches come in order; an error in a
    worker is raised to the consumer. `shard` = (rank, world): data
    parallelism, every rank orders the same global batches and loads only
    its contiguous share of each one's rows (uneven shares of a last,
    smaller batch; a rank's empty share is skipped): every sample is loaded
    by exactly one rank, none twice."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    batches = [order[i:i + batch_size] for i in range(0, len(order), batch_size)]
    if drop_last:
        batches = [b for b in batches if len(b) == batch_size]
    if shard is not None:
        rank, world = shard
        batches = [b[rank * len(b) // world:(rank + 1) * len(b) // world] for b in batches]
        batches = [b for b in batches if len(b)]
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()

    def produce():
        try:
            with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as ex:
                for idxs in batches:
                    samples = list(ex.map(lambda i: dataset[int(i)], idxs))
                    if not _put(q, collate(samples), stop):
                        return
        except Exception as e:  # raised again in the consumer
            _put(q, e, stop)
            return
        _put(q, None, stop)

    yield from _drain(q, threading.Thread(target=produce, daemon=True), stop)


class _PinnedRing:
    """`slots` sets of pinned host buffers, one per key, for fixed-shape
    batches. A slot is refilled only after the event of its last host-to-
    device copy has completed."""

    def __init__(self, slots: int):
        self.bufs = [None] * slots
        self.events = [None] * slots
        self.n = 0

    def stage(self, arrays: dict, device, stream) -> tuple:
        """Copy `arrays` into the next slot, then to `device` on `stream` ->
        (device tensors, the event recorded after their copies)."""
        i = self.n % len(self.bufs)
        self.n += 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        src = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()}
        bufs = self.bufs[i]
        if bufs is None or bufs.keys() != src.keys() or any(
                bufs[k].shape != t.shape or bufs[k].dtype != t.dtype for k, t in src.items()):
            bufs = self.bufs[i] = {k: torch.empty_like(t, pin_memory=True)
                                   for k, t in src.items()}
        for k, t in src.items():
            bufs[k].copy_(t)
        with torch.cuda.stream(stream):
            staged = {k: b.to(device, non_blocking=True) for k, b in bufs.items()}
            self.events[i] = torch.cuda.Event()
            self.events[i].record(stream)
        return staged, self.events[i]


def device_prefetch(it, *, device, size: int = 2,
                    keys=("wave", "image", "image_y", "image_uv")) -> Iterator[dict]:
    """Stage the numpy arrays under `keys` of each batch of `it` on `device`
    ahead of the consumer; other entries pass through on the host.

    On a CUDA device a thread copies each batch into a ring of pinned host
    buffers and issues its host-to-device copies on a side stream, up to
    `size` batches ahead. The consumer's current stream waits for a batch's
    copy event before the batch is yielded, and the staged tensors are
    recorded on that stream, so the allocator does not hand their memory
    back to the side stream while the consumer's kernels may still read
    it. On a CPU device the batches pass through unchanged."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from it
        return
    side = torch.cuda.Stream(device)
    ring = _PinnedRing(size + 2)  # `size` queued, one being consumed, one being filled
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(size, 1))
    stop = threading.Event()

    def produce():
        try:
            for batch in it:
                with span("dgsct.serve.stage", DEVICE, stream=side):
                    staged, ev = ring.stage({k: v for k, v in batch.items() if k in keys},
                                            device, side)
                if not _put(q, ({**batch, **staged}, ev), stop):
                    return
        except Exception as e:  # raised again in the consumer
            _put(q, e, stop)
            return
        _put(q, None, stop)

    consumer = torch.cuda.current_stream(device)
    for batch, ev in _drain(q, threading.Thread(target=produce, daemon=True), stop):
        consumer.wait_event(ev)
        for k in keys:
            if k in batch:
                batch[k].record_stream(consumer)
        yield batch
