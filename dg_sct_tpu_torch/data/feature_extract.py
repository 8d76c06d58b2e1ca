"""Precomputed video features, as the reference's `extract_rgb_feat.py` and
`extract_3D_feat.py` write them: per video, ResNet-152 features (n, 2048)
of n frames at 224, or R(2+1)D-18 features (n // 8, 512) of 8-frame clips
at 112, saved as `<output-dir>/<video>.npy`. The clip features are what
`data.avvp.LLPDataset(st_dir=...)` reads as `video_st`.

Frames are read with PIL on the host; the backbones (`models/video_feats.py`)
run on the card in float32 with TF32 off. Without a torchvision state dict
the weights are random from seed 0.

    python -m dg_sct_tpu_torch.data.feature_extract rgb  --video-path F --output-dir O
    python -m dg_sct_tpu_torch.data.feature_extract clip --video-path F --output-dir O \\
        [--torch-ckpt r2plus1d_18.pth] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models import video_feats as VF
from ..ops.basic import seeded_init
from ..utils.tree import tree_map
from .ave import IMAGENET_MEAN, IMAGENET_STD, resize_bicubic

RGB_BATCH = 16
CLIP_FRAMES = 8


def _load_frame(path, size):
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"))
    img = resize_bicubic(img, size).astype(np.float32) / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def _sample_frames(video_dir, n):
    files = sorted(f for f in os.listdir(video_dir) if f.endswith((".jpg", ".png")))
    idx = np.round(np.linspace(0, len(files) - 1, n)).astype(int)
    return [os.path.join(video_dir, files[i]) for i in idx]


def _videos(video_path):
    return [v for v in sorted(os.listdir(video_path))
            if os.path.isdir(os.path.join(video_path, v))]


def _params(params, init_fn, device):
    if params is None:
        return init_fn(seeded_init(0, device))
    return tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32, device=device), params)


def _frames(video_path, video, n, size):
    paths = _sample_frames(os.path.join(video_path, video), n)
    return np.stack([_load_frame(p, size) for p in paths]).astype(np.float32)


def extract_rgb_feats(video_path, output_dir, *, n_frame_steps=80, img_size=224, params=None,
                      batch=RGB_BATCH, device=None):
    """Each video directory of `video_path` -> `<output_dir>/<video>.npy`,
    (n_frame_steps, 2048) ResNet-152 features of frames sampled by linspace,
    `batch` frames a call. `params`: a numpy or tensor tree
    (`resnet152_from_torch`); None draws one from seed 0. Returns the
    videos written, in order."""
    device = resolve_device(device)
    params = _params(params, VF.init_resnet152, device)
    os.makedirs(output_dir, exist_ok=True)
    videos = _videos(video_path)
    with torch.inference_mode(), VF.no_tf32():
        for video in videos:
            frames = _frames(video_path, video, n_frame_steps, img_size)
            feats = [VF.resnet152_features(params, torch.from_numpy(frames[i:i + batch])
                                           .to(device)).cpu().numpy()
                     for i in range(0, len(frames), batch)]
            np.save(os.path.join(output_dir, f"{video}.npy"),
                    np.concatenate(feats).astype(np.float32))
    return videos


def extract_3d_feats(video_path, output_dir, *, n_frame_steps=80, img_size=112, params=None,
                     device=None):
    """Each video directory of `video_path` -> `<output_dir>/<video>.npy`,
    (n_frame_steps // 8, 512) R(2+1)D-18 features of the sampled frames
    grouped 8 a clip, one call a video. `params`: a numpy or tensor tree
    (`r2plus1d_18_from_torch`); None draws one from seed 0. Returns the
    videos written, in order."""
    device = resolve_device(device)
    params = _params(params, VF.init_r2plus1d_18, device)
    os.makedirs(output_dir, exist_ok=True)
    videos = _videos(video_path)
    with torch.inference_mode(), VF.no_tf32():
        for video in videos:
            frames = _frames(video_path, video, n_frame_steps, img_size)
            n = (len(frames) // CLIP_FRAMES) * CLIP_FRAMES
            clips = frames[:n].reshape(-1, CLIP_FRAMES, img_size, img_size, 3)
            feats = VF.r2plus1d_18_features(params, torch.from_numpy(clips).to(device))
            np.save(os.path.join(output_dir, f"{video}.npy"),
                    feats.cpu().numpy().astype(np.float32))
    return videos


def main(argv=None):
    p = argparse.ArgumentParser(description="ResNet-152 frame or R(2+1)D-18 clip features")
    p.add_argument("mode", choices=["rgb", "clip"])
    p.add_argument("--video-path", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--n-frame-steps", type=int, default=80)
    p.add_argument("--torch-ckpt", default=None,
                   help="a torchvision state dict (.pt/.pth) to load; default random weights")
    p.add_argument("--device", default=None, help="e.g. cpu; default: the card")
    args = p.parse_args(argv)
    params = None
    if args.torch_ckpt:
        from ..utils.torch_convert import load_torch_file
        sd = load_torch_file(args.torch_ckpt)
        params = (VF.resnet152_from_torch(sd) if args.mode == "rgb"
                  else VF.r2plus1d_18_from_torch(sd))
    extract = extract_rgb_feats if args.mode == "rgb" else extract_3d_feats
    videos = extract(args.video_path, args.output_dir, n_frame_steps=args.n_frame_steps,
                     params=params, device=args.device)
    print(f"{args.mode}: {len(videos)} videos -> {args.output_dir}")


if __name__ == "__main__":
    main()
