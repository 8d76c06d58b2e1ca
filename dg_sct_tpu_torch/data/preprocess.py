"""Raw media into the trees the datasets read: `frames/<vid>/%08d.jpg` and
`audio/<vid>.npy` waves at 32 kHz, as the reference's
`extract_{frames,audio}.py` and AVS preprocess scripts make them.

Frames and the audio track are taken out of a video by `ffmpeg` (the
reference's tool), and those steps need it on the path; a wav file becomes
its `.npy` wave with numpy and scipy alone.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np

TARGET_SR = 32000


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def extract_frames(video_path: str, out_dir: str, fps: int = 8, quality: int = 2) -> int:
    """A video's frames at `fps` as `<out_dir>/%08d.jpg`, numbered from 1
    (the loaders sample them by linspace). Returns the frame count."""
    if not have_ffmpeg():
        raise RuntimeError("extract_frames requires ffmpeg on PATH")
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-i", video_path,
                    "-vf", f"fps={fps}", "-q:v", str(quality),
                    os.path.join(out_dir, "%08d.jpg")], check=True)
    return len([f for f in os.listdir(out_dir) if f.endswith(".jpg")])


def extract_audio_wav(video_path: str, wav_path: str, sr: int = TARGET_SR) -> None:
    """A video's audio track as a mono `sr` wav file, through ffmpeg."""
    if not have_ffmpeg():
        raise RuntimeError("extract_audio_wav requires ffmpeg on PATH")
    os.makedirs(os.path.dirname(os.path.abspath(wav_path)), exist_ok=True)
    subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-i", video_path,
                    "-ac", "1", "-ar", str(sr), "-vn", wav_path], check=True)


def wav_to_wave_npy(wav_path: str, npy_path: Optional[str] = None, sr: int = TARGET_SR,
                    clip_seconds: int = 10) -> np.ndarray:
    """A wav file -> the float32 wave in [-1, 1] the loaders read: integer
    samples scaled by their type's maximum before any float promotion,
    channels averaged, resampled to `sr` by `resample_poly`, then tiled or
    cropped to `clip_seconds * sr` samples; saved to `npy_path` if given."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    in_sr, data = wavfile.read(wav_path)
    data = np.asarray(data)
    if np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / float(np.iinfo(data.dtype).max)
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1).astype(np.float32)
    if in_sr != sr:
        g = np.gcd(int(in_sr), int(sr))
        data = resample_poly(data, sr // g, in_sr // g).astype(np.float32)
    need = clip_seconds * sr
    if len(data) == 0:
        data = np.zeros(need, np.float32)
    if len(data) < need:
        data = np.tile(data, need // len(data) + 1)
    data = data[:need]
    if npy_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(npy_path)), exist_ok=True)
        np.save(npy_path, data)
    return data


def preprocess_video_tree(video_dir: str, out_root: str, *, fps: int = 8, clip_seconds: int = 10,
                          extensions=(".mp4", ".mkv", ".webm", ".avi")) -> int:
    """The videos of `video_dir` -> `<out_root>/frames/<vid>/%08d.jpg` and
    `<out_root>/audio/<vid>.npy`, the layout every dataset reads. Returns
    the number of videos. Needs ffmpeg."""
    n = 0
    for name in sorted(os.listdir(video_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in extensions:
            continue
        src = os.path.join(video_dir, name)
        extract_frames(src, os.path.join(out_root, "frames", stem), fps=fps)
        wav_tmp = os.path.join(out_root, "audio", stem + ".wav")
        extract_audio_wav(src, wav_tmp)
        wav_to_wave_npy(wav_tmp, os.path.join(out_root, "audio", stem + ".npy"),
                        clip_seconds=clip_seconds)
        os.remove(wav_tmp)
        n += 1
    return n
