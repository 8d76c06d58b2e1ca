"""ctypes bindings of the port's native JPEG core (`io_core.cpp`).

The core is built with g++ at first use into
`dg_sct_tpu_torch/_build/native-<hash of source and flags>/libdgsct_io.so`,
never beside its source, with the JAX package's flags (AVX2 and FMA first,
then baseline code), so that its float path gives the same bits as
`dg_sct_tpu/native`. Callers test `available()` and take the PIL path
otherwise; `build_error()` says why the core is missing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().with_name("io_core.cpp")
BUILD_ROOT = SRC.parents[1] / "_build"
FLAGS = ("-O3", "-fno-math-errno", "-shared", "-fPIC", "-fopenmp")
ARCH_FLAGS = (("-march=x86-64-v3",), ())  # the resize loops are written to vectorize

_lock = threading.Lock()
_loaded: dict = {}  # build directory -> (library or None, error text)

U8P = ctypes.POINTER(ctypes.c_uint8)
F32P = ctypes.POINTER(ctypes.c_float)
PATHS = ctypes.POINTER(ctypes.c_char_p)
ARGTYPES = {
    "dgsct_resize_normalize": [U8P, ctypes.c_int, ctypes.c_int, F32P, ctypes.c_int, F32P, F32P],
    "dgsct_load_jpeg_batch": [PATHS, ctypes.c_int, F32P, ctypes.c_int, F32P, F32P],
    "dgsct_load_jpeg_batch_u8": [PATHS, ctypes.c_int, U8P, ctypes.c_int],
    "dgsct_load_jpeg_batch_yuv420": [PATHS, ctypes.c_int, U8P, U8P, ctypes.c_int],
}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + sum(ARCH_FLAGS, ())).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}"


def _build(lib: Path) -> Optional[str]:
    """Compile into `lib`; None on success, else the compiler's output."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    err = ""
    for arch in ARCH_FLAGS:
        cmd = ["g++", FLAGS[0], *arch, *FLAGS[1:], str(SRC), "-ljpeg", "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            return "g++ not found"
        if proc.returncode == 0:
            os.replace(tmp, lib)
            return None
        err = proc.stderr[-2000:]
    return err


def _open(path: Path):
    """-> (library with its argtypes bound, None) or (None, the loader's error)."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        return None, str(e)
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, None


def _load():
    out = build_dir()
    with _lock:
        if out not in _loaded:
            path = out / "libdgsct_io.so"
            lib = None
            if path.exists():  # a library built on another machine may not load here
                lib, _ = _open(path)
            if lib is None:
                err = _build(path)
                _loaded[out] = (None, err) if err else _open(path)
            else:
                _loaded[out] = (lib, None)
        return _loaded[out]


def available() -> bool:
    return _load()[0] is not None


def build_error() -> Optional[str]:
    """Why the core is not available (the compiler's or the loader's message),
    else None."""
    return _load()[1]


def _lib():
    lib, err = _load()
    if lib is None:
        raise RuntimeError(f"native io core unavailable: {err}")
    return lib


def _paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def _u8(a: np.ndarray):
    return a.ctypes.data_as(U8P)


def _f32(a: np.ndarray):
    return a.ctypes.data_as(F32P)


def resize_normalize(img: np.ndarray, out_size: int, mean, std) -> np.ndarray:
    """One decoded image (H, W, 3) uint8 -> (out, out, 3) float32: antialiased
    bicubic resize (PIL-compatible) and normalize by `mean` and `std`."""
    lib = _lib()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize_normalize takes (H, W, 3) uint8, not {img.shape}")
    dst = np.empty((out_size, out_size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if lib.dgsct_resize_normalize(_u8(img), img.shape[0], img.shape[1], _f32(dst), out_size,
                                  _f32(mean), _f32(std)) != 0:
        raise RuntimeError("native resize failed")
    return dst


def load_jpeg_batch(paths: Sequence[str], out_size: int, mean, std) -> np.ndarray:
    """Parallel decode, resize and normalize -> (n, out, out, 3) float32."""
    lib = _lib()
    dst = np.empty((len(paths), out_size, out_size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if lib.dgsct_load_jpeg_batch(_paths(paths), len(paths), _f32(dst), out_size,
                                 _f32(mean), _f32(std)) != 0:
        raise RuntimeError("native jpeg batch load failed")
    return dst


def load_jpeg_batch_u8(paths: Sequence[str], out_size: int) -> np.ndarray:
    """Serving ingest: parallel decode at the smallest DCT scale that covers
    `out_size`, antialiased resize -> (n, out, out, 3) uint8; the device
    normalizes (`ops.basic.normalize_frames_u8`)."""
    lib = _lib()
    dst = np.empty((len(paths), out_size, out_size, 3), np.uint8)
    if lib.dgsct_load_jpeg_batch_u8(_paths(paths), len(paths), _u8(dst), out_size) != 0:
        raise RuntimeError("native jpeg u8 batch load failed")
    return dst


def load_jpeg_batch_yuv420(paths: Sequence[str], out_size: int):
    """Half-payload serving ingest: parallel DCT-scaled decode to YCbCr,
    antialiased resize, plane split -> y (n, out, out) and uv
    (n, out/2, out/2, 2) uint8, 1.5 bytes a pixel; the device upsamples the
    chroma and converts (`ops.basic.normalize_frames_yuv420`)."""
    if out_size % 2:
        raise ValueError(f"yuv420 needs an even size, got {out_size}")
    lib = _lib()
    n = len(paths)
    y = np.empty((n, out_size, out_size), np.uint8)
    uv = np.empty((n, out_size // 2, out_size // 2, 2), np.uint8)
    if lib.dgsct_load_jpeg_batch_yuv420(_paths(paths), n, _u8(y), _u8(uv), out_size) != 0:
        raise RuntimeError("native jpeg yuv420 batch load failed")
    return y, uv
