"""Builds the CUDA sources under `dg_sct_tpu_torch/csrc/` at first use and
binds their C entry points with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc -gencode arch=compute_90a,code=sm_90a
-shared` into its own library under `dg_sct_tpu_torch/_build/<hash>/`, where
the hash covers every source and the flags; all `nvcc` processes start
together. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"
SOURCES = ("window_attention", "block_attention", "adapter_bottleneck", "int8_linear")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source that is not built yet, all at once; returns
    {name: library path}. Raises with the compiler's output on failure.
    `<name>.log` beside each library keeps the ptxas report."""
    with _lock:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        libs = {name: out / f"lib{name}.so" for name in SOURCES}
        procs = {}
        for name, lib in libs.items():
            if lib.exists():
                continue
            tmp = out / f"lib{name}.so.tmp{os.getpid()}"
            log = open(out / f"{name}.log", "w")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
        failed = []
        for name, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, libs[name])
            else:
                failed.append(f"{name} (rc {rc}):\n{(out / f'{name}.log').read_text()[-4000:]}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return libs


class CudaKernel:
    """One C entry point of a csrc/ library, and the number of its launches.

    `launch(*args)` calls the entry point, which returns `cudaGetLastError()`
    after its launches; a non-zero code raises, and only a launch that
    returned 0 counts."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build_all()[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._err = lib.dgsct_error_string
            self._err.argtypes = [ctypes.c_int]
            self._err.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def launch(self, *args):
        rc = self.load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}: "
                               f"{self._err(rc).decode(errors='replace')}")
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent operand)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    """The current stream of t's card as a raw handle. The wrappers run this on
    every call, so it skips building a `torch.cuda.Stream` object (the raw
    query is the one torch's own generated kernel launchers use)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"kernels take float32 or bfloat16, not {t.dtype}")
    return code


def refuse_grad(name: str, *operands):
    """Raise where autograd would need a gradient through a kernel: grad mode
    on and an operand (None: absent) that requires grad. No kernel has a
    backward, and a kernel's output would carry no `grad_fn`, so everything
    upstream would silently get no gradient; `jax.grad` through the Pallas
    kernels raises as well. Runs on every device, the CPU route included, so
    both routes refuse alike; a caller that needs a gradient takes the plain
    version (`kernels=False`)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        raise RuntimeError(f"{name}: the kernel has no backward, and an operand requires grad; "
                           f"run under torch.no_grad() / inference_mode(), or take the plain "
                           f"path (kernels=False) to differentiate")


def check_cuda(name: str, ref, **tensors):
    """Every operand lies on ref's card, has ref's dtype and is contiguous.
    One cheap test per operand first: the wrappers run it on every call."""
    dev, dt = ref.get_device(), ref.dtype
    for key, t in tensors.items():
        if t is None or (t.is_cuda and t.get_device() == dev and t.dtype == dt
                         and t.is_contiguous()):
            continue
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {ref.device}")
        if t.dtype != ref.dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, not {ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def check_aligned(name: str, **tensors):
    """Each operand (None: absent) starts on a 16-byte boundary, as cp.async
    copies and paired loads need."""
    for key, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")


def check_shape(name: str, key: str, t, shape):
    if t is not None and t.shape != shape:
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
