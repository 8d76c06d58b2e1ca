"""Device selection shared by the entry points, and the model's constant
tables on the device."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None, index: int | None = None) -> torch.device:
    """`None` means the card: card `index` (a data-parallel rank's, e.g.
    torchrun's LOCAL_RANK), or the current one. Without it, raise instead of
    running on the CPU: the CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        if index is None:
            return torch.device("cuda")
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {index}: {torch.cuda.device_count()} visible")
        return torch.device("cuda", index)
    return torch.device(device)


def constant(make, *args, device, dtype=None):
    """`make(*args)`, a numpy table (DFT basis, mel bank, window masks and
    indices), as a tensor on `device`. Each table is copied to each device
    once per process: a copy from pageable host memory per forward would
    stall the host until the card drained its queue. Callers must not
    write to the result."""
    return _constant(make, args, torch.device(device), dtype)


@functools.lru_cache(maxsize=None)
def _constant(make, args, device, dtype):
    with torch.inference_mode(False):
        return torch.as_tensor(make(*args), device=device, dtype=dtype)
