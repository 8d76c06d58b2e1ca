"""Device selection shared by the entry points, and the model's constant
tables on the device."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Without one, raise instead of running on the
    CPU: the CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
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
