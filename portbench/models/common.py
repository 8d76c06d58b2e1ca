"""What the model kinds share."""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dataclass_from(cls, d: dict):
    """`cls` (a frozen dataclass of the port's configs) from a JSON object:
    nested dataclasses from nested objects, lists as tuples. A key the
    dataclass lacks is an error."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field {sorted(unknown)}")
    kw = {}
    for name, v in d.items():
        f = fields[name]
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        if isinstance(v, dict) and dataclasses.is_dataclass(default):
            v = dataclass_from(type(default), v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[name] = v
    return cls(**kw)


def stream_knobs(mix, serve, device):
    """The engine options every kind takes from the mix and the serving
    section of the configuration."""
    return dict(batch_size=mix["batch"], chunk=mix.get("chunk", 1),
                prefetch=mix.get("prefetch", 2), num_workers=mix.get("workers", 4),
                device=device, compute_dtype=DTYPES[serve["dtype"]], gelu=serve["gelu"],
                kernels=serve["kernels"] and torch.device(device).type == "cuda")
