"""Carries the JAX package's AVE or AVS (params, state) across to the port.

The port keeps the JAX tree: the same nested dict keys and list lengths, and
the same leaf shapes (linear kernels (in, out), grouped kernels
(g, in/g, out/g), patch embed (P, P, C, E)). `from_jax` walks the port's own
tree of shapes (built on the "meta" device) beside the given one, so a
missing, extra or misshapen leaf raises instead of loading silently.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs import AVEModelConfig, AVSModelConfig
from .device import resolve_device
from .models.ave import init_ave_model
from .models.avs import init_avs_model


def _convert(ref, src, path, device):
    if isinstance(ref, dict):
        if not isinstance(src, dict):
            raise ValueError(f"{path}: expected a dict, got {type(src).__name__}")
        missing, extra = sorted(set(ref) - set(src)), sorted(set(src) - set(ref))
        if missing or extra:
            raise ValueError(f"{path}: missing keys {missing}, unconsumed keys {extra}")
        return {k: _convert(ref[k], src[k], f"{path}/{k}", device) for k in ref}
    if isinstance(ref, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(ref):
            raise ValueError(f"{path}: expected a list of {len(ref)}")
        return [_convert(r, s, f"{path}[{i}]", device)
                for i, (r, s) in enumerate(zip(ref, src))]
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"{path}: shape {tuple(arr.shape)}, the port expects {tuple(ref.shape)}")
    return torch.as_tensor(np.array(arr), device=device).to(ref.dtype)


def from_jax(params_np, state_np, cfg: AVEModelConfig | AVSModelConfig, *, device=None):
    """(params, state) of `dg_sct_tpu.models.ave.init_ave_model` (or, for an
    AVSModelConfig, `models.avs.init_avs_model`), as nested dicts and lists
    of numpy arrays -> the port's float32 (params, state) on `device` (None:
    the card). Every leaf must be consumed and every shape must match."""
    device = resolve_device(device)
    init = init_avs_model if isinstance(cfg, AVSModelConfig) else init_ave_model
    ref_p, ref_s = init(cfg, device="meta")
    return (_convert(ref_p, params_np, "params", device),
            _convert(ref_s, state_np, "state", device))
