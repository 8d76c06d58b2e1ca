"""Carries the JAX package's AVE, AVS, AVVP, AVQA or pretrain (params, state)
across to the port (`from_jax`), or any other of its trees beside the port's
own (`from_jax_tree`).

The port keeps the JAX tree: the same nested dict keys and list lengths, and
the same leaf shapes (linear kernels (in, out), grouped kernels
(g, in/g, out/g), patch embed (P, P, C, E)). `from_jax` walks the port's own
tree of shapes (built on the "meta" device) beside the given one, so a
missing, extra or misshapen leaf raises instead of loading silently. A
subtree without leaves (the AVS adapters' states: no BN) may be absent, as
a checkpoint bundle of either package leaves it.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs import (AVEModelConfig, AVQAModelConfig, AVSModelConfig, AVVPModelConfig,
                      PretrainModelConfig)
from .device import resolve_device
from .models.avqa import init_avqa_model
from .models.avqa_grounding import init_grounding_model
from .models.ave import init_ave_model
from .models.avs import init_avs_model
from .models.avvp import init_avvp_model
from .models.pretrain import init_pretrain_model, prompt_buffers
from .utils.tree import tree_leaves, tree_map


def _convert(ref, src, path, device):
    if isinstance(ref, dict):
        if not isinstance(src, dict):
            raise ValueError(f"{path}: expected a dict, got {type(src).__name__}")
        missing = sorted(k for k in set(ref) - set(src) if tree_leaves(ref[k]))
        extra = sorted(set(src) - set(ref))
        if missing or extra:
            raise ValueError(f"{path}: missing keys {missing}, unconsumed keys {extra}")
        return {k: _convert(ref[k], src[k], f"{path}/{k}", device) if k in src
                else tree_map(lambda t: t, ref[k]) for k in ref}
    if isinstance(ref, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(ref):
            raise ValueError(f"{path}: expected a list of {len(ref)}")
        return [_convert(r, s, f"{path}[{i}]", device)
                for i, (r, s) in enumerate(zip(ref, src))]
    if not torch.is_tensor(ref):  # a non-array leaf (a head count, a stride, a flag)
        if np.ndim(src) != 0 or np.asarray(src).item() != ref:
            raise ValueError(f"{path}: {src!r}, the port expects {ref!r}")
        return ref
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"{path}: shape {tuple(arr.shape)}, the port expects {tuple(ref.shape)}")
    return torch.as_tensor(np.array(arr), device=device).to(ref.dtype)


def from_jax_tree(tree_np, ref, *, device=None):
    """Any JAX tree (nested dicts and lists of numpy arrays: PVT, VGGish and
    its PCA, the video backbones, the AST, ModifiedResNet, AVENet, the
    legacy modules, PHM, the attention variants) -> the port's float32 tree
    on `device` (None: the card), walked beside `ref`, the port's own tree
    of the same module (its initialiser on the "meta" device). Every leaf
    must be consumed and every shape match; a non-array leaf (a head count,
    a stride, a flag) must equal the port's."""
    return _convert(ref, tree_np, "tree", resolve_device(device))


_INITS = ((AVSModelConfig, init_avs_model), (AVVPModelConfig, init_avvp_model),
          (AVQAModelConfig, init_avqa_model), (AVEModelConfig, init_ave_model))


def from_jax(params_np, state_np,
             cfg: AVEModelConfig | AVSModelConfig | AVVPModelConfig | AVQAModelConfig
             | PretrainModelConfig, *, device=None, grounding=False, classnames=None):
    """(params, state) of `dg_sct_tpu.models.ave.init_ave_model` (or, for an
    AVSModelConfig, `models.avs.init_avs_model`, for an AVVPModelConfig
    `models.avvp.init_avvp_model`, for an AVQAModelConfig
    `models.avqa.init_avqa_model`, and with `grounding=True` AVQA's stage-1
    `models.avqa_grounding.init_grounding_model`, which shares the AVQA
    configuration), as nested dicts and lists of numpy arrays -> the port's
    float32 (params, state) on `device` (None: the card). Every leaf must be
    consumed and every shape must match.

    A PretrainModelConfig (`models.pretrain.init_pretrain_model`) needs the
    model's `classnames` and returns (params, state, prompt buffers): the
    buffers are no leaves (numpy in the JAX package), so they are rebuilt
    from the carried `text.token_embedding`."""
    device = resolve_device(device)
    if isinstance(cfg, PretrainModelConfig):
        if classnames is None:
            raise ValueError("a PretrainModelConfig takes the model's classnames")
        ref_p, ref_s, _ = init_pretrain_model(cfg, classnames, device="meta")
        params = _convert(ref_p, params_np, "params", device)
        return (params, _convert(ref_s, state_np, "state", device),
                prompt_buffers(params, classnames, cfg))
    if grounding and not isinstance(cfg, AVQAModelConfig):
        raise ValueError("grounding=True takes an AVQAModelConfig")
    init = init_grounding_model if grounding else next(
        fn for kind, fn in _INITS if isinstance(cfg, kind))
    ref_p, ref_s = init(cfg, device="meta")
    return (_convert(ref_p, params_np, "params", device),
            _convert(ref_s, state_np, "state", device))
