"""Shared helpers of the tests that hold the PyTorch port (dg_sct_tpu_torch)
against the JAX package: configuration and parameter trees carried across,
and seeded non-trivial adapter gates and BN statistics."""
import dataclasses

import numpy as np
import jax
import torch

import dg_sct_tpu_torch.configs as PC


def port_cfg(jcfg):
    """The port's AVEModelConfig with every field of the JAX one."""
    def fields(dc, **override):
        d = {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}
        d.update(override)
        return d

    h = jcfg.htsat
    frontend = PC.AudioFrontendConfig(**fields(h.frontend, stft_compute=None))
    return PC.AVEModelConfig(
        swin=PC.SwinV2Config(**fields(jcfg.swin)),
        htsat=PC.HTSATConfig(**fields(h, frontend=frontend)),
        adapter=PC.AdapterConfig(**fields(jcfg.adapter)),
        num_frames=jcfg.num_frames, num_classes=jcfg.num_classes, d_model=jcfg.d_model)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    """numpy / JAX tree -> the same tree of CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    return torch.as_tensor(np.array(tree))


def scramble_adapters(params, state, seed=0):
    """Seeded non-zero gates and BN statistics in every adapter of a numpy
    (params, state) tree, so that the adapters change the output (they are
    zero-gated at init)."""
    rs = np.random.RandomState(seed)
    for k in ("a_p1", "v_p1", "a_p2", "v_p2"):
        for ap, ast in zip(params["adapters"][k], state["adapters"][k]):
            ap["gate"] = np.asarray([0.5 + 0.3 * rs.rand()], np.float32)
            ap["gate_av"] = np.asarray([0.3 + 0.3 * rs.rand()], np.float32)
            for bn in ("bn1", "bn2"):
                n = ap[bn]["scale"].shape[0]
                ap[bn] = {"scale": (1.0 + 0.2 * rs.randn(n)).astype(np.float32),
                          "bias": (0.1 * rs.randn(n)).astype(np.float32)}
                ast[bn] = {"mean": (0.1 * rs.randn(n)).astype(np.float32),
                           "var": (0.5 + rs.rand(n)).astype(np.float32),
                           "count": ast[bn]["count"]}
    return params, state
