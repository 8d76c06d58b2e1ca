"""Parameter bundles as one `.npz` of path-flattened arrays ("a/b/0/c"
keys), the format of `dg_sct_tpu/utils/checkpoint.py`: a bundle written by
either package reads in the other. Trees are nested dicts and lists of numpy
arrays or tensors; tensors are copied to the host on save. Train-state
bundles are read for their params and state only.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(path: str, tree) -> None:
    """Write `tree` to `path` through a temporary file and a rename, so a
    crash mid-write leaves any earlier file whole."""
    flat = _flatten(tree)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_params(path: str):
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def load_params_and_state(path: str):
    """(params, state or None) from a params-only file, a {"params",
    "state"} bundle or a JAX train-state bundle."""
    tree = load_params(path)
    if "bundle" in tree:
        return tree["bundle"]["params"], tree["bundle"]["state"]
    if "params" in tree:
        return tree["params"], tree.get("state")
    return tree, None
