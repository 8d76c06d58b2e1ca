"""Parameter and train-state bundles as one `.npz` of path-flattened arrays
("a/b/0/c" keys), the format of `dg_sct_tpu/utils/checkpoint.py`: the
params and state of a bundle written by either package read in the other.
Trees are nested dicts and lists of numpy arrays, tensors or Python
numbers; tensors are copied to the host on save.

A train-state bundle ({"bundle": {"params", "state", "opt_state",
"rng_state", "step"}}) keeps the JAX layout for params and state; the
optimizer state (`train.optim.AccumulatedAdam`) and the torch.Generator
state are the port's own. Saving and loading it on one device resumes
training bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from .tree import tree_leaves, tree_map, tree_unflatten


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


def save_train_state(path: str, *, params, state, opt_state, rng_state, step: int,
                     metadata: dict | None = None) -> None:
    """`rng_state`: the train generator's `get_state()`. `metadata`, if any,
    goes to `path + ".meta.json"`."""
    save_params(path, {"bundle": {"params": params, "state": state, "opt_state": opt_state,
                                  "rng_state": rng_state, "step": np.asarray(step)}})
    if metadata:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f)


def load_train_state(path: str, opt_state_template=None):
    """-> (params, state, opt_state, rng_state (uint8 CPU tensor), step), the
    trees as numpy arrays; with `opt_state_template` (the optimizer's
    `init`), opt_state on its structure, devices and types."""
    tree = load_params(path)["bundle"]
    opt_state = tree["opt_state"]
    if opt_state_template is not None:
        opt_state = restore_structure(opt_state_template, opt_state)
    return (tree["params"], tree["state"], opt_state, torch.from_numpy(tree["rng_state"]),
            int(tree["step"]))


def restore_structure(template, loaded):
    """`loaded`'s leaves hung on `template`'s structure by position (dict
    keys sorted), each a tensor on the template leaf's device and type, or
    a Python number where the template has one."""
    def like(ref, val):
        if isinstance(ref, torch.Tensor):
            return torch.as_tensor(np.array(val), device=ref.device).to(ref.dtype)
        return type(ref)(np.asarray(val).item()) if isinstance(ref, (int, float)) else val
    return tree_map(like, template, tree_unflatten(template, tree_leaves(loaded)))


def restore_matching(template, loaded):
    """Path-aware partial restore: each leaf of `template` takes the leaf of
    `loaded` at the same path ("a/b/0/c") when the shapes agree, as a tensor
    on the template leaf's device and type, and keeps its own value
    otherwise (as the reference skips a prompt learner's buffers when the
    class list changes). -> (tree on `template`'s structure, the paths of
    `loaded` that were not taken)."""
    flat = _flatten(loaded)
    used = set()

    def take(node, prefix):
        if isinstance(node, dict):
            return {k: take(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [take(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        key = prefix[:-1]
        val = flat.get(key)
        if val is None or tuple(np.shape(val)) != tuple(node.shape):
            return node
        used.add(key)
        return torch.as_tensor(np.array(val), device=node.device).to(node.dtype)

    return take(template, ""), sorted(set(flat) - used)
