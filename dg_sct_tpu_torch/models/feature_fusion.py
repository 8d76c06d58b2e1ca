"""CLAP's attentional feature fusion: DAF, AFF and iAFF
(`dg_sct_tpu/models/feature_fusion.py`; the reference's
`pretrain/nets/feature_fusion.py`, after Dai et al., WACV 2021).

Channel-last: (N, L, C) or (N, H, W, C); each of the reference's 1x1
convolutions is a linear over the channel axis. The reference's quirks
stay: iAFF's second round reuses `global_att` (its `global_att2` weights
exist and are never applied), and a batch of one is duplicated around the
BatchNorms and the first half taken back. The released CLAP checkpoint's
fusion weights are skipped by the reference's loader, so no model of the
port runs these.
"""
from __future__ import annotations

import torch

from ..ops.basic import Init, batch_norm, batch_norm_init, linear, linear_init

ATT_BLOCKS = ("local_att", "global_att", "local_att2", "global_att2")


def _init_att_block(init: Init, channels, inter):
    p1, s1 = batch_norm_init(init, inter)
    p2, s2 = batch_norm_init(init, channels)
    params = {"fc1": linear_init(init, channels, inter), "bn1": p1,
              "fc2": linear_init(init, inter, channels), "bn2": p2}
    return params, {"bn1": s1, "bn2": s2}


def _att_block(params, state, x, *, train, global_pool=False):
    """fc1 -> BN -> ReLU -> fc2 -> BN, after a mean over the spatial axes
    when `global_pool`."""
    if global_pool:
        x = x.mean(dim=tuple(range(1, x.ndim - 1)), keepdim=True)
    h, bn1 = batch_norm(params["bn1"], state["bn1"], linear(params["fc1"], x), train=train)
    h, bn2 = batch_norm(params["bn2"], state["bn2"], linear(params["fc2"], torch.relu(h)),
                        train=train)
    return h, {"bn1": bn1, "bn2": bn2}


def daf(x, residual):
    """DirectAddFuse."""
    return x + residual


def init_aff(init: Init, channels=64, r=4):
    parts = [_init_att_block(init, channels, channels // r) for _ in range(2)]
    return ({"local_att": parts[0][0], "global_att": parts[1][0]},
            {"local_att": parts[0][1], "global_att": parts[1][1]})


def _dup_guard(xa):
    """A batch of one duplicated (BatchNorm needs two), and whether it was."""
    if xa.shape[0] == 1:
        return torch.cat([xa, xa], dim=0), True
    return xa, False


def _weights(params, state, xa, local, glob, *, train):
    """sigmoid(local(xa) + global(xa)) with the batch-of-one guard -> (wei,
    local state, global state)."""
    xa2, dup = _dup_guard(xa)
    xl, sl = _att_block(params[local], state[local], xa2, train=train)
    xg, sg = _att_block(params[glob], state[glob], xa2, train=train, global_pool=True)
    wei = torch.sigmoid(xl + xg)
    return (wei[:1] if dup else wei), sl, sg


def aff(params, state, x, residual, *, train=False):
    """AFF: out = 2 x wei + 2 residual (1 - wei), as the reference's forward
    scales both branches -> (out, new state)."""
    wei, sl, sg = _weights(params, state, x + residual, "local_att", "global_att", train=train)
    out = 2.0 * x * wei + 2.0 * residual * (1.0 - wei)
    return out, {"local_att": sl, "global_att": sg}


def init_iaff(init: Init, channels=64, r=4):
    params, state = {}, {}
    for name in ATT_BLOCKS:
        params[name], state[name] = _init_att_block(init, channels, channels // r)
    return params, state


def iaff(params, state, x, residual, *, train=False):
    """iAFF: two attention rounds; round 2 applies `global_att` again (on
    the state round 1 left), never `global_att2` -> (out, new state)."""
    wei, sl, sg = _weights(params, state, x + residual, "local_att", "global_att", train=train)
    xi = x * wei + residual * (1.0 - wei)
    round2 = dict(state, global_att=sg)
    wei2, sl2, sg2 = _weights(params, round2, xi, "local_att2", "global_att", train=train)
    out = x * wei2 + residual * (1.0 - wei2)
    return out, {"local_att": sl, "global_att": sg2, "local_att2": sl2,
                 "global_att2": state["global_att2"]}
