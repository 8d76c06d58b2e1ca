"""Parameterized hypercomplex multiplication (PHM / compacter) layers over
the JAX package's tree (`dg_sct_tpu/models/phm.py`): y = x @ H + b with
H = sum_i rule[i] (x) W[i], W and the rule optionally rank-factorized. The
reference keeps them with no live call site; the Kronecker sum is
contracted as one einsum, without building H.
"""
from __future__ import annotations

import math

import torch

from ..ops.basic import Init


def kronecker_product(a, b):
    """Batched Kronecker product: a (..., M, N), b (..., P, Q) -> (..., M*P, N*Q)."""
    M, N = a.shape[-2:]
    P, Q = b.shape[-2:]
    res = a[..., :, None, :, None] * b[..., None, :, None, :]
    return res.reshape(*a.shape[:-2], M * P, N * Q)


def kronecker_product_einsum_batched(A, B):
    """(b, a, c) x (b, k, p) -> (b, a*k, c*p)."""
    b, a, c = A.shape
    _, k, p = B.shape
    return torch.einsum("bac,bkp->bakcp", A, B).reshape(b, a * k, c * p)


def init_phm_linear(init: Init, in_features, out_features, phm_dim, *, factorized_phm=False,
                    factorized_phm_rule=False, phm_rank=1, w_init="phm", phm_init_range=1e-4,
                    bias=True):
    """`w_init` "phm" (normal, std phm_init_range, the reference's default),
    "glorot-normal" or "glorot-uniform"."""
    if in_features % phm_dim or out_features % phm_dim:
        raise ValueError(f"phm_dim {phm_dim} must divide {in_features} and {out_features}")
    d_in, d_out = in_features // phm_dim, out_features // phm_dim

    def w_draw(shape):
        fan_in, fan_out = shape[-2], shape[-1]
        if w_init == "glorot-normal":
            return init.normal(shape, math.sqrt(2.0 / (fan_in + fan_out)))
        if w_init == "glorot-uniform":
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            return init.uniform(shape, -lim, lim)
        return init.normal(shape, phm_init_range)

    p = {}
    if factorized_phm:
        p["W_left"] = w_draw((phm_dim, d_in, phm_rank))
        p["W_right"] = w_draw((phm_dim, phm_rank, d_out))
    else:
        p["W"] = w_draw((phm_dim, d_in, d_out))
    if factorized_phm_rule:
        p["phm_rule_left"] = init.normal((phm_dim, phm_dim, 1), 0.01)
        p["phm_rule_right"] = init.normal((phm_dim, 1, phm_dim), 0.01)
    else:
        p["phm_rule"] = init.normal((phm_dim, phm_dim, phm_dim), 0.01)
    if bias:
        p["b"] = init.zeros((out_features,))
    return p


def phm_linear(params, x):
    """x (..., phm_dim * d_in) -> (..., phm_dim * d_out):
    y[j * d_out + l] = sum_{i,k,p} rule[i, k, j] W[i, p, l] x[k * d_in + p]."""
    if "W_left" in params:
        W = torch.einsum("ipr,irl->ipl", params["W_left"], params["W_right"])
    else:
        W = params["W"]
    if "phm_rule_left" in params:
        rule = torch.einsum("ijr,irk->ijk", params["phm_rule_left"], params["phm_rule_right"])
    else:
        rule = params["phm_rule"]
    phm_dim, d_in, d_out = W.shape
    xs = x.reshape(*x.shape[:-1], phm_dim, d_in)
    y = torch.einsum("...ap,iab,ipl->...bl", xs, rule, W).reshape(*x.shape[:-1], phm_dim * d_out)
    if "b" in params:
        y = y + params["b"]
    return y
