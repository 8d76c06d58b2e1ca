"""LSTM with torch's gate layout (i, f, g, o) and dual biases, batch-first.

Weights are stored as in the JAX package: wi (in, 4H), wh (H, 4H), bi, bh.
The input projection runs once for all steps; the recurrence is a loop
over the T (= 10) segments.
"""
from __future__ import annotations

import math

import torch

from .basic import Init


def lstm_cell_init(init: Init, in_dim, hidden):
    bound = 1.0 / math.sqrt(hidden)
    u = lambda shape: init.uniform(shape, -bound, bound)
    return {"wi": u((in_dim, 4 * hidden)), "wh": u((hidden, 4 * hidden)),
            "bi": u((4 * hidden,)), "bh": u((4 * hidden,))}


def bilstm_init(init: Init, in_dim, hidden):
    return {"fwd": lstm_cell_init(init, in_dim, hidden),
            "bwd": lstm_cell_init(init, in_dim, hidden)}


def _lstm(params, x, reverse=False):
    """x: (B, T, D) -> (B, T, H)."""
    return _lstm_with_state(params, x, reverse)[0]


def _lstm_with_state(params, x, reverse=False):
    """x: (B, T, D) -> ((B, T, H), (h_T, c_T)), the state after the last
    step taken."""
    B, T, _ = x.shape
    Hd = params["wh"].shape[0]
    xp = x @ params["wi"] + (params["bi"] + params["bh"])
    h = c = x.new_zeros((B, Hd))
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = torch.split(xp[:, t] + h @ params["wh"], Hd, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[t] = h
    return torch.stack(outs, dim=1), (h, c)


def bilstm(params, x):
    """Bidirectional single-layer LSTM: (B, T, D) -> (B, T, 2H)."""
    return torch.cat([_lstm(params["fwd"], x), _lstm(params["bwd"], x, reverse=True)], dim=-1)


def lstm(params, x):
    """Unidirectional single-layer LSTM: (B, T, D) -> (B, T, H)."""
    return _lstm(params, x)


def lstm_with_state(params, x):
    """Unidirectional single-layer LSTM -> (outputs (B, T, H), (h_T, c_T)),
    the final hidden and cell states the AVQA question encoder reads."""
    return _lstm_with_state(params, x)
