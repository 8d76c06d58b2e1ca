"""AVE inference engine: folded bf16 weights on the card, the wire formats
dequantized on the device, requests answered batch by batch.

    eng = AVEInferenceEngine(cfg, params, state, batch_size=2)
    out = eng.predict(wave, frames)
    # out["event_scores"] (n, 28) clip logits, out["is_event_scores"] (n, T),
    # out["segment_preds"] (n, T): background (28) unless sigmoid(is_event)
    # > 0.5, else the clip's argmax class

wave is float, int16 PCM or mu-law uint8, (n, T, L); frames are float or
uint8, (n, T, H, W, 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .configs import AVEModelConfig
from .device import resolve_device
from .models import ave
from .models.interleave import fold_adapters_eval
from .ops.basic import GELU_MODES, dequantize_mulaw_u8, normalize_frames_u8


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


class AVEInferenceEngine:
    def __init__(self, cfg: AVEModelConfig, params, state, *, batch_size: int, device=None,
                 compute_dtype=torch.bfloat16, gelu: str = "tanh", kernels: bool = True,
                 fold_eval: bool = True):
        """`params`/`state` as `models.ave.init_ave_model` or `weights.from_jax`
        give them, float32. `fold_eval` folds the adapters' BN and gates
        (exact in eval; K3 needs it). `kernels` and `gelu` hold for this
        engine only."""
        if gelu not in GELU_MODES:
            raise ValueError(f"gelu mode {gelu!r} not in {GELU_MODES}")
        self.device = resolve_device(device)
        if compute_dtype == torch.bfloat16 and cfg.htsat.frontend.stft_compute is None:
            # STFT GEMM inputs in bf16 with float32 sums, as the JAX engine serves
            fe = dataclasses.replace(cfg.htsat.frontend, stft_compute=torch.bfloat16)
            cfg = dataclasses.replace(cfg, htsat=dataclasses.replace(cfg.htsat, frontend=fe))
        if fold_eval:
            params, state = fold_adapters_eval(params, state, cfg)
        cast = lambda t: t.to(self.device, compute_dtype if t.is_floating_point() else t.dtype)
        self.params = _tree_map(cast, params)
        self.state = _tree_map(cast, state)
        self.cfg = cfg
        self.B = batch_size
        self.dtype = compute_dtype
        self.gelu = gelu
        self.kernels = kernels

    def _wave(self, w):
        if w.dtype == torch.int16:
            return w.to(self.dtype) * (1.0 / 32767.0)
        if w.dtype == torch.uint8:
            return dequantize_mulaw_u8(w, dtype=self.dtype)
        return w.to(self.dtype)

    def _frames(self, f):
        return normalize_frames_u8(f, self.dtype) if f.dtype == torch.uint8 else f.to(self.dtype)

    @torch.inference_mode()
    def forward_batch(self, wave, frames):
        """One batch of exactly `batch_size` clips -> the model's outputs
        (float32, on the card)."""
        wave = torch.as_tensor(wave).to(self.device, non_blocking=True)
        frames = torch.as_tensor(frames).to(self.device, non_blocking=True)
        out = ave.forward(self.params, self.state, self._wave(wave), self._frames(frames),
                          self.cfg, kernels=self.kernels, gelu=self.gelu, device=self.device)
        return {k: v.float() for k, v in out.items()}

    def predict(self, wave, frames):
        """Answer one request of n clips, batch by batch; the ragged last
        batch is padded with its last clip and the padding dropped."""
        wave, frames = np.asarray(wave), np.asarray(frames)
        n = wave.shape[0]
        ev, ie = [], []
        for s in range(0, n, self.B):
            w, f = wave[s:s + self.B], frames[s:s + self.B]
            k = w.shape[0]
            if k < self.B:
                w = np.concatenate([w] + [w[-1:]] * (self.B - k))
                f = np.concatenate([f] + [f[-1:]] * (self.B - k))
            out = self.forward_batch(w, f)
            ev.append(out["event_scores"][:k].cpu().numpy())
            ie.append(out["is_event_scores"][:k].cpu().numpy())
        ev, ie = np.concatenate(ev), np.concatenate(ie)
        n_cls = ev.shape[-1]
        pos = 1.0 / (1.0 + np.exp(-ie)) > 0.5
        return {"event_scores": ev, "is_event_scores": ie,
                "segment_preds": np.where(pos, ev.argmax(-1)[:, None], n_cls)}
