"""Inference engines: folded weights on the card in the serving type, the
wire formats dequantized on the device, requests from memory or a dataset.

    eng = AVEInferenceEngine(cfg, params, state, batch_size=4, chunk=8)
    out = eng.predict(wave, frames)
    # out["event_scores"] (n, 28) clip logits, out["is_event_scores"] (n, T),
    # out["segment_preds"] (n, T): background (28) unless sigmoid(is_event)
    # > 0.5, else the clip's argmax class
    ev, ie, pred = eng.predict_clips(dataset)
    # the same three for every clip of a map-style dataset
    # (data.ave.AVEDataset), in dataset order

    eng = AVSInferenceEngine(avs_cfg, params, state, batch_size=2, chunk=4)
    for masks, metas in eng.stream_masks(dataset):
        # masks (n, T, 224, 224) probabilities (float32 logits with
        # mask_u8=False); metas [(category, video)] in dataset order
        # (data.avs.S4Dataset)

wave is float, int16 PCM or mu-law uint8, (n, T, L); frames are float or
uint8, (n, T, H, W, 3), or, for AVE, planar YUV420: y (n, T, H, W) and uv
(n, T, H/2, W/2, 2) uint8.

Both engines stream as JAX's `_StreamingEngineBase` does: worker threads
decode `chunk` batches ahead (`data.ave.batched_iterator`), the ragged last
batch is padded with its last clip and the last chunk with its last batch,
a side stream stages each chunk from pinned host buffers
(`data.ave.device_prefetch`), and a chunk's outputs come back to pinned
memory while the next chunk runs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .configs import AVEModelConfig, AVSModelConfig
from .data.ave import batched_iterator, device_prefetch
from .device import resolve_device
from .models import ave, avs
from .models.interleave import fold_adapters_eval
from .ops import quant
from .ops.basic import (GELU_MODES, dequantize_mulaw_u8, normalize_frames_u8,
                        normalize_frames_yuv420)
from .utils.tree import tree_map

OUTPUTS = ("event_scores", "is_event_scores")


def segment_preds(ev, ie):
    """The AVE decision rule (DG-SCT/AVE/main_trans.py:309-325): background
    unless sigmoid(is_event) > 0.5, else the clip's argmax class."""
    n_cls = ev.shape[-1]
    pos = 1.0 / (1.0 + np.exp(-ie)) > 0.5
    return np.where(pos, ev.argmax(-1)[:, None], n_cls)


class _StreamingEngine:
    """What both engines share: the weights folded, cast and optionally
    quantized on the card, the wire-format ingest, and the chunked stream.
    A subclass sets `_meta(batch, first, n)` (the ids of a batch's n real
    clips) and `_run_chunk(block)` (a staged block -> {name: (chunk, ...)}
    on the card)."""

    def __init__(self, cfg, params, state, *, batch_size, chunk, device, compute_dtype,
                 prefetch, num_workers, gelu, kernels, fold_eval, int8_towers,
                 int8_adapters=False, act_scales=None):
        if gelu is None:
            gelu = "tanh" if compute_dtype == torch.bfloat16 else "exact"
        if gelu not in GELU_MODES:
            raise ValueError(f"gelu mode {gelu!r} not in {GELU_MODES}")
        self.device = resolve_device(device)
        if fold_eval:
            params, state = fold_adapters_eval(params, state, cfg)
        cast = lambda t: t.to(self.device, compute_dtype if t.is_floating_point() else t.dtype)
        self.params = tree_map(cast, params)
        self.state = tree_map(cast, state)
        if int8_towers or int8_adapters:
            towers = ("swin", "htsat", "adapters") if int8_adapters else ("swin", "htsat")
            self.params = quant.quantize_eval_params(self.params, towers=towers,
                                                     act_scales=act_scales)
        self.cfg = cfg
        self.B = batch_size
        self.chunk = chunk
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.dtype = compute_dtype
        self.gelu = gelu
        self.kernels = kernels

    def _wave(self, w):
        if w.dtype == torch.int16:
            return w.to(self.dtype) * (1.0 / 32767.0)
        if w.dtype == torch.uint8:
            return dequantize_mulaw_u8(w, dtype=self.dtype)
        return w.to(self.dtype)

    def _frames(self, f, uv=None):
        if uv is not None:
            return normalize_frames_yuv420(f, uv, dtype=self.dtype)
        return normalize_frames_u8(f, self.dtype) if f.dtype == torch.uint8 else f.to(self.dtype)

    def _to_dev(self, a):
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def _chunk_batches(self, dataset) -> Iterator[Tuple[dict, list]]:
        """The dataset in order as (chunk, B, ...) blocks -> ({"wave", "image"}
        or {"wave", "image_y", "image_uv"}, ids): ids[c] lists the ids
        (`_meta`) of batch c's clips. The last batch is padded with its last
        clip and the last block with its last batch; padding has no id."""
        acc: dict = {}
        ids: list = []
        keys = None
        for bi, batch in enumerate(batched_iterator(
                dataset, self.B, shuffle=False, drop_last=False, num_workers=self.num_workers,
                prefetch=self.prefetch * self.chunk)):
            if keys is None:
                keys = ("wave", "image_y", "image_uv") if "image_y" in batch else ("wave", "image")
            n = batch["wave"].shape[0]
            for k in keys:
                v = batch[k]
                if n < self.B:
                    v = np.concatenate([v] + [v[-1:]] * (self.B - n))
                acc.setdefault(k, []).append(v)
            ids.append(self._meta(batch, bi * self.B, n))
            if len(ids) == self.chunk:
                yield {k: np.stack(acc[k]) for k in keys}, ids
                acc, ids = {}, []
        if ids:
            while len(ids) < self.chunk:
                for k in keys:
                    acc[k].append(acc[k][-1])
                ids.append([])
            yield {k: np.stack(acc[k]) for k in keys}, ids

    def _to_host(self, out):
        """Start the device-to-host copies into pinned memory -> (host
        tensors, event or None); the values are read only after the event."""
        if self.device.type != "cuda":
            return out, None
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in out.items()}
        for k, v in out.items():
            host[k].copy_(v, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _finish(pending):
        (host, ev), ids = pending
        if ev is not None:
            ev.synchronize()
        return {k: v.numpy() for k, v in host.items()}, ids

    def stream(self, dataset) -> Iterator[Tuple[dict, list]]:
        """Yield ({output: (chunk, B, ...) numpy}, ids) per block of
        `_chunk_batches`. Block k's outputs are read after block k+1 has been
        issued, so the host's wait for them overlaps the card's work on the
        next block."""
        blocks = ({**arrays, "ids": ids} for arrays, ids in self._chunk_batches(dataset))
        pending = None
        for block in device_prefetch(blocks, device=self.device, size=self.prefetch):
            out = self._to_host(self._run_chunk(block))
            if pending is not None:
                yield self._finish(pending)
            pending = (out, block["ids"])
        if pending is not None:
            yield self._finish(pending)


class AVEInferenceEngine(_StreamingEngine):
    def __init__(self, cfg: AVEModelConfig, params, state, *, batch_size: int = 4,
                 chunk: int = 8, device=None, compute_dtype=torch.bfloat16, prefetch: int = 2,
                 num_workers: int = 8, gelu: Optional[str] = None, stft_bf16: bool = True,
                 kernels: bool = True, fold_eval: bool = True, int8_towers: bool = False,
                 int8_adapters: bool = False, act_scales=None, int8_attn: bool = False):
        """`params`/`state` as `models.ave.init_ave_model` or `weights.from_jax`
        give them, float32. `gelu` None is tanh for bf16 and exact otherwise,
        as the JAX engine serves; `stft_bf16` rounds the STFT GEMM's inputs to
        bf16 (float32 sums) when serving bf16. `fold_eval` folds the adapters'
        BN and gates (exact in eval; K3 needs it). Int8 serving
        (`ops.quant`, after the fold and the cast): `int8_towers` quantizes
        the Swin-V2 and HTS-AT linears, `int8_adapters` the adapters' too
        (and the towers'); `act_scales` ({qid: absmax} from
        `quant.calibrate_ave` over the same towers) gives static activation
        scales, None dynamic per-row ones; `int8_attn` runs the quantized
        Swin-V2 blocks' attention core in int8. `kernels`, `gelu` and the
        int8 options hold for this engine only. `predict_clips` groups
        `chunk` batches of `batch_size` clips; `num_workers` threads decode,
        and `prefetch` chunks are staged ahead."""
        if (stft_bf16 and compute_dtype == torch.bfloat16
                and cfg.htsat.frontend.stft_compute is None):
            fe = dataclasses.replace(cfg.htsat.frontend, stft_compute=torch.bfloat16)
            cfg = dataclasses.replace(cfg, htsat=dataclasses.replace(cfg.htsat, frontend=fe))
        super().__init__(cfg, params, state, batch_size=batch_size, chunk=chunk, device=device,
                         compute_dtype=compute_dtype, prefetch=prefetch,
                         num_workers=num_workers, gelu=gelu, kernels=kernels,
                         fold_eval=fold_eval, int8_towers=int8_towers,
                         int8_adapters=int8_adapters, act_scales=act_scales)
        self.int8_attn = int8_attn

    @torch.inference_mode()
    def forward_batch(self, wave, frames, frames_uv=None):
        """One batch of exactly `batch_size` clips -> the model's outputs
        (float32, on the card). With `frames_uv`, `frames` is the Y plane."""
        uv = None if frames_uv is None else self._to_dev(frames_uv)
        out = ave.forward(self.params, self.state, self._wave(self._to_dev(wave)),
                          self._frames(self._to_dev(frames), uv), self.cfg,
                          kernels=self.kernels, int8_attn=self.int8_attn, gelu=self.gelu,
                          device=self.device)
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
        return {"event_scores": ev, "is_event_scores": ie, "segment_preds": segment_preds(ev, ie)}

    @staticmethod
    def _meta(batch, first, n):
        return list(range(first, first + n))

    @torch.inference_mode()
    def _run_chunk(self, block):
        """Every batch of a staged block -> {output: (chunk, B, ...) float32}
        on the card."""
        uv = block.get("image_uv")
        frames = block["image_y"] if uv is not None else block["image"]
        outs = [self.forward_batch(block["wave"][c], frames[c], None if uv is None else uv[c])
                for c in range(block["wave"].shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in OUTPUTS}

    def predict_clips(self, dataset):
        """The whole dataset -> (event_scores (N, 28), is_event_scores (N, T),
        segment_preds (N, T)) in dataset order, padding removed. `stream`
        yields the blocks: ({"event_scores" (chunk, B, 28), "is_event_scores"
        (chunk, B, T)}, ids)."""
        ev_all, ie_all = [], []
        for out, ids in self.stream(dataset):
            for c, row in enumerate(ids):
                if row:
                    ev_all.append(out["event_scores"][c, :len(row)])
                    ie_all.append(out["is_event_scores"][c, :len(row)])
        ev, ie = np.concatenate(ev_all), np.concatenate(ie_all)
        return ev, ie, segment_preds(ev, ie)


class AVSInferenceEngine(_StreamingEngine):
    def __init__(self, cfg: AVSModelConfig, params, state, *, batch_size: int = 2,
                 chunk: int = 4, device=None, compute_dtype=torch.bfloat16, prefetch: int = 2,
                 num_workers: int = 8, gelu: Optional[str] = None, kernels: bool = True,
                 fold_eval: bool = True, int8_towers: bool = False, act_scales=None,
                 mask_u8: bool = True):
        """Streaming AVS S4/MS3 masks. `params`/`state` as
        `models.avs.init_avs_model` or `weights.from_jax` give them, float32.
        `gelu`, `kernels`, `fold_eval` (a no-op for the AVS adapters: no BN,
        and their gate precedes ln_post), `int8_towers` with `act_scales`
        (from `quant.calibrate_avs`) and the streaming knobs as
        `AVEInferenceEngine` takes them. `mask_u8` ships round(sigmoid(logits)
        * 255) as uint8 from the card (a quarter of the bytes, within 0.5/255
        of the probability); False ships the float32 logits."""
        super().__init__(cfg, params, state, batch_size=batch_size, chunk=chunk, device=device,
                         compute_dtype=compute_dtype, prefetch=prefetch,
                         num_workers=num_workers, gelu=gelu, kernels=kernels,
                         fold_eval=fold_eval, int8_towers=int8_towers, act_scales=act_scales)
        self.mask_u8 = mask_u8

    @torch.inference_mode()
    def forward_batch(self, wave, frames):
        """One batch of exactly `batch_size` clips -> (B*T, H, W) on the card:
        uint8 probabilities x 255 with `mask_u8`, else float32 logits."""
        out = avs.forward(self.params, self.state, self._frames(self._to_dev(frames)),
                          self._wave(self._to_dev(wave)), self.cfg, kernels=self.kernels,
                          gelu=self.gelu, device=self.device)
        pred = out["pred"][..., 0].float()
        if self.mask_u8:
            return torch.round(torch.sigmoid(pred) * 255.0).to(torch.uint8)
        return pred

    @staticmethod
    def _meta(batch, first, n):
        return list(zip(batch["category"], batch["video"]))[:n]

    @torch.inference_mode()
    def _run_chunk(self, block):
        return {"masks": torch.stack([self.forward_batch(block["wave"][c], block["image"][c])
                                      for c in range(block["wave"].shape[0])])}

    def stream_masks(self, dataset) -> Iterator[Tuple[np.ndarray, list]]:
        """Yield (masks (n, T, H, W) float32: probabilities, or logits with
        mask_u8=False; metas [(category, video)]) per chunk, in dataset order,
        the padding removed."""
        T = self.cfg.num_frames
        for out, metas in self.stream(dataset):
            arr = out["masks"]                                  # (chunk, B*T, H, W)
            arr = arr.reshape((arr.shape[0], -1, T) + arr.shape[2:])
            if self.mask_u8:
                arr = arr.astype(np.float32) / 255.0
            rows = [arr[c, :len(row)] for c, row in enumerate(metas) if row]
            yield (np.concatenate(rows) if rows else arr[:0, 0]), [m for row in metas
                                                                  for m in row]
