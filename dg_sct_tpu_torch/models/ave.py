"""AVE model: (wave (B, T, L), frames (B, T, H, W, 3)) -> is_event_scores
(B, T), event_scores (B, 28), av_gate (B, T), av_score (B, 28); in training
also the new BN state.

Parameters and state are nested dicts and lists of tensors with the JAX
package's tree and shapes (`dg_sct_tpu/models/ave.py`).
"""
from __future__ import annotations

import torch

from ..configs import AVEModelConfig
from ..device import resolve_device
from ..ops.basic import GELU_MODES, seeded_init
from ..parallel.comm import gather_frames
from ..utils.profiling import span
from ..utils.tree import tree_map
from . import htsat as H
from . import interleave as I
from . import swinv2 as S
from .heads import ave as heads


def init_ave_model(cfg: AVEModelConfig, *, seed: int = 0, device=None):
    """Random float32 (params, state) from a torch.Generator seeded with
    `seed`, on `device` (None: the card). On device "meta" it builds shapes
    only."""
    init = seeded_init(seed, device)
    htsat_params, htsat_state = H.init_htsat(init, cfg.htsat)
    adapter_params, adapter_state = I.init_adapters(init, cfg)
    params = {
        "swin": S.init_swinv2(init, cfg.swin),
        "htsat": htsat_params,
        "adapters": adapter_params,
        "temporal_attn": heads.init_temporal_attention(init, cfg.swin.num_features,
                                                       cfg.htsat.num_features),
        "CMBS": heads.init_cmbs(init, cfg.num_classes),
    }
    return params, {"htsat": htsat_state, "adapters": adapter_state}


def cast_for_compute(tree, dtype):
    """The float leaves of `tree` as `dtype` copies (differentiable: the
    gradients come back through the cast to the float32 masters); float32
    or None leaves the tree as it is."""
    if dtype in (None, torch.float32):
        return tree
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def forward(params, state, wave, images, cfg: AVEModelConfig, *, train=False, kernels=True,
            int8_attn=False, gelu="exact", device=None, gen=None, mixup_lambda=None,
            remat_policy="full", group=None, tp=None, seq=None, pipeline=None):
    """wave: (B, T, L); images: (B, T, H, W, 3) channels-last frames, both
    tensors or arrays, moved to `device` (None: the card), where `params`
    must lie. `kernels` runs K1-K3 where the JAX package's three Pallas
    flags would, and K4 for the linears of a tree quantized by `ops.quant`;
    `int8_attn` runs the quantized Swin-V2 blocks' attention core in int8
    (the JAX package's `set_int8_attn`, here per call); `gelu` is "exact" or
    "tanh". Frames fold into the batch axis as (b t).

    Eval returns the outputs. `train=True` returns (outputs, new state):
    BN on the batch's statistics and no kernel, whatever `kernels` says (as
    the JAX package trains through none); `gen`, a torch.Generator on
    `device`, draws SpecAugment, drop_path and dropout (None: none of them);
    `mixup_lambda` (B*T,) mixes the log-mel maps; `remat_policy` is the
    interleave's checkpointing ("full", "dots" or "none"). With a
    `cfg.compute_dtype` other than float32, the float params and the inputs
    are cast to it here; gradients flow back through the cast.

    Parallel modes (`parallel/`): `group`, a data-parallel group (training
    on this rank's rows of the global batch: `gen` a `RowShard`, BN
    statistics and mixup over the whole batch); in eval `tp`, a
    `parallel.tp.TensorParallel` over shards from `mesh.tp_shard_params`;
    `seq`, a sequence-parallel group: wave and images hold this rank's
    T / seq frames of each clip, the towers and adapters run them without a
    collective (they are frame-local in eval), and the heads' inputs are
    gathered to the whole clip; `pipeline` = (pipe group, n_micro), stage
    2's repeated pairs through GPipe, and the outputs hold
    "pipelined_stages"."""
    if gelu not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu!r} not in {GELU_MODES}")
    if train and (tp is not None or seq is not None or pipeline is not None):
        raise ValueError("tensor, sequence and pipeline parallelism run eval forwards only")
    device = resolve_device(device)
    wave = torch.as_tensor(wave, device=device)
    images = torch.as_tensor(images, device=device)
    params = cast_for_compute(params, cfg.compute_dtype)
    if cfg.compute_dtype != torch.float32:
        wave = wave.to(cfg.compute_dtype)
    images = images.to(params["swin"]["patch_embed"]["kernel"].dtype)
    if mixup_lambda is not None:
        mixup_lambda = torch.as_tensor(mixup_lambda, device=device)
    B, T = wave.shape[0], wave.shape[1]
    with span("dgsct.model.towers"):
        feats, new_state = I.forward(params, state, wave.reshape(B * T, -1),
                                     images.reshape((B * T,) + tuple(images.shape[2:])), cfg,
                                     kernels=kernels and not train, int8_attn=int8_attn, gelu=gelu,
                                     train=train,
                                     gen=gen if train else None, mixup_lambda=mixup_lambda,
                                     remat_policy=remat_policy, group=group, tp=tp,
                                     pipeline=pipeline)
    with span("dgsct.model.heads"):
        f_v = feats["f_v"].reshape(B, T, -1)
        f_a = feats["f_a"].reshape(B, T, -1)
        if seq is not None:
            f_v, f_a = gather_frames(f_v, seq), gather_frames(f_a, seq)
        head_gen = gen if train else None
        video_q, audio_q, av_gate = heads.temporal_attention(params["temporal_attn"], f_v, f_a,
                                                             train=train, gen=head_gen)
        is_event_scores, event_scores, av_score = heads.cmbs(params["CMBS"], video_q, audio_q)
        out = {"is_event_scores": is_event_scores[..., 0].transpose(0, 1),
               "event_scores": event_scores,
               "av_gate": av_gate[..., 0].transpose(0, 1),
               "av_score": av_score}
        if pipeline is not None:
            out["pipelined_stages"] = feats["pipelined_stages"]
    return (out, new_state) if train else out
