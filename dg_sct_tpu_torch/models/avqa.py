"""AVQA model (`dg_sct_tpu/models/avqa.py`, DG-SCT's `AVQA_Fusion_Net`):
(wave (B, T, L), positive frames (B, T, H, W, 3), negative frames or None,
question (B, L) token ids) -> the answer logits and the match logits.

The positive frames run the interleaved towers with adapters; the audio
feature and the adapted tower's full 6x6 token grid feed the audio-visual
grounding and its match classifier. The question encoder (embedding, tanh,
LSTM, its final hidden and cell states) queries the grounded visual and
the audio sequences through two attention blocks; their fusion times the
question feeds the answer head.

The negative frames run the frozen Swin-V2 tower alone, without gradients,
for the match classifier's negative pairs. Only training reads them: the
JAX engine feeds the positive frames there and XLA drops the branch, while
an eager forward would run it. So `visual_nega=None` skips the branch and
returns no "out_match_nega"; `out_qa` is the same either way.
Parameters and state are nested dicts and lists of tensors with the JAX
package's tree and shapes.
"""
from __future__ import annotations

import torch

from ..configs import AVQAModelConfig
from ..device import resolve_device
from ..ops.basic import (GELU_MODES, Init, dropout, layer_norm, layer_norm_init, linear,
                        linear_init, seeded_init)
from ..ops.mha import mha, mha_init
from ..ops.rnn import lstm_cell_init, lstm_with_state
from ..utils.profiling import span
from . import htsat as H
from . import interleave as I
from . import swinv2 as S
from .ave import cast_for_compute

ATTN_HEADS = 4     # the question-as-query attention blocks' heads
DROPOUT = 0.1      # their attention weights' and FFNs' dropout in training
MATCH_DIMS = (512, 256, 128, 2)  # fc1 to fc4 of the match classifier
GROUNDING_HEADS = ("fc_a1", "fc_a2", "fc_gl", "fc1", "fc2", "fc3", "fc4")


def init_qst_encoder(init: Init, vocab=93, word_embed=1536, embed=1536, hidden=1536):
    return {"word2vec": init.normal((vocab, word_embed), 1.0),
            "lstm": lstm_cell_init(init, word_embed, hidden),
            "fc": linear_init(init, 2 * hidden, embed)}


def qst_encoder(params, question):
    """question (B, L) int token ids -> (B, embed): tanh of the embedding
    through the LSTM, tanh of [h_T, c_T], then fc."""
    vec = torch.tanh(params["word2vec"][question])
    _, (h, c) = lstm_with_state(params["lstm"], vec)
    return linear(params["fc"], torch.tanh(torch.cat([h, c], dim=-1)))


def init_grounding_heads(init: Init, cfg: AVQAModelConfig):
    """The audio projection, the grounding's fc_gl and the match classifier,
    which the grounding stage trains and stage 2 takes over."""
    d = cfg.embed_dim
    dims = (2 * d,) + MATCH_DIMS
    heads = {"fc_a1": linear_init(init, cfg.htsat.num_features, d),
             "fc_a2": linear_init(init, d, d),
             "fc_gl": linear_init(init, 2 * d, d)}
    for i in range(4):
        heads[f"fc{i + 1}"] = linear_init(init, dims[i], dims[i + 1])
    return heads


def init_avqa_model(cfg: AVQAModelConfig, *, seed: int = 0, device=None):
    """Random float32 (params, state) with the JAX package's tree, from a
    torch.Generator seeded with `seed`, on `device` (None: the card). On
    device "meta" it builds shapes only."""
    init = seeded_init(seed, device)
    d = cfg.embed_dim
    htsat_params, htsat_state = H.init_htsat(init, cfg.htsat)
    adapter_params, adapter_state = I.init_adapters(init, cfg)
    params = {
        "swin": S.init_swinv2(init, cfg.swin),
        "htsat": htsat_params,
        "adapters": adapter_params,
        **init_grounding_heads(init, cfg),
        "fc_fusion": linear_init(init, 2 * d, d),
        "linear11": linear_init(init, d, d),
        "linear12": linear_init(init, d, d),
        "linear21": linear_init(init, d, d),
        "linear22": linear_init(init, d, d),
        "norm1": layer_norm_init(init, d),
        "norm2": layer_norm_init(init, d),
        "attn_a": mha_init(init, d),
        "attn_v": mha_init(init, d),
        "question_encoder": init_qst_encoder(init, cfg.qst_vocab_size, d, d, d),
        "fc_ans": linear_init(init, d, cfg.ans_vocab_size),
    }
    return params, {"htsat": htsat_state, "adapters": adapter_state}


def _grounding(params, audio_feat, visual_tokens):
    """Audio-visual grounding over the token grid and the match classifier.
    audio_feat (N, C), visual_tokens (N, HW, C) -> (match logits (N, 2),
    grounded visual feature (N, C))."""
    before = visual_tokens.mean(1)
    vnorm = visual_tokens / (torch.linalg.vector_norm(visual_tokens, dim=2, keepdim=True)
                             + 1e-12)
    anorm = audio_feat / (torch.linalg.vector_norm(audio_feat, dim=1, keepdim=True) + 1e-12)
    p = torch.softmax(torch.einsum("bnc,bc->bn", vnorm, anorm), dim=-1)
    after = torch.einsum("bn,bnc->bc", p, vnorm)
    grd = linear(params["fc_gl"], torch.tanh(torch.cat([before, after], dim=-1)))
    feat = torch.cat([audio_feat, grd], dim=-1)
    for name in ("fc1", "fc2", "fc3"):
        feat = torch.relu(linear(params[name], feat))
    return linear(params["fc4"], feat), grd


def audio_features(params, f_a):
    """The towers' audio feature (..., 768) -> (..., embed)."""
    return linear(params["fc_a2"], torch.relu(linear(params["fc_a1"], f_a)))


def _ffn(params, x, l1, l2, gen, train):
    h = dropout(gen, torch.relu(linear(params[l1], x)), DROPOUT, train and gen is not None)
    return x + dropout(gen, linear(params[l2], h), DROPOUT, train and gen is not None)


def heads(params, f_a, posi_tokens, nega_tokens, question, cfg: AVQAModelConfig, *,
          train=False, gen=None):
    """The towers' audio feature f_a (B, T, 768), the positive token grids
    (B*T, HW, C), the negative ones or None and the question -> the output
    dict of `forward`. Training with `gen`: dropout in the two attention
    blocks and their FFNs."""
    B, T = f_a.shape[0], f_a.shape[1]
    d = cfg.embed_dim
    audio = audio_features(params, f_a)                              # (B, T, d)
    qst = qst_encoder(params["question_encoder"], question)          # (B, d)
    out_match_posi, grd_posi = _grounding(params, audio.reshape(B * T, d), posi_tokens)
    out = {"out_match_posi": out_match_posi}
    if nega_tokens is not None:
        out["out_match_nega"] = _grounding(params, audio.reshape(B * T, d), nega_tokens)[0]

    xq = qst[None]                                                   # (1, B, d)
    v_seq = grd_posi.reshape(B, T, d).transpose(0, 1)                # (T, B, d)
    a_seq = audio.transpose(0, 1)
    kw = dict(num_heads=ATTN_HEADS, gen=gen if train else None, dropout_rate=DROPOUT, train=train)
    v_att = mha(params["attn_v"], xq, v_seq, v_seq, **kw)[0]
    v_att = layer_norm(params["norm1"], _ffn(params, v_att, "linear11", "linear12", gen, train))
    a_att = mha(params["attn_a"], xq, a_seq, a_seq, **kw)[0]
    a_att = layer_norm(params["norm2"], _ffn(params, a_att, "linear21", "linear22", gen, train))
    feat = torch.cat([a_att + audio.mean(1), v_att + grd_posi.reshape(B, T, d).mean(1)], dim=-1)
    feat = linear(params["fc_fusion"], torch.tanh(feat))
    out["out_qa"] = linear(params["fc_ans"], torch.tanh(feat * qst))
    return out


def nega_tokens(params, visual_nega, cfg: AVQAModelConfig, *, kernels=True, int8_attn=False,
                gelu="exact"):
    """The frozen Swin-V2 alone over (N, H, W, 3) negative frames, without
    gradients: eval-form blocks, so K1 and K2 run where they apply."""
    with torch.no_grad():
        return S.forward_features(params["swin"], visual_nega, cfg.swin, kernels=kernels,
                                  int8_attn=int8_attn, gelu=gelu)


def forward(params, state, wave, visual_posi, visual_nega, question, cfg: AVQAModelConfig, *,
            train=False, kernels=True, int8_attn=False, gelu="exact", device=None, gen=None,
            mixup_lambda=None, remat_policy="full", group=None):
    """wave (B, T, L); visual_posi and visual_nega (B, T, H, W, 3)
    channels-last frames, visual_nega None to skip the negative branch;
    question (B, L) int token ids; tensors or arrays, moved to `device`
    (None: the card), where `params` must lie. `kernels`, `int8_attn` and
    `gelu` as `models.ave.forward` takes them; the heads run no kernel.
    Outputs: out_qa (B, ans_vocab), out_match_posi (B*T, 2) and, with
    visual_nega, out_match_nega (B*T, 2).

    Eval returns the outputs. `train=True` returns (outputs, new state): the
    interleave trains as in `models.ave.forward` (no kernel there), while the
    negative branch runs the frozen tower in eval form without gradients
    (kernels as `kernels` says). `gen`, a torch.Generator on `device`, draws
    the towers' SpecAugment and drop_path and the heads' dropout (None: none
    of them); `mixup_lambda` (B*T,) mixes the log-mel maps; `remat_policy`
    is the interleave's checkpointing; `group`, data parallelism over this
    rank's rows of the global batch (`models.ave.forward`)."""
    if gelu not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu!r} not in {GELU_MODES}")
    device = resolve_device(device)
    params = cast_for_compute(params, cfg.compute_dtype)
    wave = torch.as_tensor(wave, device=device)
    if cfg.compute_dtype != torch.float32:
        wave = wave.to(cfg.compute_dtype)
    dtype = params["swin"]["patch_embed"]["kernel"].dtype
    frames = lambda v: torch.as_tensor(v, device=device).to(dtype).reshape(
        (-1,) + tuple(v.shape[2:]))
    question = torch.as_tensor(question, device=device).long()
    if mixup_lambda is not None:
        mixup_lambda = torch.as_tensor(mixup_lambda, device=device)
    gen = gen if train else None
    B, T = wave.shape[0], wave.shape[1]
    with span("dgsct.model.towers"):
        feats, new_state = I.forward(params, state, wave.reshape(B * T, -1), frames(visual_posi),
                                     cfg, kernels=kernels and not train, int8_attn=int8_attn,
                                     gelu=gelu, train=train, gen=gen, mixup_lambda=mixup_lambda,
                                     remat_policy=remat_policy, group=group)
        nega = None
        if visual_nega is not None:
            nega = nega_tokens(params, frames(visual_nega), cfg, kernels=kernels,
                               int8_attn=int8_attn, gelu=gelu)
    with span("dgsct.model.heads"):
        out = heads(params, feats["f_a"].reshape(B, T, -1), feats["vis_tokens"], nega, question,
                    cfg, train=train, gen=gen)
    return (out, new_state) if train else out
