"""HTS-AT audio Swin tower (frozen backbone).

The frontend (STFT, log-mel, bn0, [training: SpecAugment, mixup], mel
image, patch embed), pre-norm V1 Swin blocks with a relative-position-bias
table, and V1 patch merging (norm, then reduction), driven block by block
by the interleave, or alone without adapters (`forward_features`), and the
token-semantic head (`tscam_head`), of which the pretrain model reads only
the latent (`tscam_latent`); and the standalone AudioSet classifier with its
long-clip branches (`classifier_forward`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs import HTSATConfig
from ..ops import dsp
from ..ops.basic import (Init, batch_norm, batch_norm_init, drop_path_rates, drop_residual,
                         layer_norm, layer_norm_init, linear, linear_init, merge_2x2, mlp,
                         mlp_init, patch_embed, patch_embed_init)
from ..ops.windows import (attention_v1_init, fused_block_eligible, fused_half_block,
                           shifted_window_attention, window_attention_v1)
from ..parallel.tp import for_split


def init_block(init: Init, dim, heads, ws, mlp_ratio):
    return {"norm1": layer_norm_init(init, dim),
            "attn": attention_v1_init(init, dim, ws, heads),
            "norm2": layer_norm_init(init, dim),
            "mlp": mlp_init(init, dim, int(dim * mlp_ratio))}


def tscam_freq_bins(cfg: HTSATConfig) -> int:
    grid = cfg.spec_size // (2 ** (cfg.num_layers - 1)) // cfg.patch_stride[0]
    return max(grid // cfg.frontend.freq_ratio, 1)


def init_htsat(init: Init, cfg: HTSATConfig):
    """Returns (params, state); state carries the bn0 running stats. The tscam
    head's weights are kept so the tree matches the JAX package's; the AVE
    forward does not run them."""
    params = {"patch_embed": patch_embed_init(init, cfg.patch_size, cfg.in_chans,
                                              cfg.embed_dim, norm=cfg.patch_norm)}
    params["bn0"], bn0_state = batch_norm_init(init, cfg.frontend.mel_bins)
    layers = []
    for s in range(cfg.num_layers):
        dim = cfg.stage_dim(s)
        ws = min(cfg.window_size, min(cfg.stage_resolution(s)))
        stage = {"blocks": [init_block(init, dim, cfg.num_heads[s], ws, cfg.mlp_ratio)
                            for _ in range(cfg.depths[s])]}
        if s < cfg.num_layers - 1:
            stage["downsample"] = {"norm": layer_norm_init(init, 4 * dim),
                                   "reduction": {"kernel": init.normal((4 * dim, 2 * dim), 0.02)}}
        layers.append(stage)
    params["layers"] = layers
    params["norm"] = layer_norm_init(init, cfg.num_features)
    params["tscam_conv"] = {
        "kernel": init.normal((tscam_freq_bins(cfg), 3, cfg.num_features, cfg.num_classes), 0.02),
        "bias": init.zeros((cfg.num_classes,))}
    params["head"] = linear_init(init, cfg.num_classes, cfg.num_classes)
    return params, {"bn0": bn0_state}


def mel_features(params, state, wave, cfg: HTSATConfig, *, train=False, gen=None,
                 mixup_lambda=None, group=None):
    """wave (N, L) -> ((N, T, mel) after bn0, new state). Training: bn0 on
    the batch's statistics, then SpecAugment (when `gen` is given), then
    mixup (when `mixup_lambda` (N,) is given). `group`: data parallelism,
    bn0's statistics and mixup's flip over the global batch."""
    fcfg = cfg.frontend
    x = dsp.logmel(dsp.power_spectrogram(wave, fcfg, fcfg.stft_compute), fcfg)
    x, bn0_state = batch_norm(params["bn0"], state["bn0"], x, train=train, axis=-1, group=group)
    if train and gen is not None:
        x = dsp.spec_augment(gen, x, fcfg)
    if train and mixup_lambda is not None:
        x = dsp.do_mixup(x, mixup_lambda, group)
    return x, {"bn0": bn0_state}


def tokens_from_mel(params, x, cfg: HTSATConfig):
    """(N, T, mel) -> patch tokens; the float32 mel image goes to the tower's
    dtype at the patch embed."""
    img = dsp.reshape_wav2img(x, cfg.frontend).to(params["patch_embed"]["kernel"].dtype)
    return patch_embed(params["patch_embed"], img, cfg.patch_size)


def frontend(params, state, wave, cfg: HTSATConfig, *, train=False, gen=None,
             mixup_lambda=None, group=None):
    """wave (N, L) -> (patch tokens (N, (spec/4)^2, E), new state)."""
    x, new_state = mel_features(params, state, wave, cfg, train=train, gen=gen,
                                mixup_lambda=mixup_lambda, group=group)
    return tokens_from_mel(params, x, cfg), new_state


def block(params, x, *, dim, heads, res, ws, shift, kernels=True, gelu="exact", drop=None,
          tp=None, hidden=None):
    """Pre-norm V1 Swin block. x: (N, L, C). `drop` (mask1, mask2, rate):
    drop_path on the attention and MLP residuals (training). `tp`: an eval
    forward over tensor-parallel shards (`parallel.tp`), where the attention
    is split if the model axis divides `heads` and the MLP if it divides
    its `hidden` width; each runs whole, as in one process, otherwise."""
    tp_mlp = for_split(tp, hidden)
    tp = for_split(tp, heads)
    if fused_block_eligible(dim, heads, False, kernels, params["attn"], tp):
        x = fused_half_block(params, x, kind="v1", heads=heads, res=res, ws=ws, shift=shift)
        return x + mlp(params["mlp"], layer_norm(params["norm2"], x), gelu, kernels=kernels,
                       tp=tp_mlp)
    H, W = res
    attn_out = shifted_window_attention(
        lambda w, m, nw: window_attention_v1(params["attn"], w, num_heads=heads, ws=ws,
                                             mask=m, nW=nw, kernels=kernels, tp=tp),
        layer_norm(params["norm1"], x), H=H, W=W, ws=ws, shift=shift)
    x = x + drop_residual(attn_out, drop, 0)
    y = mlp(params["mlp"], layer_norm(params["norm2"], x), gelu, kernels=kernels, tp=tp_mlp)
    return x + drop_residual(y, drop, 1)


def patch_merging(params, x, res, *, kernels=True):
    """V1 patch merging: norm(4C) then reduction."""
    return linear(params["reduction"], layer_norm(params["norm"], merge_2x2(x, res)),
                  kernels=kernels)


def block_plan(cfg: HTSATConfig):
    """Static per-stage block metadata: dim, heads, res, ws, shift and the
    drop-path rate dpr, linearly spaced to cfg.drop_path_rate."""
    dprs = drop_path_rates(cfg.depths, cfg.drop_path_rate)
    plan = []
    for s in range(cfg.num_layers):
        res = cfg.stage_resolution(s)
        ws = min(cfg.window_size, min(res))
        first = sum(cfg.depths[:s])
        plan.append([dict(dim=cfg.stage_dim(s), heads=cfg.num_heads[s], res=res, ws=ws,
                          shift=0 if min(res) <= cfg.window_size or d % 2 == 0 else ws // 2,
                          dpr=dprs[first + d], hidden=int(cfg.stage_dim(s) * cfg.mlp_ratio))
                     for d in range(cfg.depths[s])])
    return plan


def run_tower(params, x, cfg: HTSATConfig, *, kernels=True, gelu="exact"):
    """Patch tokens -> the last stage's tokens (N, 64, 768) through every
    stage, without adapters and without drop_path (the JAX package runs the
    standalone tower without it in training too); no final norm."""
    for s, stage in enumerate(block_plan(cfg)):
        for d, m in enumerate(stage):
            x = block(params["layers"][s]["blocks"][d], x, dim=m["dim"], heads=m["heads"],
                      res=m["res"], ws=m["ws"], shift=m["shift"], kernels=kernels, gelu=gelu)
        if "downsample" in params["layers"][s]:
            x = patch_merging(params["layers"][s]["downsample"], x, cfg.stage_resolution(s),
                              kernels=kernels)
    return x


def forward_features(params, state, wave, cfg: HTSATConfig, *, train=False, gen=None,
                     mixup_lambda=None, kernels=True, gelu="exact"):
    """The tower alone: wave (N, L) -> (tokens (N, 64, 768), new state). The
    frontend trains as `frontend` does (bn0 on the batch's statistics,
    SpecAugment from `gen`, mixup); the blocks run `run_tower`. AVQA's
    grounding stage runs it."""
    x, new_state = frontend(params, state, wave, cfg, train=train, gen=gen,
                            mixup_lambda=mixup_lambda)
    return run_tower(params, x, cfg, kernels=kernels, gelu=gelu), new_state


def _tscam_strips(params, x, cfg: HTSATConfig):
    """The last stage's tokens (N, L, C) after `norm`, regrouped into the
    head's freq strips: (N, c_freq_bins, (SF / c_freq_bins) * ST, C)."""
    N, L, C = x.shape
    x = layer_norm(params["norm"], x)
    SF = ST = cfg.stage_resolution(cfg.num_layers - 1)[0]
    cfb = tscam_freq_bins(cfg)
    fr = SF // cfb
    return x.reshape(N, fr, cfb, ST, C).permute(0, 2, 1, 3, 4).reshape(N, cfb, fr * ST, C)


def tscam_latent(params, x, cfg: HTSATConfig):
    """`tscam_head(params, x, cfg)["latent_output"]` alone, bit for bit: the
    mean token after `norm`, without the tscam conv and the sigmoids the
    pretrain forward never reads (XLA drops them there; eager PyTorch would
    run them)."""
    g = _tscam_strips(params, x, cfg)
    return g.reshape(g.shape[0], -1, g.shape[-1]).mean(1)


def tscam_head(params, x, cfg: HTSATConfig):
    """Token-semantic head: the last stage's tokens (N, L, C) -> clipwise
    probabilities (N, classes), framewise ones upsampled by 8 * the time
    patch stride (N, T' * 8 * stride, classes) and the latent (N, C). The
    tscam conv spans the freq strips and 3 time steps, padded by one."""
    g = _tscam_strips(params, x, cfg)
    N, C = g.shape[0], g.shape[-1]
    latent = g.reshape(N, -1, C).mean(1)
    w = params["tscam_conv"]["kernel"].permute(3, 2, 0, 1)       # (classes, C, cfb, 3)
    out = F.conv2d(g.permute(0, 3, 1, 2), w, params["tscam_conv"]["bias"], padding=(0, 1))
    out = out[:, :, 0].transpose(1, 2)                            # (N, T', classes)
    framewise = torch.repeat_interleave(torch.sigmoid(out), 8 * cfg.patch_stride[1], dim=1)
    return {"clipwise_output": torch.sigmoid(out.mean(1)), "framewise_output": framewise,
            "latent_output": latent}


def classifier_forward(params, state, wave, cfg: HTSATConfig, *, train=False, gen=None,
                       positions=None, mixup_lambda=None, kernels=True, gelu="exact"):
    """The standalone HTS-AT classifier with its long-clip branches: wave
    (N, L) -> (`tscam_head`'s outputs, new state). Mel frames T <= target_t
    run frontend, tower and head once. Longer waves: in training one crop to
    target_t a clip, from `positions` (N,) or else drawn from `gen`
    (`dsp.crop_positions`; SpecAugment draws first), through the plain
    tower; in eval the sliding crops of `dsp.long_clip_eval_positions`,
    each through the tower and the head, the outputs averaged. Eval covers
    T <= 2 * target_t + 1, where each crop fits the mel image."""
    x, new_state = mel_features(params, state, wave, cfg, train=train, gen=gen,
                                mixup_lambda=mixup_lambda)
    target = cfg.frontend.target_t
    T = x.shape[1]
    tower = lambda xm, k: tscam_head(params, run_tower(params, tokens_from_mel(params, xm, cfg),
                                                       cfg, kernels=k, gelu=gelu), cfg)
    if T <= target:
        return tower(x, kernels and not train), new_state
    if train:
        if positions is None:
            if gen is None:
                raise ValueError("a long clip in training takes crop positions or a generator")
            positions = dsp.crop_positions(gen, x.shape[0], T, target, x.device)
        return tower(dsp.crop_mel(x, positions, target), False), new_state
    starts, crop = dsp.long_clip_eval_positions(T)
    if crop > target:
        raise ValueError(f"mel T={T} > {2 * target + 1}: the sliding-crop eval covers "
                         f"T <= 2 * target_t + 1")
    outs = [tower(dsp.crop_mel(x, torch.full((x.shape[0],), p, dtype=torch.int64), crop),
                  kernels) for p in starts]
    return {k: sum(o[k] for o in outs) / len(outs) for k in outs[0]}, new_state
