"""Immutable configuration dataclasses of the AVE, AVS, AVVP and AVQA models,
of the CLIP x CLAP pretrain model and of training.

A copy of the AVE, AVS, AVVP, AVQA and pretrain parts of `dg_sct_tpu/configs.py` with torch dtypes: the
field names, defaults and the two static layout helpers are the same, so a
configuration means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class AudioFrontendConfig:
    """Wave -> log-mel "image" frontend (torchlibrosa extractors of the
    reference HTS-AT: n_fft 1024, hop 320, 64 slaney mel bins)."""
    sample_rate: int = 32000
    clip_seconds: int = 10
    n_fft: int = 1024
    hop_size: int = 320
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    amin: float = 1e-10
    time_drop_width: int = 64
    time_stripes_num: int = 2
    freq_drop_width: int = 8
    freq_stripes_num: int = 2
    spec_size: int = 256
    # STFT GEMM input dtype: None = float32; torch.bfloat16 rounds the frames
    # and the DFT basis to bf16 and accumulates in float32 (serving)
    stft_compute: Any = None

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins

    @property
    def clip_samples(self) -> int:
        return self.sample_rate * self.clip_seconds

    @property
    def num_frames(self) -> int:
        return self.clip_samples // self.hop_size + 1

    @property
    def target_t(self) -> int:
        return self.spec_size * self.freq_ratio


@dataclasses.dataclass(frozen=True)
class HTSATConfig:
    """HTS-AT audio Swin tower: spec 256, patch 4, dim 96, depths [2,2,6,2],
    heads [4,8,16,32], window 8."""
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: tuple = (4, 4)
    in_chans: int = 1
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    num_classes: int = 527
    ape: bool = False
    patch_norm: bool = True
    frontend: AudioFrontendConfig = dataclasses.field(default_factory=AudioFrontendConfig)

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def patches_resolution(self) -> tuple:
        r = self.spec_size // self.patch_stride[0]
        return (r, r)

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2 ** i)

    def stage_resolution(self, i: int) -> tuple:
        r = self.patches_resolution
        return (r[0] // (2 ** i), r[1] // (2 ** i))


@dataclasses.dataclass(frozen=True)
class SwinV2Config:
    """Swin-V2-Large visual tower (timm `swinv2_large_window12_192_22k`):
    192x192 input, patch 4, window 12, dims 192->1536, depths [2,2,18,2],
    heads [6,12,24,48]."""
    img_size: int = 192
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 192
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2
    pretrained_window_sizes: tuple = (0, 0, 0, 0)

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def patches_resolution(self) -> tuple:
        r = self.img_size // self.patch_size
        return (r, r)

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2 ** i)

    def stage_resolution(self, i: int) -> tuple:
        r = self.patches_resolution
        return (r[0] // (2 ** i), r[1] // (2 ** i))


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """DG-SCT `VisualAdapter` options (AVE defaults: downsample 8, 32 latent
    tokens, 2 conv groups, BN, gate, both layer norms)."""
    reduction_factor: int = 8
    num_tokens: int = 32
    num_conv_group: int = 2
    use_bn: bool = True
    use_gate: bool = True
    is_before_layernorm: bool = True
    is_post_layernorm: bool = True
    is_multimodal: bool = True
    alpha: float = 0.3
    beta: float = 0.05
    avs_variant: bool = False


@dataclasses.dataclass(frozen=True)
class AVEModelConfig:
    """Full AVE model: Swin-V2-L x HTS-AT interleave with 48 adapters, then
    the temporal-attention and CMBS heads."""
    swin: SwinV2Config = dataclasses.field(default_factory=SwinV2Config)
    htsat: HTSATConfig = dataclasses.field(default_factory=HTSATConfig)
    adapter: AdapterConfig = dataclasses.field(default_factory=AdapterConfig)
    num_frames: int = 10
    num_classes: int = 28
    d_model: int = 256
    compute_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class AVSModelConfig:
    """AVS segmentation model (DG-SCT's `Pred_endecoder`): the same towers
    and interleave, 5 frames of 224x224 a clip resized to 192 on the
    device, per-stage taps to `channel`, a 4-scale temporal head, TPAVI on
    `tpavi_stages` and an FPN decoder to (mask_size, mask_size) logits.
    AVS-variant adapters without BN; the visual ones (`adapter_vis`) keep
    their gate, the audio ones have none."""
    swin: SwinV2Config = dataclasses.field(default_factory=SwinV2Config)
    htsat: HTSATConfig = dataclasses.field(default_factory=HTSATConfig)
    adapter: AdapterConfig = dataclasses.field(
        default_factory=lambda: AdapterConfig(num_tokens=32, use_bn=False,
                                              use_gate=False, avs_variant=True))
    adapter_vis: AdapterConfig = dataclasses.field(
        default_factory=lambda: AdapterConfig(num_tokens=32, use_bn=False,
                                              use_gate=True, avs_variant=True))
    num_frames: int = 5
    channel: int = 256
    mask_size: int = 224
    tpavi_stages: tuple = (0, 1, 2, 3)
    tpavi_vv_flag: bool = False
    tpavi_va_flag: bool = True
    # the decoder's grid per stage (PVT-v2's resolutions at a 224 input)
    scale_sizes: tuple = (56, 28, 14, 7)
    compute_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class AVVPModelConfig:
    """AVVP model (DG-SCT's `MGN_Net`): the AVE towers and adapters, then
    projections to `dim`, the slim temporal attention, the r2plus1d fusion
    and the class-aware grouping heads (audio with HAN, visual, and the
    cross-modal one; depths 3/3/6) over `num_classes` class tokens. The
    assignments are "soft" or "hard"."""
    swin: SwinV2Config = dataclasses.field(default_factory=SwinV2Config)
    htsat: HTSATConfig = dataclasses.field(default_factory=HTSATConfig)
    adapter: AdapterConfig = dataclasses.field(default_factory=AdapterConfig)
    num_frames: int = 10
    num_classes: int = 25
    dim: int = 128
    depth_aud: int = 3
    depth_vis: int = 3
    depth_av: int = 6
    unimodal_assign: str = "soft"
    crossmodal_assign: str = "soft"
    compute_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class AVQAModelConfig:
    """AVQA model (DG-SCT's `AVQA_Fusion_Net`, and the stage-1 grounding
    generator on the same widths): the AVE towers with adapters of 2 latent
    tokens and 4 channel groups, no BN; the visual ones (`adapter_vis`) keep
    their gate, the audio ones have none. A question encoder over a
    `qst_vocab_size` vocabulary of `max_qst_len` tokens, audio-visual
    grounding over the visual token grid, and a `ans_vocab_size`-way answer
    head at `embed_dim`."""
    swin: SwinV2Config = dataclasses.field(default_factory=SwinV2Config)
    htsat: HTSATConfig = dataclasses.field(default_factory=HTSATConfig)
    adapter: AdapterConfig = dataclasses.field(
        default_factory=lambda: AdapterConfig(num_tokens=2, num_conv_group=4,
                                              use_bn=False, use_gate=False))
    adapter_vis: AdapterConfig = dataclasses.field(
        default_factory=lambda: AdapterConfig(num_tokens=2, num_conv_group=4,
                                              use_bn=False, use_gate=True))
    num_frames: int = 10
    embed_dim: int = 1536
    qst_vocab_size: int = 93
    ans_vocab_size: int = 42
    max_qst_len: int = 14
    compute_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """OpenAI CLIP ViT-B/32: visual tower at 224, patch 32, width 768, 12
    blocks of 12 heads; text tower of 12 blocks at width 512, 8 heads, 77
    tokens over a 49408-token vocabulary; both project to 512."""
    image_size: int = 224
    vision_patch: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8


@dataclasses.dataclass(frozen=True)
class PromptConfig:
    """CoOp prompt learning: `n_ctx` context vectors initialised from
    `ctx_init`, the class token at the "end", "middle" or "front";
    `weak=False` appends a "background" class."""
    n_ctx: int = 4
    ctx_init: str = "a photo of a"
    class_token_position: str = "end"
    weak: bool = True


@dataclasses.dataclass(frozen=True)
class PretrainModelConfig:
    """The pretrain suite's model: CLIP ViT-B/32 and the HTS-AT tower in
    lockstep, 12 ViT blocks paired 1:1 with HTS-AT's 12, an adapter pair
    around each block half (48 adapters), prompt-learned CLIP text features
    and static CLAP text features over `num_classes` classes (VGGSound-AVEL's
    141)."""
    clip: CLIPConfig = dataclasses.field(default_factory=CLIPConfig)
    htsat: HTSATConfig = dataclasses.field(default_factory=HTSATConfig)
    adapter: AdapterConfig = dataclasses.field(default_factory=AdapterConfig)
    prompt: PromptConfig = dataclasses.field(default_factory=PromptConfig)
    num_frames: int = 10
    num_classes: int = 141
    compute_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """AVE training recipe (`DG-SCT/AVE/main_trans.py` and `train.sh`): batch
    8, gradients accumulated over 2 mini-steps, Adam at lr 5e-4, StepLR
    decay_epoch / decay, early stop."""
    batch_size: int = 8
    accum_steps: int = 2
    lr: float = 5e-4
    lr_mlp: float = 5e-4
    decay_epoch: int = 10
    decay: float = 0.1
    epochs: int = 50
    early_stop: int = 10
    seed: int = 43
    mixup_alpha: float = 0.5


def vis_adapter_cfg(cfg) -> AdapterConfig:
    """The visual adapters' options: `adapter_vis` where the model has one
    (AVS, AVQA), else the shared `adapter`."""
    return getattr(cfg, "adapter_vis", None) or cfg.adapter


def ave_paired_layout(swin: SwinV2Config, htsat: HTSATConfig):
    """Static pairing plan of the interleaved dual-tower loop: per stage, a
    list of `(vis_block_idx, audio_block_idx or None, adapter_idx or None)`.
    Where a visual stage has 3x the audio blocks, audio block j sits at
    visual index 3*j + 2 and the other visual blocks run unpaired."""
    plan = []
    adapter_idx = 0
    for s in range(len(swin.depths)):
        vd, ad = swin.depths[s], htsat.depths[s]
        stage = []
        if vd == ad:
            for b in range(vd):
                stage.append((b, b, adapter_idx))
                adapter_idx += 1
        else:
            if 3 * ad != vd:
                raise ValueError(f"stage {s}: {vd} visual vs {ad} audio blocks")
            audio_at = {3 * j + 2: j for j in range(ad)}
            for b in range(vd):
                if b in audio_at:
                    stage.append((b, audio_at[b], adapter_idx))
                    adapter_idx += 1
                else:
                    stage.append((b, None, None))
        plan.append(stage)
    return plan


def ave_adapter_dims(swin: SwinV2Config, htsat: HTSATConfig):
    """Per paired block: (vis_dim, vis_tokens, audio_dim, audio_tokens)."""
    dims = []
    for s, stage in enumerate(ave_paired_layout(swin, htsat)):
        vr = swin.stage_resolution(s)
        ar = htsat.stage_resolution(s)
        for (_, _, ai) in stage:
            if ai is None:
                continue
            dims.append((swin.stage_dim(s), vr[0] * vr[1], htsat.stage_dim(s), ar[0] * ar[1]))
    return dims
