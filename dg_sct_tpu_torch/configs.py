"""Immutable configuration dataclasses of the AVE and AVS models and of AVE
training.

A copy of the AVE and AVS parts of `dg_sct_tpu/configs.py` with torch dtypes: the
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
    (AVS), else the shared `adapter`."""
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
