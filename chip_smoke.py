#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dg_sct_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); TF32 off for matmul and cuDNN;
  2. build the kernels from the four sources of csrc/ (one nvcc per source, in
     parallel);
  3. hold each kernel against its plain PyTorch version at every shape of the
     main path, in float32 and bfloat16, and time kernel, plain version and
     the yardsticks the port never calls: for K1 `scaled_dot_product_attention`
     (library_ms), for K2 and K3 a composition of library calls (composed_ms);
     for K2 in bf16 also the device time of each of its kernels (stages_ms);
     for K4 (the int8 linear, at the 56 (rows, K, N) of one B=2 int8 forward,
     static scales, and dynamic ones checked too) the quantize / `torch._int_mm`
     / dequantize composition (composed_ms) and a bf16 addmm of the same shape
     (matmul_ms); K4's two kernels, its quantize pass (`int8_quantize`, also
     timed alone) and its int8 GEMM (checked alone on the plain quantize's
     output), are held exact (error 0), static and dynamic, and `k4:` lines
     give each shape's times, then `k4 sums:` one forward's. Times as the
     host issues the calls (ms) and, for kernel and
     yardsticks, the card's time alone (device_ms). The float32 checks of K1
     and K2 run after a launch that leaves NaN in shared memory. `k3 f32:`
     lines give K3's float32 main-path shapes (3xTF32 on the tensor cores)
     beside a planted fault, the plain version with both products' operands
     rounded to TF32 (TF32 alone), each against the plain version on the
     same inputs as error over TOL, then `k3 f32 sums:` one forward's. K3 also at
     shapes off the main path: ragged row tiles, no LN_before, four groups of
     24 or 48 channels; K1 and K2 also at phase 8's shapes (10 frames a
     forward), checked in both dtypes, not timed; K3 also at each of phase
     12's eight shapes (four groups: C/g 24 to 384, go = C/32), checked and
     timed in both dtypes against the composed calls and the bound, one AVQA
     forward's sums on `avqa k3:` lines;
  4. drive the full-width AVE eval forward (AVEModelConfig(), random weights
     from seed 0, nonzero adapter gates) through AVEInferenceEngine: B=2 clips
     in bf16, 3 predict requests; check outputs, launch counts K1=2, K2=34,
     K3=48 per forward, and one float32 kernel forward against the float32
     plain forward;
  5. serve through `predict_clips`: a DG-SCT state dict synthesized from the
     key census of best_82.18.pt goes through the import path (converter,
     key census, `from_jax`) into a bf16 engine (B=2, chunk=2), which answers
     7 full-width clips in memory in both wire formats (int16 wave with
     uint8 RGB; mu-law wave with YUV420), twice each, and once with chunk=3
     (a padded chunk); checks shapes, finite scores, launch counts of 2/34/48
     per forward and, for uint8 RGB, agreement with `predict` within bf16
     TOL; then, if Pillow imports, the same over a 7-video tree of 320x320
     JPEGs on disk (prints the decoder, native or PIL); then `stream:` lines:
     clips/s of `predict_clips` over 32 clips per wire format beside
     `predict`, host-to-device bytes per forward, and the host-to-device
     copies of a profiled run (time a forward, kind, overlap with kernels);
  6. train the same widths (random weights from seed 0, nonzero adapter
     gates) in bf16 over float32 Adam masters with remat "full": B=8 clips
     (80 frames and 80 audio clips), accum 2, 4 mini-steps on seeded
     synthetic batches with a mixup lambda and a generator, so SpecAugment,
     drop_path and dropout are on; checks a finite loss at each, no change
     after mini-step 1, every trainable leaf changed after mini-step 2 but
     the unused ones, every frozen leaf bit-identical, the BN running state
     of bn0 and the adapters moved, no kernel launched; prints each
     mini-step's time and the peak memory (`train:` lines), a profiled
     mini-step (`train profile:`), two mini-steps of B=8 with remat "none"
     (their times and peak memory), the eval step on the trained weights
     (launches K1/K2/K3 = 2/34/0), and the saved train state loaded into
     the engine, which folds it and answers 2 clips (2/34/48);
  7. serve the same widths in int8 (`int8:` lines): calibrate static
     activation scales on a seeded B=2 batch (towers and adapters), then an
     engine with int8_towers, int8_adapters and those scales answers 3
     requests of B=2 clips in bf16 in turns with a bf16 engine on the same
     weights and requests: clips/s of both, each engine's weight bytes
     and a request's peak memory above what was resident, launches
     K1/K2/K3/K4 = 34/2/48/430 per forward (and 430 quantize launches),
     drift against bf16 (max |delta
     event_scores| over the spread, share of segment_preds that agree), one
     profiled int8 forward (K4 its own group); in float32, the int8 forward
     with kernels against the int8 plain forward (INT8_TOL, per output) and
     each of its 430 K4 calls against the plain version on its own input
     (exact); then one
     forward each of towers only (K4 = 142), dynamic scales and int8_attn
     (K1 = 10), with launch counts and finite outputs checked;
  8. serve the AVS model at full width (AVSModelConfig(): the same towers,
     48 AVS-variant adapters, TPAVI on 4 stages, the FPN decoder): a state
     dict synthesized from the key census of the AVS S4 checkpoint goes
     through `convert_avs_model` (0 unexplained keys) and `from_jax` into a
     bf16 AVSInferenceEngine (B=2, chunk=2), which streams 7 clips of an
     on-disk AVSBench tree (PNG frames and masks at 224, .npy waves of 5 x
     320000) through `stream_masks`: launches 4 x (K1/K2/K3/K4 = 2/34/0/0),
     masks (7, 5, 224, 224) finite in [0, 1], metas in dataset order; in
     float32 the engine with kernels against the plain one (launches
     2/34/0/0 a forward, each K1 and K2 call against the plain version on
     its own input (TOL); AVS_F32_TOL of the logits' spread, beside the
     plain path's own move under a 1e-6 relative change of its inputs, and
     the bound read against faults PLANTED in front of K2, each of which it
     must catch) and uint8 masks against sigmoid(logits) (0.5/255); clips/s of
     `stream_masks` over 16 in-memory clips in two wire formats (uint8
     frames with int16 waves; S4Dataset's float32 items), two rounds each;
     one profiled forward (cuDNN convolutions and TPAVI's products as their
     own groups) and its peak memory; `calibrate_avs` on a seeded B=2 batch
     and an int8_towers engine (launches 34/2/0/142 a forward, drift against
     bf16); in float32 the int8-towers forward with kernels against the
     int8 plain one (AVS_INT8_TOL on the mean |delta| over the mean |logit|,
     and faults planted in front of K1) and each of its 142 K4 and 34 K1
     calls against the plain version on its own input.
     The bounds of this phase are checked once every reading is printed;
  9. train the AVS model at full width (AVSModelConfig(), random weights from
     seed 0, the visual adapters' gates and TPAVI's BN scales set nonzero
     from seed 1) in float32, TF32 off, at the recipe's step (B=4 clips: 20
     frames and 20 audio clips, accum 1, Adam at 3e-4, remat "full"): 3 S4
     mini-steps on seeded synthetic batches with a generator (SpecAugment
     and the head's dropout on), each loss finite, every trainable leaf
     changed after them but the unused ones (the head's decoders, path4's
     skip unit, the AVS adapters' ln_before and token_resample) and the
     TPAVI W_z biases (exact gradient 0: a BN on the batch's statistics
     follows), every frozen leaf bit-identical, the BN state of bn0 and
     each TPAVI moved, no kernel launched; each mini-step's time and the
     peak memory (`avs train:` lines); 2 MS3 mini-steps (every frame's BCE
     and the KL term on the 4 TPAVI stages), finite losses; TPAVI stage 0
     alone in training, the memory it holds and its forward's peak; one
     mini-step with remat "none" (time, peak memory); one profiled S4
     mini-step (`avs train profile:`, cuDNN convolutions and TPAVI's
     products, forward and backward, as their own groups); the eval step on
     the trained weights (launches K1/K2/K3/K4 = 2/34/0/0, masks finite in
     [0, 1]); the saved train state loaded into a bf16 AVSInferenceEngine,
     which answers 2 clips (2/34/0/0); and `avs_main.main(["--mode",
     "train", "--task", "s4", "--epochs", "1", ...])` once, on the card by
     default, over an on-disk tree with train and test splits: it must save
     `s4_best.npz` and print a test mIoU and F-score in [0, 1].
  10. serve the AVVP model at full width (AVVPModelConfig(): the AVE towers
     and 48 adapters, the slim temporal attention and the grouping heads at
     dim 128, depths 3/3/6): a state dict synthesized from the key census of
     DG-SCT's MGN_Net checkpoint goes through `convert_avvp_model` (0
     unexplained keys) and `from_jax` into a bf16 AVVPInferenceEngine (B=2,
     chunk=2), which streams 7 clips of an on-disk LLP tree (JPEG frames at
     192, .npy waves of 10 x 32000, r2plus1d features (10, 512)) through
     `stream_probs`: launches 4 x (K1/K2/K3/K4 = 2/34/48/0), clip
     probabilities (7, 25) in [0, 1], frame probabilities (7, 10, 25) in
     [0, 2], ids in dataset order; in float32 the engine with kernels
     against the plain one (launches 2/34/48/0 a forward, each K1, K2 and K3
     call against the plain version on its own input (TOL); the HAN's hard
     assignment: its smallest top-1/top-2 logit gap beside the kernels'
     largest logit change, and no argmax flipped; AVVP_F32_TOL of the five
     outputs' largest value, beside the plain path's own move under a 1e-6
     relative change of its inputs and the readings of two faults planted
     in front of K3, which the bound must catch); clips/s of `stream_probs`
     over 16 in-memory clips in two wire formats (uint8 frames with int16
     waves; LLPDataset's float32 items), two rounds each; one profiled
     forward (the grouping heads and the temporal gates as their own
     groups) and its peak memory; `calibrate_avvp` on a seeded B=2 batch
     and an int8_towers engine (launches 34/2/48/142 a forward, drift
     against bf16) and each K4 call of a float32 int8 forward against its
     plain version. The bounds of this phase are checked once every reading
     is printed;
  11. train the AVVP model at full width (AVVPModelConfig(), random weights
     from seed 0, the adapters' gates and the class tokens set from seed 1)
     in float32, TF32 off, at the recipe's step (B=8 clips: 80 frames and 80
     audio clips of 1 s, accum 1, Adam at 5e-4, remat "full"): 3 mini-steps
     on seeded synthetic batches with a generator (SpecAugment, drop_path
     and the HAN's Gumbel noise on), each loss finite, every trainable leaf
     changed after them (the forward reads each), every frozen leaf
     bit-identical, the BN state of bn0 and the adapters moved, no kernel
     launched; each mini-step's time and the peak memory (`avvp train:`
     lines); one profiled mini-step; one mini-step of B=2 with remat "none"
     (float32 B=8 would not fit); the eval step on the trained weights
     (launches 2/34/0/0); `avvp_main.main(["--mode", "train", "--epochs",
     "1", ...])` once, on the card by default, over an on-disk LLP tree of
     8 videos: it must save `MGN_Net.npz` and report F1 in [0, 100]; and that
     train state loaded into a bf16 AVVPInferenceEngine, which answers 2
     clips (2/34/48/0).
  12. serve the AVQA model at full width (AVQAModelConfig(): the AVE towers,
     48 adapters of 2 latent tokens and 4 channel groups, the visual ones
     gated, the question encoder and the grounding and fusion heads at 1536):
     the census of DG-SCT's stage-1 grounding checkpoint through
     `convert_avqa_grounding` (0 unexplained keys, shape audit), then a state
     dict synthesized from the key census of the AVQA_Fusion_Net checkpoint
     (gates nonzero from the seed) through `convert_avqa_fusion` (0
     unexplained keys) and `from_jax` into a bf16 AVQAInferenceEngine (B=2,
     chunk=2, every adapter folded), which streams 7 questions of an on-disk
     MUSIC-AVQA tree (JPEG frames at 192, .npy waves of 10 x 320000,
     templated questions) through `stream_answers`: launches 4 x
     (K1/K2/K3/K4 = 2/34/48/0), logits (7, 42) finite, metas in dataset
     order; in float32 the engine with kernels against the plain one (each
     K1, K2 and K3 call against the plain version on its own input;
     AVQA_F32_TOL of the logits' largest value, beside the plain path's own
     move under a 1e-6 relative change of its inputs and the readings of two
     faults planted in front of K3, which the bound must catch); clips/s of
     `stream_answers` over 16 in-memory questions in two wire formats (uint8
     frames with int16 waves; AVQADataset's float32 items), two rounds each;
     one profiled forward (the question encoder and the grounding and fusion
     heads as their own groups) and its peak memory; `calibrate_avqa` on a
     seeded B=2 batch and an int8_towers engine (launches 34/2/48/142 a
     forward, drift against bf16) and each K4 call of a float32 int8 forward
     against its plain version. The bounds of this phase are checked once
     every reading is printed;
  13. train the AVQA model at full width in float32, TF32 off, at the
     recipe's B=2 (20 frames and 20 audio clips, Adam at 1e-4): 3 grounding
     mini-steps (stage 1, plain Adam; the frozen towers alone in eval form,
     launches 2/34/0/0 each; only the heads move, the towers bit-identical,
     bn0's state moved), the heads taken over (`transfer_stage1`), 3
     stage-2 mini-steps with a generator under StepLR, remat "full" (each
     loss finite, every trainable leaf moved, every frozen one
     bit-identical, bn0 moved, launches 2/22/0/0 each: the negative branch's
     frozen Swin-V2, and no other kernel), each mini-step's time and peak
     memory; one profiled mini-step; one with remat "none"; the eval step
     (2/34/24/0: K3 in float32 on the 24 audio adapters); and
     `avqa_main.main(["--mode", "train", "--stage", "1", ...])` then
     `--stage 2 --stage1-ckpt`, once each, on the card by default, over an
     on-disk tree with train, val and test splits: they must save
     `grounding_gen_best.npz` and `avst_best.npz` and report per-type
     accuracies in [0, 100]; and that train state loaded into a bf16
     AVQAInferenceEngine, which answers 2 questions (2/34/48/0);
  14. run the CLIP x CLAP pretrain model at full width in float32, TF32 off
     (PretrainModelConfig(): CLIP ViT-B/32 at 224 and HTS-AT paired 1:1 over
     12 blocks, 48 adapters, the CLIP text tower over 141 seeded class
     prompts; random weights from seed 0, adapter gates from seed 1): the
     CLAP text features through a seeded RoBERTa-base (`pretrain clap:`,
     timed), the zero-shot forward at B=2 (20 frames of 224, 20 clips of
     320000 samples) on the adapters as loaded (launches K1/K2/K3/K4 =
     0/12/0/0) and folded (0/12/48/0), each timed with its peak memory; each
     K2 and K3 call against its plain version on its own input (TOL); v_cls,
     a_cls and the contrastive logits with kernels against the plain
     forward within PRETRAIN_F32_TOL of each one's largest value, beside the
     plain path's move under a 1e-6 relative change of its inputs and two
     faults planted in front of K3, which the bound must catch (event_scores
     reported beside, with its argmax agreement); one profiled folded
     forward (the text tower, the ViT, HTS-AT and the adapters as groups by
     their outermost profiler range). Phase 3 also checks and times K3 at
     the ViT adapters' shape (1000 rows, C = 768, two groups) in both
     dtypes (`pretrain k3:` lines). The bounds of this phase are checked
     once every reading is printed;
  15. train the same model in float32 without remat at `pretrain_main`'s
     step (plain Adam at 1e-4): 3 mini-steps of B=2 with a generator
     (SpecAugment), each loss finite and launching nothing, every trainable
     leaf changed after them but prompt_learner.meta_net's (the forward
     never reads them), every frozen leaf bit-identical, the BN state of bn0
     and the adapters moved; each mini-step's time and the peak memory; one
     profiled mini-step; one mini-step at the recipe's B=8 (time, peak); one
     few-shot mini-step for each loss (clip classes; segment events with
     the background prompt), the gradients clipped by their global norm,
     then Adam; then `pretrain_main.main(["--mode", "train", ...])` over an
     on-disk VGGSound-AVEL tree (it must save `pretrain_best.npz`), and from
     it `zero_shot_main` in eval mode on AVE and LLP trees and
     `few_shot_main` in train mode on the AVE tree, once each, on the card
     by default: accuracies in [0, 100];
  16. extract video features into an LLP tree and serve it: 7 videos of 80
     seeded JPEG frames at 224 and 7 10-s 44.1-kHz stereo int16 wavs, the
     wavs through `preprocess.wav_to_wave_npy` (10 s at 32 kHz; with ffmpeg
     on the path, `extract_frames` on an MPEG-4 file of one video's frames),
     `feature_extract rgb` (ResNet-152 at 224, (80, 2048) a video) and
     `feature_extract clip` (R(2+1)D-18 at 112, (10, 512) a video, into
     st/), float32, TF32 off, seeded weights: frames/s end to end and of the
     backbone alone, peak memory; each backbone on the card against the CPU
     on one video's first 16 frames or 4 clips (FEATURES_TOL, beside the
     card's move under a 1e-6 nudge); then the tree through LLPDataset and a
     bf16 AVVPInferenceEngine on the census weights (B=2, chunk 2; launches
     4 x 2/34/48/0, probabilities in range);
  17. the standalone modules at full width: the AudioSet HTS-AT classifier
     (a state dict synthesized from census_htsat_audioset.json through
     `convert_htsat` and `from_jax_tree`, 527 classes) at B=2 on 10-s waves
     (launches 0/12/0/0) and 20-s waves (two sliding crops, 0/24/0/0) in bf16
     and float32, the train branch once from a generator (0/0/0/0), and in
     float32 each K2 call against its plain version and the outputs against
     the plain forward within CLASSIFIER_F32_TOL beside the nudge and the
     faults PLANTED in front of K2; PVT-v2-b5 from census_avs_pvt_v2_b5.json
     on 2 x 5 frames of 224 (maps at 56/28/14/7), timed and against the CPU
     on one image; VGGish on 10 s of 16-kHz audio (10 examples, 128-d, PCA
     codes), against the CPU; the dormant set once each at its reference
     widths (the AST, RN50 ModifiedResNet, AVENet, the five legacy AVE
     modules, the eight attention variants, PHM): shapes, finite, a time
     each; `profiling.flops_estimate` of the full-width AVE forward and a
     `profiling.trace` of one classifier forward. The bounds of phases 16
     and 17 are checked once every reading of the phase is printed;
  18. the parallel modes at full width (seeded_model's weights), each world
     of spawned processes (this one has initialized CUDA) with a timeout on
     every group and on the world, one rank a card under NCCL where the
     machine has a card for each, else every rank on card 0 under gloo:
     one process first runs the eval forward (B=2, adapters folded) in bf16
     and in float32, and the train step on a global batch of 4 with the
     draws and mixup on in float32 and in float64, and reads its own
     gradient's move under reordered clips in both dtypes; a 2-rank world
     then takes the data-parallel step (2 clips a rank, same seed) in
     float32 (loss and BN state within PAR_STAT_RTOL) and in float64 (loss,
     BN state and the gradient's relative L2 within PAR_F64_RTOL, every
     param after Adam's step within PAR_F64_STEP lr), the ranks' params
     bit-identical, no launch; then one AVS-S4 and one AVQA stage-2 step
     (finite losses), sequence-parallel eval over data 1 x seq 2 (K1/K2/K3
     = 2/34/48 a rank) and tensor-parallel eval over data 1 x model 2
     (36/0/0 a rank, each rank's tower bytes against one process's); a
     4-rank world runs tensor-parallel eval over data 1 x model 4 (34/2/48 a
     rank: Swin stage 0's 6 heads and the adapters' 2 groups stay whole on
     every rank and take K2 and K3 as in one process); a 3-rank world
     pipelines stage 2's three pairs in PIPE_MICRO
     microbatches (2/42/56 a rank); each eval, in bf16 and in float32,
     against the one-process forward of its dtype on event_scores and the
     per-frame is_event_scores (float32 within PAR_F32_TOL, bf16 within
     PAR_BF16_FACTOR times the bf16 forward's drift from float32); the same
     3-rank world then takes one backward through the pipelined eval forward
     (kernels off, seeded_model's unfolded weights, PIPE_GRAD_FRAMES segments of
     a clip in PIPE_GRAD_MICRO microbatches, a seeded weighting of event_scores and
     is_event_scores) in float64 and in float32, each rank holding the
     gradient of every tower and adapter leaf it gets against its own one-
     process gradient of the unpipelined forward (float64 within PIPE_GRAD_F64_RTOL,
     float32 within PIPE_GRAD_F32_FACTOR times one process's own float32
     move from float64), every such leaf on some rank, and the same forward
     with the kernels on raising on every rank (no kernel has a backward); then
     `ave_main --mode smoke` in an NCCL world of one rank. Every process
     group times out after 120 s (`parallel.mesh.TIMEOUT`), every world
     after PAR_JOIN_S. Times of several ranks on one card are not speeds of
     a mode. The bounds are checked once every reading is printed.
It then prints the kernels line (launches from phase 4, K4's from phase 7,
each eval mode's of phase 18 summed over its ranks as parallel_launches),
the card line and, last, the ok line.

    python3 chip_smoke.py --only adapter_bottleneck   # phases 1-3 for K3 alone
    python3 chip_smoke.py --only avs                  # phases 1, 2 and 8
    python3 chip_smoke.py --only avs_train            # phases 1, 2 and 9
    python3 chip_smoke.py --only avvp                 # phases 1, 2 and 10
    python3 chip_smoke.py --only avvp_train           # phases 1, 2 and 11
    python3 chip_smoke.py --only avqa                 # phases 1, 2, AVQA's K3 and 12
    python3 chip_smoke.py --only avqa_train           # phases 1, 2, AVQA's K3 and 13
    python3 chip_smoke.py --only pretrain             # phases 1, 2, the pretrain K3 and 14
    python3 chip_smoke.py --only pretrain_train       # phases 1, 2, the pretrain K3 and 15
    python3 chip_smoke.py --only features             # phases 1, 2 and 16
    python3 chip_smoke.py --only standalone           # phases 1, 2 and 17
    python3 chip_smoke.py --only parallel             # phases 1, 2 and 18

`--only NAME` (repeatable) checks and times only the named kernels and skips
phases 4 to 18 (`--only int8_linear` for K4); `--only avs`, `avs_train`,
`avvp`, `avvp_train`, `avqa`, `avqa_train`, `pretrain`, `pretrain_train`,
`features`, `standalone` and `parallel` run phase 8, 9, 10, 11, 12, 13, 14, 15,
16, 17 or 18 alone. Such a run prints no ok line. Phase 10's K1-K3 shapes are phase
4's (20 frames and 20 audio clips a forward; a 1 s wave is resized to the
same log-mel image), which phase 3 checks and times; phase 12's K1 and K2
shapes are phase 4's too, its K3 shapes phase 3's AVQA rows. Phase 14's K2
shapes and its audio adapters' K3 shapes are phase 4's HTS-AT ones; its 24
visual adapters' K3 shape is phase 3's pretrain row. Phase 16's K1-K3
shapes are phase 10's; phase 17's K2 calls (2 clips a tower pass) are
checked one by one in float32 where the classifier makes them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM dense; f32 without TF32; int8 the tensor cores' int8 x int8 -> int32 rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
PEAK_BYTES = 3.35e12
SPIN_HZ = 2.0e9  # cycles a second for torch.cuda._sleep: above the H100's 1.98 GHz boost
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 2e-2)}  # (atol, rtol)
MODEL_TOL = (2e-3, 2e-3)  # f32 kernel forward vs f32 plain forward (atol, rtol)
BATCH = 2
REQUESTS = 3
PER_FORWARD = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 48,
               "int8_linear": 0, "int8_quantize": 0}
SOURCES = {
    "window_attention": ("dg_sct_tpu_torch/csrc/window_attention.cu",
                         "dg_sct_tpu/ops/pallas/window_attention.py:73"),
    "block_attention": ("dg_sct_tpu_torch/csrc/block_attention.cu",
                        "dg_sct_tpu/ops/pallas/block_attention.py:113"),
    "adapter_bottleneck": ("dg_sct_tpu_torch/csrc/adapter_bottleneck.cu",
                           "dg_sct_tpu/ops/pallas/adapter_bottleneck.py:66"),
    "int8_linear": ("dg_sct_tpu_torch/csrc/int8_linear.cu",
                    "dg_sct_tpu/ops/quant.py:52 linear_int8 (an XLA int8 dot, no pallas_call)"),
    "int8_quantize": ("dg_sct_tpu_torch/csrc/int8_linear.cu",
                      "dg_sct_tpu/ops/quant.py:71 linear_int8's activation quantize (XLA "
                      "elementwise ops, no pallas_call)"),
}
INT8_NAMES = ("int8_linear", "int8_quantize")  # K4's two kernels: held exact, checked together


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, budget_ms=60.0):
    """Mean time of one call in ms, by CUDA events over a batch of calls, as
    (ms, device_ms, host_ms). ms: the calls as the host issues them, so a
    call whose host side outlasts its kernels reads as the host's time, as
    it does in serving. device_ms: the same batch queued behind a spin kernel
    that holds the stream until the host has issued it, so the events time
    the card alone. host_ms: the host's time to issue one call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(50, max(3, budget_ms / max(start.elapsed_time(end), 1e-3))))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    torch.cuda._sleep(int(min(0.5, 2.0 * host_s + 1e-3) * SPIN_HZ))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms, start.elapsed_time(end) / iters, host_ms


def bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, t_ops * 1e3, t_bytes * 1e3


def stage_ms(fn, reps=5) -> dict:
    """Device time per call of each kernel `fn` launches (torch.profiler),
    by kernel name without its arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("dgsct::(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ")
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def compare(got, ref, dtype):
    atol, rtol = TOL[dtype]
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output is not finite")
    err = (g - r).abs()
    worst = (err / (atol + rtol * r.abs())).max().item()
    return err.max().item(), worst


# ---------------------------------------------------------------------------
# phase 3: the kernels at the main path's shapes
# ---------------------------------------------------------------------------

FLOAT_ATTN = {"qkv": {"kernel": None}, "proj": {"kernel": None}}  # a block of the bf16 path


def attention_cases(cfg, frames):
    """{K1 key: calls a forward}, {K2 key: calls a forward} of the towers'
    blocks at `frames` frames and audio clips a forward; K1 also at the
    shapes it takes in the blocks where K2 runs (0 calls a forward)."""
    from dg_sct_tpu_torch.models import htsat, swinv2
    from dg_sct_tpu_torch.ops.windows import fused_block_eligible

    k1, k2 = {}, {}
    for kind, plan in (("v2", swinv2.block_plan(cfg.swin)), ("v1", htsat.block_plan(cfg.htsat))):
        for stage in plan:
            for m in stage:
                H, W = m["res"]
                N, ws = m["ws"] ** 2, m["ws"]
                nW = (H // ws) * (W // ws)
                on_k2 = fused_block_eligible(m["dim"], m["heads"], False, True, FLOAT_ATTN)
                for masked in (False, True):
                    key = (frames * nW, N, m["heads"], m["dim"] // m["heads"], nW, masked,
                           H, W, ws)
                    k1.setdefault(key, 0)
                    if not on_k2 and masked == (m["shift"] > 0):
                        k1[key] += 1
                if on_k2:
                    key = (kind, frames, H, W, m["dim"], m["heads"], ws, m["shift"])
                    k2[key] = k2.get(key, 0) + 1
    return k1, k2


def kernel_cases(cfg):
    """(kernel, case, launches per forward): every main-path shape, with the
    number of calls one forward makes at it."""
    from dg_sct_tpu_torch.configs import ave_adapter_dims

    frames = BATCH * cfg.num_frames
    k1, k2 = attention_cases(cfg, frames)
    k3 = {}
    for (v_dim, v_tok, a_dim, a_tok) in ave_adapter_dims(cfg.swin, cfg.htsat):
        for C, N in ((v_dim, v_tok), (a_dim, a_tok)):
            key = (frames * N, C, 2, C // 16, True)  # (rows, C, groups, go, has_ln1)
            k3[key] = k3.get(key, 0) + 2
    k4 = sorted(int8_call_shapes(cfg).items())
    return ([("window_attention", k, n) for k, n in k1.items()]
            + [("block_attention", k, n) for k, n in k2.items()]
            + [("adapter_bottleneck", k, n) for k, n in k3.items()]
            + [(name, k, n) for k, n in k4 for name in INT8_NAMES])


def avqa_k3_cases():
    """{K3 key: calls a forward} of the AVQA model's 48 adapters (B=2 clips:
    BATCH * 10 frames and audio clips): four channel groups, so C/g = 24 to
    384 and go = C/32; checked and timed in phase 3 beside the AVE shapes."""
    from dg_sct_tpu_torch.configs import AVQAModelConfig, ave_adapter_dims

    cfg = AVQAModelConfig()
    frames, g = BATCH * cfg.num_frames, cfg.adapter.num_conv_group
    r = cfg.adapter.reduction_factor
    k3 = {}
    for (v_dim, v_tok, a_dim, a_tok) in ave_adapter_dims(cfg.swin, cfg.htsat):
        for C, N in ((v_dim, v_tok), (a_dim, a_tok)):
            key = (frames * N, C, g, C // r // g, True)
            k3[key] = k3.get(key, 0) + 2
    return k3


def pretrain_k3_case():
    """(K3 key, calls a pretrain forward) of the pretrain model's 24 visual
    adapters, folded (B=2 clips: BATCH * 10 frames of 50 ViT tokens at C =
    768, two groups); its 24 audio adapters take phase 4's HTS-AT shapes."""
    from dg_sct_tpu_torch.configs import PretrainModelConfig

    cfg = PretrainModelConfig()
    C, g = cfg.clip.vision_width, cfg.adapter.num_conv_group
    tokens = (cfg.clip.image_size // cfg.clip.vision_patch) ** 2 + 1
    return (BATCH * cfg.num_frames * tokens, C, g, C // cfg.adapter.reduction_factor // g,
            True), 2 * cfg.clip.vision_layers


def avs_attention_cases():
    """(kernel, case, launches per AVS forward) of K1 and K2 at the shapes
    of phase 8's forward (B=2 AVS clips: BATCH * 5 frames); checked in phase
    3, not timed. K1's cases hold the shapes that int8 towers move onto it."""
    from dg_sct_tpu_torch.configs import AVSModelConfig

    cfg = AVSModelConfig()
    k1, k2 = attention_cases(cfg, BATCH * cfg.num_frames)
    return ([("window_attention", k, n) for k, n in k1.items()]
            + [("block_attention", k, n) for k, n in k2.items()])


INT8_TOWERS = ("swin", "htsat", "adapters")  # int8 serving's headline configuration


def int8_call_shapes(cfg, towers=INT8_TOWERS):
    """{(rows, K, N): calls} of the quantized linears one forward of BATCH
    clips makes, from a plain forward on the "meta" device (shapes only)
    whose eligible linears are tagged to record their inputs' shapes."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.ops import quant

    class Shapes(quant.Recorder):
        def record(self, qid, x):
            self.calls.append((qid, tuple(x.shape)))

    params, state = ave.init_ave_model(cfg, device="meta")
    shapes = Shapes()
    tagged = dict(params)
    tagged.update(quant.attach_qtags(quant._ordered_towers(params, towers), recorder=shapes))
    out_dims = quant.qid_shape_map(quant._ordered_towers(params, towers))
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    with torch.inference_mode():
        ave.forward(tagged, state, torch.empty(BATCH, T, L, device="meta"),
                    torch.empty(BATCH, T, S, S, 3, device="meta"), cfg, kernels=False,
                    device="meta")
    out = {}
    for qid, shape in shapes.calls:
        key = (math.prod(shape[:-1]), shape[-1], out_dims[qid][1])
        out[key] = out.get(key, 0) + 1
    return out


def composed_half_block(x, wqkv, bqkv, wproj, bproj, full_bias, ln_s, ln_b, logit_scale, *,
                        kind, heads, ws):
    """K2's function as library calls in x's type: addmm for qkv, SDPA with
    bias and mask as one additive (Bw, heads, N, N) mask, addmm for proj,
    layer_norm, the residual. A yardstick only; the port never calls it."""
    F = torch.nn.functional
    B, Hs, Ws, C = x.shape
    D, N, T = C // heads, ws * ws, B * Hs * Ws
    h = F.layer_norm(x, (C,), ln_s, ln_b, eps=1e-5) if kind == "v1" else x
    qkv = torch.addmm(bqkv, h.reshape(T, C), wqkv)
    qkv = qkv.view(B, Hs // ws, ws, Ws // ws, ws, 3, heads, D).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = qkv.reshape(3, -1, heads, N, D).unbind(0)
    scale = D ** -0.5
    if kind == "v2":
        ls = torch.exp(torch.clamp(logit_scale.float(), max=math.log(100.0))).to(x.dtype)
        q = F.normalize(q, dim=-1) * ls.view(1, heads, 1, 1)
        k, scale = F.normalize(k, dim=-1), 1.0
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=full_bias, scale=scale)
    o = o.view(B, Hs // ws, Ws // ws, heads, ws, ws, D).permute(0, 1, 4, 2, 5, 3, 6).reshape(T, C)
    y = torch.addmm(bproj, o, wproj)
    if kind == "v2":
        y = F.layer_norm(y, (C,), ln_s, ln_b, eps=1e-5)
    return x + y.view(B, Hs, Ws, C)


# K3 off the main path, (rows, C, groups, go, has_ln1): ragged last row tiles
# (one clip: 360 rows at C = 1536), no LN_before, and four groups at C/g = 24
# or 48 off the AVQA forward's row counts (`check_avqa_k3` takes those)
K3_EXTRA = ((360, 1536, 2, 96, True), (360, 1536, 2, 96, False), (40, 768, 2, 48, True),
            (2880, 768, 2, 48, False), (100, 96, 4, 3, True), (77, 192, 4, 6, False))


def composed_bottleneck(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, *, has_ln1):
    """K3's function as library calls in x's type: layer_norm, grouped baddbmm
    for down plus bias, relu, grouped baddbmm for up plus bias, layer_norm. A
    yardstick only; the port never calls it."""
    F = torch.nn.functional
    rows, C = x.shape
    g, gi, go = wd.shape
    z = F.layer_norm(x, (C,), ln1s, ln1b, eps=1e-5) if has_ln1 else x
    z = z.to(x.dtype).view(rows, g, gi).transpose(0, 1)
    h = torch.relu(torch.baddbmm(bd.view(g, 1, go), z, wd)).to(x.dtype)
    o = torch.baddbmm(bu.view(g, 1, gi), h, wu)
    return F.layer_norm(o.transpose(0, 1).reshape(rows, C), (C,), ln2s, ln2b, eps=1e-5)


def k3_inputs(key, dtype, gen):
    """K3's operands at (rows, C, groups, go, has_ln1) on the card: x, wd, bd,
    wu, bu, ln1s, ln1b, ln2s, ln2b in `dtype`."""
    rows, C, g, go, _ = key
    rnd = lambda *s, scale=1.0: (torch.randn(s, device="cuda", generator=gen) * scale).to(dtype)
    x = rnd(rows, C)
    wd, wu = rnd(g, C // g, go, scale=(C // g) ** -0.5), rnd(g, go, C // g, scale=go ** -0.5)
    bd, bu = rnd(g * go, scale=0.1), rnd(C, scale=0.1)
    ln = [(1.0 + rnd(C, scale=0.1).float()).to(dtype), rnd(C, scale=0.1)] * 2
    return (x, wd, bd, wu, bu, *ln)


def int8_inputs(key, dtype, gen):
    """K4's operands at (rows, K, N) on the card: x, the quantized weight (the
    layout `quantize_linear` makes), kscale, a static scale under which a few
    values of x clip, and a bias in x's type."""
    from dg_sct_tpu_torch.ops.quant import quantize_linear

    rows, K, N = key
    x = torch.randn(rows, K, device="cuda", generator=gen).to(dtype)
    q = quantize_linear({"kernel": torch.randn(K, N, device="cuda", generator=gen) * K ** -0.5})
    ascale = x.float().abs().amax() * (0.9 / 127.0)
    bias = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dtype)
    return x, q["kernel_q"], q["kscale"], ascale, bias


def exact_err(got, ref, what):
    """Max |got - ref| over a tensor or a tuple of them; raises unless it is 0
    (K4's kernels repeat their plain versions' arithmetic exactly)."""
    pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
    err = max(torch.nan_to_num((g.double() - r.double()).abs(), nan=math.inf).max().item()
              for g, r in pairs)
    if err != 0:
        raise AssertionError(f"{what}: max abs error {err:.3e}, expected 0")
    return err


def composed_int8_linear(x, wq, kscale, ascale, bias):
    """K4's function as library calls: the quantize in PyTorch, `torch._int_mm`
    (int8 x int8 -> int32), the dequantize and bias in PyTorch. A yardstick
    only; the port never calls it."""
    xq = torch.clamp(torch.round(x.float() / ascale), -127, 127).to(torch.int8)
    return (torch._int_mm(xq, wq).float() * (ascale * kscale) + bias.float()).to(x.dtype)


def check_int8_dynamic(key, dtype, gen):
    """K4 with dynamic per-row scales, its quantize kernel with static and
    dynamic scales, and its GEMM kernel alone on the plain quantize's
    output, each against its plain version: max abs error, which must be 0."""
    from dg_sct_tpu_torch.ops.kernels import int8_linear as K4

    x, wq, kscale, ascale, bias = int8_inputs(key, dtype, gen)
    what = f"int8_linear dynamic {key} {dtype}"
    err = exact_err(K4.int8_linear(x, wq, kscale, None, bias),
                    K4.linear_int8_plain(x, wq, kscale, None, bias), what)
    for a in (None, ascale):
        mode = "dynamic" if a is None else "static"
        parts = K4.quantize_rows_plain(x, a)
        err = max(err, exact_err(K4.quantize_rows(x, a), parts, f"int8_quantize {mode} {key}"),
                  exact_err(K4.int8_gemm(*parts, wq, kscale, bias, dtype),
                            K4.int8_gemm_plain(*parts, wq, kscale, bias, dtype),
                            f"int8_gemm alone {mode} {key} {dtype}"))
    return err


def window_bias(bias, mask, Bw):
    """bias (H, N, N) plus mask (nW, N, N) or None as one (Bw, H, N, N) tensor."""
    H, N, _ = bias.shape
    full = bias[None].expand(Bw, H, N, N)
    if mask is not None:
        nW = mask.shape[0]
        full = (full.reshape(Bw // nW, nW, H, N, N) + mask[None, :, None]).reshape(Bw, H, N, N)
    return full.contiguous()


def run_case(name, key, dtype, gen, grad=False):
    """Inputs from `gen` on the card -> (kernel fn, plain fn, library fn or
    None, composed fn or None, flops, bytes). `grad`: the first operand
    requires grad."""
    from dg_sct_tpu_torch.ops.kernels import adapter_bottleneck as K3
    from dg_sct_tpu_torch.ops.kernels import block_attention as K2
    from dg_sct_tpu_torch.ops.kernels import int8_linear as K4
    from dg_sct_tpu_torch.ops.kernels import window_attention as K1
    from dg_sct_tpu_torch.ops.windows import shift_attn_mask

    dev = "cuda"
    rnd = lambda *s, scale=1.0: (torch.randn(s, device=dev, generator=gen) * scale).to(dtype)
    it = torch.tensor([], dtype=dtype).element_size()
    if name == "window_attention":
        Bw, N, H, D, nW, masked, Hs, Ws, ws = key
        q, k, v = rnd(Bw, N, H, D, scale=0.3), rnd(Bw, N, H, D, scale=0.3), rnd(Bw, N, H, D)
        q.requires_grad_(grad)
        bias = rnd(H, N, N, scale=0.5)
        mask = None
        if masked:
            mask = torch.as_tensor(shift_attn_mask(Hs, Ws, ws, ws // 2), device=dev).to(dtype)
        full = window_bias(bias, mask, Bw)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=full,
                                                                       scale=1.0)
        flops = 4 * Bw * H * N * N * D
        nbytes = it * (4 * Bw * N * H * D + H * N * N + (nW * N * N if masked else 0))
        return (lambda: K1.window_attention(q, k, v, bias, mask, nW=nW),
                lambda: K1.window_attention_plain(q, k, v, bias, mask, nW=nW), lib, None,
                flops, nbytes)
    if name == "block_attention":
        kind, B, Hs, Ws, C, heads, ws, shift = key
        N = ws * ws
        x = rnd(B, Hs, Ws, C).requires_grad_(grad)
        wqkv, wproj = rnd(C, 3 * C, scale=C ** -0.5), rnd(C, C, scale=C ** -0.5)
        bqkv, bproj = rnd(3 * C, scale=0.1), rnd(C, scale=0.1)
        if kind == "v2":
            bias = (16.0 * torch.sigmoid(torch.randn(heads, N, N, device=dev, generator=gen))).to(dtype)
            logit_scale = (math.log(10.0) + rnd(heads, scale=0.3).float()).to(dtype)
        else:
            bias, logit_scale = rnd(heads, N, N, scale=0.02), None
        ln_s, ln_b = (1.0 + rnd(C, scale=0.1).float()).to(dtype), rnd(C, scale=0.1)
        mask = None
        if shift:
            mask = torch.as_tensor(shift_attn_mask(Hs, Ws, ws, shift), device=dev).to(dtype)
        args = (x, wqkv, bqkv, wproj, bproj, bias, ln_s, ln_b, mask, logit_scale)
        kw = dict(kind=kind, heads=heads, ws=ws)
        T = B * Hs * Ws
        Bw = T // N
        full = window_bias(bias, mask, Bw)
        composed = lambda: composed_half_block(x, wqkv, bqkv, wproj, bproj, full, ln_s, ln_b,
                                               logit_scale, **kw)
        flops = 2 * T * C * 4 * C + 4 * Bw * heads * N * N * (C // heads)
        nbytes = it * (2 * T * C + 4 * C * C + 6 * C + heads * N * N
                       + (mask.numel() if shift else 0) + heads)
        return (lambda: K2.fused_attn_half_block(*args, **kw),
                lambda: K2.fused_attn_half_block_plain(*args, **kw), None, composed,
                flops, nbytes)
    if name == "int8_linear":
        rows, K, N = key
        args = int8_inputs(key, dtype, gen)
        nbytes = it * rows * K + K * N + 4 * N + 4 + it * N + it * rows * N
        return (lambda: K4.int8_linear(*args), lambda: K4.linear_int8_plain(*args), None,
                lambda: composed_int8_linear(*args), 2 * rows * K * N, nbytes)
    if name == "int8_quantize":  # x in, int8 rows and (s, 1/s) a row out; a product and a round
        rows, K, _ = key
        x, _, _, ascale, _ = int8_inputs(key, dtype, gen)
        return (lambda: K4.quantize_rows(x, ascale), lambda: K4.quantize_rows_plain(x, ascale),
                None, None, 2 * rows * K, it * rows * K + 4 + rows * K + 8 * rows)
    rows, C, g, go, has_ln1 = key
    args = k3_inputs(key, dtype, gen)
    args[0].requires_grad_(grad)
    flops = 4 * rows * C * go
    nbytes = it * (2 * rows * C + 2 * C * go + g * go + (5 if has_ln1 else 3) * C)
    return (lambda: K3.bottleneck_rows(*args, has_ln1=has_ln1),
            lambda: K3.bottleneck_rows_plain(*args, has_ln1=has_ln1), None,
            lambda: composed_bottleneck(*args, has_ln1=has_ln1), flops, nbytes)


def poison_shared_memory():
    """Leave NaN in the shared memory of every SM: K4's GEMM under a NaN
    scale stages float32 output tiles of NaN through its first 68 KB (each
    row of 128 values 136 apart), two blocks on each of the 132 SMs. The
    float32 checks of K1 and K2 run right after it, so a read of shared
    memory that their copies never wrote shows as NaN."""
    from dg_sct_tpu_torch.ops.kernels import int8_linear as K4
    from dg_sct_tpu_torch.ops.quant import quantize_linear

    q = quantize_linear({"kernel": torch.ones(256, 128, device="cuda")})
    K4.int8_linear(torch.ones((128 * 2 * 132, 256), device="cuda"), q["kernel_q"],
                   q["kscale"], torch.full((), math.nan, device="cuda"))


def check_case(name, key, dtype, gen):
    """Kernel and plain version on the same inputs, held at TOL; returns the
    case's functions and its max abs error."""
    kern, plain, lib, composed, flops, nbytes = run_case(name, key, dtype, gen)
    if dtype == torch.float32 and name in ("window_attention", "block_attention"):
        poison_shared_memory()
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if name in INT8_NAMES:
        return (kern, plain, lib, composed, flops, nbytes, ref,
                exact_err(got, ref, f"{name} {key} {dtype}"))
    err, worst = compare(got, ref, dtype)
    if worst > 1.0:
        raise AssertionError(f"{name} {key} {dtype}: max error {err:.3e} exceeds "
                             f"atol/rtol {TOL[dtype]}")
    return kern, plain, lib, composed, flops, nbytes, ref, err


def check_refuses_grad(name, key):
    """K1-K3's wrapper on the card, under grad mode with its first operand
    requiring grad: it must raise before it launches (`build.refuse_grad`;
    no kernel has a backward). Its own generator: the checks' inputs stay
    as they were."""
    from dg_sct_tpu_torch.ops.kernels import launch_counts

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    kern = run_case(name, key, torch.float32, gen, grad=True)[0]
    before = launch_counts()
    try:
        with torch.enable_grad():
            kern()
        raised = False
    except RuntimeError as e:
        raised = "no backward" in str(e)
    launched = launch_counts() != before
    print(f"check {name} {list(key)} float32 asked for a gradient: raised {raised}, "
          f"launched {launched}", flush=True)
    if not raised or launched:
        raise AssertionError(f"{name}: the wrapper did not refuse a gradient on the card")


def check_kernels(cfg, only=None):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    peak_type = {"int8_linear": torch.int8, "int8_quantize": torch.float32}  # else x's type
    refusal = {"window_attention", "block_attention", "adapter_bottleneck"}  # K1-K3
    for name, key, per_fwd in kernel_cases(cfg):
        if only and name not in only and not (name in INT8_NAMES and set(INT8_NAMES) & set(only)):
            continue
        if name in refusal:
            refusal.discard(name)
            check_refuses_grad(name, key)
        for dtype in (torch.float32, torch.bfloat16):
            kern, plain, lib, composed, flops, nbytes, ref, err = check_case(name, key, dtype, gen)
            b_ms, ops_ms, bytes_ms = bound(flops, nbytes, peak_type.get(name, dtype))
            k_ms, k_dev, k_host = time_ms(kern)
            l_ms, l_dev, _ = time_ms(lib) if lib else (None, None, None)
            c_ms, c_dev, _ = time_ms(composed) if composed else (None, None, None)
            row = dict(name=name, case=list(key), dtype=str(dtype).replace("torch.", ""),
                       per_forward=per_fwd, max_abs_err=err, kernel_ms=k_ms,
                       kernel_device_ms=k_dev, kernel_host_ms=k_host, plain_ms=time_ms(plain)[0],
                       library_ms=l_ms, library_device_ms=l_dev, composed_ms=c_ms,
                       composed_device_ms=c_dev, bound_ms=b_ms, ops_ms=ops_ms, bytes_ms=bytes_ms)
            if composed:  # the yardstick computes the same function (not a check)
                row["composed_err"] = (composed().float() - ref.float()).abs().max().item()
            if name == "block_attention" and dtype == torch.bfloat16:
                row["stages_ms"] = stage_ms(kern)  # where K2's time goes, kernel by kernel
            if name == "int8_linear":
                row["dynamic_err"] = check_int8_dynamic(key, dtype, gen)
                if dtype == torch.bfloat16:  # yardstick: the bf16 matmul + bias int8 replaces
                    m, k, n = key
                    xb = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
                    wb = torch.randn(k, n, device="cuda", generator=gen).to(dtype)
                    bb = torch.zeros(n, device="cuda", dtype=dtype)
                    row["matmul_ms"], row["matmul_device_ms"], _ = time_ms(
                        lambda: torch.addmm(bb, xb, wb))
            rows.append(row)
            print("kernel", json.dumps(row), flush=True)
    print_k4(rows)
    if any(r["name"] == "adapter_bottleneck" for r in rows):
        print_k3_f32(rows)
    if not only or "adapter_bottleneck" in only or "avqa" in only:
        rows += check_avqa_k3(gen)
    if not only or {"adapter_bottleneck", "pretrain", "pretrain_train"} & set(only):
        rows += check_pretrain_k3(gen)
    # checks only, not timed: K3 off the main path, K1 and K2 at phase 8's shapes
    extra = [("adapter_bottleneck", key, "off the main path") for key in K3_EXTRA]
    extra += [(name, key, f"AVS path, {n} a forward") for name, key, n in avs_attention_cases()]
    for name, key, what in extra:
        if only and name not in only and not ("avs" in only and what.startswith("AVS")):
            continue
        for dtype in (torch.float32, torch.bfloat16):
            err = check_case(name, key, dtype, gen)[-1]
            rows.append(dict(name=name, case=list(key), dtype=str(dtype).replace("torch.", ""),
                             per_forward=0, max_abs_err=err, checked_only=True))
            print(f"check {name} {list(key)} {dtype} ({what}): max abs err {err:.3e} "
                  f"(atol/rtol {TOL[dtype]})", flush=True)
    return rows


def print_k4(rows):
    """`k4:` one line a shape and dtype (the whole K4 call: its device and
    host-issued ms, the host's ms to issue it, its quantize pass's device
    ms, the bound, the bf16 addmm it replaces), then `k4 sums:` each over
    one B=2 forward's calls."""
    quant = {(tuple(r["case"]), r["dtype"]): r for r in rows if r["name"] == "int8_quantize"}
    k4 = [r for r in rows if r["name"] == "int8_linear"]
    for r in k4:
        q = quant[(tuple(r["case"]), r["dtype"])]
        print(f"k4: {tuple(r['case'])} {r['dtype']} x{r['per_forward']}: device_ms "
              f"{r['kernel_device_ms']:.4f}, ms {r['kernel_ms']:.4f}, kernel_host_ms "
              f"{r['kernel_host_ms']:.4f}, quantize device_ms {q['kernel_device_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({'operations' if r['ops_ms'] >= r['bytes_ms'] else 'bytes'})"
              + (f", bf16 addmm device_ms {r['matmul_device_ms']:.4f}" if "matmul_ms" in r else ""),
              flush=True)
    for dtype in ("float32", "bfloat16"):
        mine = [r for r in k4 if r["dtype"] == dtype]
        if not mine:
            continue
        tot = lambda k, rs=mine: sum(r["per_forward"] * r[k] for r in rs)
        qs = [quant[(tuple(r["case"]), dtype)] for r in mine]
        print(f"k4 sums: {dtype}, one B={BATCH} forward's {sum(r['per_forward'] for r in mine)} "
              f"calls at {len(mine)} shapes: device {tot('kernel_device_ms'):.4f} ms, issued "
              f"{tot('kernel_ms'):.4f} ms, host {tot('kernel_host_ms'):.4f} ms; the quantize "
              f"pass {tot('kernel_device_ms', qs):.4f} ms on the card; bound "
              f"{tot('bound_ms'):.4f} ms; plain {tot('plain_ms'):.4f} ms; composed "
              f"{tot('composed_device_ms'):.4f} ms on the card"
              + (f"; bf16 addmm {tot('matmul_ms'):.4f} / {tot('matmul_device_ms'):.4f} ms"
                 if dtype == "bfloat16" else "")
              + f"; max abs err {max(max(r['max_abs_err'], r['dynamic_err']) for r in mine)}",
              flush=True)


def tf32_round(t):
    """float32 values rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    return ((t.float().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def k3_planted_tf32(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, *, has_ln1):
    """A planted fault: K3's plain float32 version with both products' operands
    rounded to TF32 (one TF32 product, as TF32 alone would give), to read
    beside the kernel whether TOL tells 3xTF32 from it. Not in the port."""
    from dg_sct_tpu_torch.ops.basic import layer_norm

    rows, C = x.shape
    g, gi, go = wd.shape
    z = layer_norm({"scale": ln1s, "bias": ln1b}, x) if has_ln1 else x
    h = torch.relu(torch.einsum("rgi,gio->rgo", tf32_round(z).reshape(rows, g, gi), tf32_round(wd))
                   + bd.reshape(g, go))
    o = torch.einsum("rgo,goi->rgi", tf32_round(h), tf32_round(wu)) + bu.reshape(g, gi)
    return layer_norm({"scale": ln2s, "bias": ln2b}, o.reshape(rows, C))


def print_k3_f32(rows):
    """`k3 f32:` one line a float32 main-path shape: the kernel and the planted
    1xTF32 fault against the plain version on the same inputs (their own
    generator), as max abs error and worst error over TOL; then `k3 f32
    sums:` over one B=2 forward's calls: device and issued ms, the composed
    calls, the bound, the worst error over TOL of each."""
    from dg_sct_tpu_torch.ops.kernels import adapter_bottleneck as K3

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    mine = [r for r in rows if r["name"] == "adapter_bottleneck" and r["dtype"] == "float32"
            and r["per_forward"]]
    worst = {"kernel": 0.0, "planted": 0.0}
    for r in mine:
        key = tuple(r["case"])
        args = k3_inputs(key, torch.float32, gen)
        ref = K3.bottleneck_rows_plain(*args, has_ln1=key[-1])
        got = {"kernel": K3.bottleneck_rows(*args, has_ln1=key[-1]),
               "planted": k3_planted_tf32(*args, has_ln1=key[-1])}
        read = {k: compare(v, ref, torch.float32) for k, v in got.items()}
        for k, (_, w) in read.items():
            worst[k] = max(worst[k], w)
        print(f"k3 f32: {key} x{r['per_forward']}: device_ms {r['kernel_device_ms']:.4f}, ms "
              f"{r['kernel_ms']:.4f}, composed device_ms {r['composed_device_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f}; max abs err, error over TOL: kernel "
              f"{read['kernel'][0]:.3e}, {read['kernel'][1]:.3f}; planted 1xTF32 "
              f"{read['planted'][0]:.3e}, {read['planted'][1]:.3f}", flush=True)
    tot = lambda k: sum(r["per_forward"] * r[k] for r in mine)
    print(f"k3 f32 sums: one B={BATCH} forward's {sum(r['per_forward'] for r in mine)} calls at "
          f"{len(mine)} shapes: device {tot('kernel_device_ms'):.4f} ms, issued "
          f"{tot('kernel_ms'):.4f} ms; composed {tot('composed_device_ms'):.4f} / "
          f"{tot('composed_ms'):.4f} ms (device / issued); bound {tot('bound_ms'):.4f} ms; worst "
          f"error over TOL {TOL[torch.float32]}: kernel {worst['kernel']:.3f}, planted 1xTF32 "
          f"{worst['planted']:.3f}", flush=True)
    if worst["kernel"] > 1.0:
        raise AssertionError(f"K3 float32: error {worst['kernel']:.3f} x TOL")


def check_avqa_k3(gen):
    """K3 at each of the AVQA forward's shapes (four groups), both dtypes:
    checked against its plain version and timed beside the composed library
    calls and the bound; then one forward's sum of each (`avqa k3:`)."""
    rows = []
    for key, n in sorted(avqa_k3_cases().items()):
        for dtype in (torch.float32, torch.bfloat16):
            kern, _, _, composed, flops, nbytes, ref, err = check_case("adapter_bottleneck", key,
                                                                       dtype, gen)
            b_ms, ops_ms, bytes_ms = bound(flops, nbytes, dtype)
            k_ms, k_dev, k_host = time_ms(kern)
            c_ms, c_dev, _ = time_ms(composed)
            row = dict(name="adapter_bottleneck", case=list(key),
                       dtype=str(dtype).replace("torch.", ""), per_forward=0, avqa_per_forward=n,
                       checked_only=True, max_abs_err=err, kernel_ms=k_ms, kernel_device_ms=k_dev,
                       kernel_host_ms=k_host, composed_ms=c_ms, composed_device_ms=c_dev,
                       bound_ms=b_ms, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       composed_err=(composed().float() - ref.float()).abs().max().item())
            rows.append(row)
            print("kernel avqa", json.dumps(row), flush=True)
    for dtype in ("float32", "bfloat16"):
        mine = [r for r in rows if r["dtype"] == dtype]
        tot = lambda k: sum(r["avqa_per_forward"] * r[k] for r in mine)
        print(f"avqa k3: {dtype}, one AVQA forward's {sum(r['avqa_per_forward'] for r in mine)} "
              f"calls (four groups, C/g 24 to 384): kernel {tot('kernel_ms'):.4f} ms as issued, "
              f"{tot('kernel_device_ms'):.4f} ms on the card; composed library calls "
              f"{tot('composed_ms'):.4f} / {tot('composed_device_ms'):.4f} ms; bound "
              f"{tot('bound_ms'):.4f} ms; max abs err {max(r['max_abs_err'] for r in mine):.3e}; "
              f"shapes where the kernel loses to composed on the card: "
              f"{[r['case'][:2] for r in mine if r['kernel_device_ms'] > r['composed_device_ms']]}",
              flush=True)
    return rows


def check_pretrain_k3(gen):
    """K3 at the pretrain model's visual adapter shape, both dtypes: checked
    against its plain version and timed beside the composed library calls
    and the bound (`pretrain k3:`)."""
    key, n = pretrain_k3_case()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        kern, _, _, composed, flops, nbytes, ref, err = check_case("adapter_bottleneck", key,
                                                                   dtype, gen)
        b_ms, ops_ms, bytes_ms = bound(flops, nbytes, dtype)
        k_ms, k_dev, k_host = time_ms(kern)
        c_ms, c_dev, _ = time_ms(composed)
        row = dict(name="adapter_bottleneck", case=list(key),
                   dtype=str(dtype).replace("torch.", ""), per_forward=0, pretrain_per_forward=n,
                   checked_only=True, max_abs_err=err, kernel_ms=k_ms, kernel_device_ms=k_dev,
                   kernel_host_ms=k_host, composed_ms=c_ms, composed_device_ms=c_dev,
                   bound_ms=b_ms, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   composed_err=(composed().float() - ref.float()).abs().max().item())
        rows.append(row)
        print("kernel pretrain", json.dumps(row), flush=True)
        print(f"pretrain k3: {row['dtype']}, rows {key[0]}, C {key[1]}, {key[2]} groups, go "
              f"{key[3]} (the ViT's 50 tokens a frame), {n} calls a folded forward: kernel "
              f"{n * k_ms:.4f} ms as issued, {n * k_dev:.4f} ms on the card; composed library "
              f"calls {n * c_ms:.4f} / {n * c_dev:.4f} ms; bound {n * b_ms:.4f} ms "
              f"({row['bound_by']}); max abs err {err:.3e} (atol/rtol {TOL[dtype]})", flush=True)
    return rows


def kernels_line(rows, counts, parallel=None):
    """One entry per kernel: the bfloat16 times summed over one forward's
    calls (the main path serves bf16), errors over every case and dtype;
    with `parallel` (phase 18), each eval mode's launches summed over its
    ranks as `parallel_launches`."""
    out = []
    for name, (source, replaces) in SOURCES.items():
        checked = [r for r in rows if r["name"] == name]  # errors over every check
        main = [r for r in checked if r["dtype"] == "bfloat16" and r["per_forward"]
                and not r.get("checked_only")]
        if not main:  # no main-path case checked in this run (--only)
            continue
        tot = lambda k: sum(r["per_forward"] * r[k] for r in main)
        known = lambda k: tot(k) if None not in [r[k] for r in main] else None
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name],
            max_abs_err=max(max(r["max_abs_err"], r.get("dynamic_err", 0.0)) for r in checked),
            ms=tot("kernel_ms"), device_ms=tot("kernel_device_ms"), plain_ms=tot("plain_ms"),
            bound_ms=tot("bound_ms"),
            bound_by="operations" if tot("ops_ms") >= tot("bytes_ms") else "bytes",
            library_ms=known("library_ms"), library_device_ms=known("library_device_ms"),
            composed_ms=known("composed_ms"), composed_device_ms=known("composed_device_ms")))
        if name == "int8_linear":
            out[-1].update(matmul_ms=known("matmul_ms"), matmul_device_ms=known("matmul_device_ms"))
        if parallel:
            out[-1]["parallel_launches"] = {mode: n[name] for mode, n in parallel.items()}
    return {"kernels": out}


# ---------------------------------------------------------------------------
# phase 4: the full-width AVE eval forward through the engine
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (("K1", ("window_attention_kernel",)),
                 ("K2", ("block_attn_",)),
                 ("K3", ("bottleneck_kernel",)),
                 ("K4", ("int8_linear", "int8_quantize")),
                 ("library GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("memcpy", ("memcpy", "memset")))


RANGES = set()  # the labels of `annotate`'s profiler ranges


def kernel_group(name: str) -> str:
    """The first group of KERNEL_GROUPS whose key is in the kernel's name."""
    low = name.lower()
    return next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")


def profile_forward(eng, wave, frames):
    """One engine forward under torch.profiler: device time by kernel group,
    the busiest kernels, and the share of the forward's span the card idles."""
    profile_run(lambda: eng.forward_batch(wave, frames), f"one forward of {BATCH} clips",
                "profile")


def profile_run(fn, what, tag, host_ops=True, op_group=None, record_shapes=False):
    """`fn()` under torch.profiler; prints `tag:` lines: device busy time and
    the idle share of the span from the first kernel's start to the last
    one's end, time by kernel group, the busiest kernels. `host_ops=False`
    records device activity only (a train step's host ops number ~10^5).
    `op_group(host op)` -> a group name or None moves the kernels a host op
    launched from their name's group to that one (by the op's own kernel
    list, so each kernel moves once; only `aten::` operators count), and
    splits "other" by the host op (and its parent) that launched each
    kernel; with host ops, each of the busiest kernels is printed beside
    the host op (and its parent) that launched most of its time.
    `record_shapes` gives op_group the host ops' input shapes. Returns
    {group: ms}."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        fn()
        torch.cuda.synchronize()
    # a profiler range (`annotate`) also shows on the device's timeline as one
    # span over its kernels: not device work
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and e.name not in RANGES]
    if not dev:
        print(f"{tag}: the profiler recorded no device time", flush=True)
        return {}
    by_group, by_name = {}, {}
    for e in dev:
        us = e.time_range.elapsed_us()
        group = kernel_group(e.name)
        by_group[group] = by_group.get(group, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    moved, other_ops, launcher = {}, {}, {}
    for e in prof.events() if host_ops else ():
        # operators only: the profiler's own "Buffer Flush" and "Activity Buffer
        # Request" events can carry kernels of colliding correlation ids
        if (not e.kernels or e.device_type != torch.autograd.DeviceType.CPU
                or not e.name.startswith("aten::")):
            continue
        group = op_group(e) if op_group else None
        key = " < ".join(op.name for op in (e, e.cpu_parent) if op is not None)
        for k in e.kernels:
            ops = launcher.setdefault(k.name, {})
            ops[key] = ops.get(key, 0.0) + k.duration
            if group:
                by_group[kernel_group(k.name)] = by_group.get(kernel_group(k.name), 0.0) - k.duration
                by_group[group] = by_group.get(group, 0.0) + k.duration
                moved[group] = moved.get(group, 0) + 1
            elif op_group and kernel_group(k.name) == "other":  # "other" by the host op
                us, n = other_ops.get(key, (0.0, 0))
                other_ops[key] = (us + k.duration, n + 1)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for s, t in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, t
        else:
            hi = max(hi, t)
    busy += hi - lo
    span = max(t for _, t in spans) - spans[0][0]
    groups = ", ".join(f"{g} {us / 1e3:.3f} ms" for g, us in
                       sorted(by_group.items(), key=lambda kv: -kv[1]))
    print(f"{tag}: {what}: device busy {busy / 1e3:.3f} ms of a "
          f"{span / 1e3:.3f} ms span ({100.0 * (1.0 - busy / span):.1f}% idle), "
          f"{len(dev)} device events; by group: {groups}"
          + "".join(f"; {n} kernels moved to {g}" for g, n in moved.items()), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:10] + [kv for kv in top[10:] if kernel_group(kv[0])[0] == "K"]:
        short = name.replace("dgsct::(anonymous namespace)::", "")
        ops = launcher.get(name)
        by = f"  [{max(ops, key=ops.get)}]" if ops else ""
        print(f"{tag}:   {us / 1e3:9.3f} ms  {kernel_group(name):5s} {short[:110]}{by}", flush=True)
    for key, (us, n) in sorted(other_ops.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"{tag}:   other by host op: {us / 1e3:9.3f} ms in {n} kernels  {key}", flush=True)
    return {g: us / 1e3 for g, us in by_group.items()}


def seeded_model(cfg, device="cuda"):
    """Float32 (params, state) from seed 0 with seeded nonzero adapter gates
    (zero at init, the adapters would not count), as phases 4, 6 and 7 use."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.models.interleave import ADKEYS

    params, state = ave.init_ave_model(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for k in ADKEYS:
        for ap in params["adapters"][k]:
            for g in ("gate", "gate_av"):
                ap[g] = torch.empty_like(ap[g]).uniform_(0.2, 0.6, generator=gen)
    return params, state


def seeded_requests(cfg):
    """REQUESTS requests of BATCH seeded clips: float, int16 and float waves
    with uint8 frames."""
    rs = np.random.RandomState(0)
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    wave_f = (0.3 * rs.randn(BATCH, T, L)).clip(-1, 1).astype(np.float32)
    frames = lambda: rs.randint(0, 256, (BATCH, T, S, S, 3), dtype=np.uint8)
    return [(wave_f, frames()), ((wave_f * 32767).astype(np.int16), frames()),
            (wave_f[::-1].copy(), frames())][:REQUESTS]


def run_model(cfg):
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
    from dg_sct_tpu_torch.ops.basic import normalize_frames_u8
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVEInferenceEngine

    params, state = seeded_model(cfg)
    requests = seeded_requests(cfg)
    eng = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, device="cuda")
    eng.predict(*requests[0])                       # warm-up: allocator, cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [eng.predict(w, f) for w, f in requests]
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for o in outs:
        assert o["event_scores"].shape == (BATCH, cfg.num_classes), o["event_scores"].shape
        assert o["is_event_scores"].shape == (BATCH, cfg.num_frames), o["is_event_scores"].shape
        assert o["segment_preds"].shape == (BATCH, cfg.num_frames)
        for v in o.values():
            assert np.isfinite(v).all(), "non-finite engine output"
    want = {k: v * REQUESTS for k, v in PER_FORWARD.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want} "
                             f"({PER_FORWARD} per forward x {REQUESTS})")
    print(f"model: {REQUESTS} requests of {BATCH} clips in {dt:.3f} s = "
          f"{REQUESTS * BATCH / dt:.3f} clips/s (bf16, kernels on), peak memory "
          f"{peak / 2**30:.3f} GiB, launches {counts}, card {torch.cuda.get_device_name(0)}",
          flush=True)

    profile_forward(eng, *requests[0])

    # float32: kernels on vs the plain path, same folded weights and inputs
    fp, fs = fold_adapters_eval(params, state, cfg)
    wave = torch.as_tensor(requests[0][0], device="cuda")
    frames = normalize_frames_u8(torch.as_tensor(requests[0][1], device="cuda"), torch.float32)
    with torch.inference_mode():
        got = ave.forward(fp, fs, wave, frames, cfg, kernels=True, device="cuda")
        ref = ave.forward(fp, fs, wave, frames, cfg, kernels=False, device="cuda")
    atol, rtol = MODEL_TOL
    for k in ref:
        g, r = got[k].float(), ref[k].float()
        err = (g - r).abs().max().item()
        ok = bool(torch.isfinite(g).all()) and bool(((g - r).abs() <= atol + rtol * r.abs()).all())
        print(f"model f32 {k}: kernels vs plain max abs err {err:.3e} "
              f"(atol {atol}, rtol {rtol}), |plain| max {r.abs().max().item():.3e}", flush=True)
        if not ok:
            raise AssertionError(f"f32 forward {k}: kernels and plain path disagree ({err:.3e})")
    bf = outs[0]["event_scores"]
    print(f"model bf16 engine vs f32 plain event_scores max abs diff "
          f"{np.abs(bf - ref['event_scores'].cpu().numpy()).max():.3e}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 5: the serving path, from a DG-SCT state dict to predict_clips
# ---------------------------------------------------------------------------

CENSUS = Path(__file__).resolve().parent / "tests" / "golden" / "census_best_82_18.json"
CLIPS = 7          # B=2, chunk=2: 4 forwards, the last batch ragged
STREAM_CLIPS = 32  # clips a timed run


def census_state_dict(path, seed=0):
    """A DG-SCT state dict with exactly the keys, shapes and dtypes of the
    census at `path`, values from `seed`: weights N(0, 1/fan_in), biases
    N(0, 0.02^2), LayerNorm and BatchNorm scales near 1, running variances
    in [0.5, 1.5], adapter gates in [0.2, 0.6], logit scales near log 10."""
    census = json.loads(Path(path).read_text())
    rng = np.random.default_rng(seed)
    normal = lambda shape, std, mean=0.0: (mean + std * rng.standard_normal(
        shape, dtype=np.float32)).astype(np.float32)
    sd = {}
    for k, spec in census.items():
        shape, dtype = tuple(spec["shape"]), np.dtype(spec["dtype"])
        if dtype.kind in "iu":
            sd[k] = np.zeros(shape, dtype)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif k.endswith(("running_mean", ".bias", "_bias")):
            sd[k] = normal(shape, 0.02)
        elif k.endswith((".gate", ".gate_av")):
            sd[k] = rng.uniform(0.2, 0.6, shape).astype(np.float32)
        elif k.endswith("logit_scale"):
            sd[k] = normal(shape, 0.1, math.log(10.0))
        elif len(shape) == 1 and k.endswith(".weight"):  # LayerNorm / BatchNorm scales
            sd[k] = normal(shape, 0.1, 1.0)
        else:
            sd[k] = normal(shape, 1.0 / math.sqrt(max(1, int(np.prod(shape[1:])))))
    return sd


def census_import(what, path, convert, ignored, cfg, device="cuda", **kw):
    """A census state dict (`path`) through the port's import path: `convert`,
    the key census against `ignored` (0 unexplained) and `from_jax` onto
    `device` -> (params, state, the converter's further returns, the start
    of the import line)."""
    from dg_sct_tpu_torch.utils import torch_convert as TC
    from dg_sct_tpu_torch.weights import from_jax

    sd = TC.track(census_state_dict(path))
    params, state, *rest = convert(sd)
    report = TC.census_report(sd, ignored)
    if report["unexplained"]:
        raise AssertionError(f"{what}: unexplained keys {report['unexplained'][:10]}")
    params, state = from_jax(params, state, cfg, device=device, **kw)
    return params, state, rest, (f"{what}: {len(sd)} keys of {path.name}: "
                                 f"{len(report['consumed'])} consumed, "
                                 f"{len(report['ignored'])} ignored, 0 unexplained")


def import_census_model(cfg):
    """The census state dict through the port's import path: converter,
    key census, `from_jax` onto the card."""
    from dg_sct_tpu_torch.utils import torch_convert as TC

    t0 = time.perf_counter()
    params, state, _, line = census_import("import", CENSUS, TC.convert_ave_model,
                                           TC.AVE_CKPT_IGNORED_PATTERNS, cfg)
    print(f"{line}; on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    return params, state


class Clips:
    """A map-style dataset of distinct seeded full-width clips in memory, in
    one wire format: int16 wave with uint8 RGB frames, or mu-law wave with
    YUV420 planes made from the same frames (JFIF, 2x2 chroma means). Frames
    are `size` square (the towers' input unless given); `named` adds the
    (category, video) fields an AVS dataset carries."""

    def __init__(self, n, cfg, seed, yuv420=False, size=None, named=False):
        from dg_sct_tpu_torch.ops.basic import encode_mulaw_u8

        rs = np.random.RandomState(seed)
        T, L = cfg.num_frames, cfg.htsat.frontend.clip_samples
        S = size or cfg.swin.img_size
        self.wave = (np.clip(0.3 * rs.randn(n, T, L), -1, 1) * 32767).astype(np.int16)
        self.frames = rs.randint(0, 256, (n, T, S, S, 3), dtype=np.uint8)
        self.names = [("synthetic", f"c{i:03d}") for i in range(n)] if named else None
        self.yuv420 = yuv420
        if yuv420:
            self.mulaw = encode_mulaw_u8(self.wave)
            rgb = self.frames.astype(np.float32)
            ycc = rgb @ np.asarray([[0.299, -0.168736, 0.5], [0.587, -0.331264, -0.418688],
                                    [0.114, 0.5, -0.081312]], np.float32)
            ycc[..., 1:] += 128.0
            ycc = np.clip(np.round(ycc), 0, 255)
            self.y = ycc[..., 0].astype(np.uint8)
            uv = ycc[..., 1:].reshape(n, T, S // 2, 2, S // 2, 2, 2).mean((3, 5))
            self.uv = np.round(uv).astype(np.uint8)

    def __len__(self):
        return len(self.wave)

    def __getitem__(self, i):
        if self.yuv420:
            item = {"wave": self.mulaw[i], "image_y": self.y[i], "image_uv": self.uv[i]}
        else:
            item = {"wave": self.wave[i], "image": self.frames[i]}
        if self.names:
            item["category"], item["video"] = self.names[i]
        return item

    def bytes_per_forward(self, batch):
        return batch * sum(v.nbytes for v in self[0].values() if isinstance(v, np.ndarray))


def check_clips(name, eng, ds, per_call, ref=None):
    """predict_clips with the launch counts read around it; shapes, finite
    values and, against `ref` (predict's output), agreement within bf16 TOL."""
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    ev, ie, pred = eng.predict_clips(ds)
    counts = launch_counts()
    n, T = len(ds), eng.cfg.num_frames
    if ev.shape != (n, 28) or ie.shape != (n, T) or pred.shape != (n, T):
        raise AssertionError(f"{name}: shapes {ev.shape} {ie.shape} {pred.shape}")
    if not (np.isfinite(ev).all() and np.isfinite(ie).all()):
        raise AssertionError(f"{name}: non-finite scores")
    want = {k: v * per_call for k, v in PER_FORWARD.items()}
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts}, expected {want}")
    line = f"serve {name}: {n} clips, launches {counts} ({per_call} forwards)"
    if ref is not None:
        atol, rtol = TOL[torch.bfloat16]
        for got, key in ((ev, "event_scores"), (ie, "is_event_scores")):
            err = np.abs(got - ref[key])
            line += f", {key} vs predict max abs diff {err.max():.3e}"
            if (err > atol + rtol * np.abs(ref[key])).any():
                raise AssertionError(f"{name}: predict_clips and predict disagree on {key}")
    print(line, flush=True)
    return ev, ie


def profile_chunk(eng, ds):
    """One predict_clips of several chunks under torch.profiler: each
    host-to-device copy's device time, start and share beside kernels, its
    kind, and the copies' time a forward."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.predict_clips(ds)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    h2d = sorted((e for e in dev if "htod" in e.name.lower().replace(" ", "")),
                 key=lambda e: e.time_range.start)
    kernels = sorted((e.time_range.start, e.time_range.end) for e in dev
                     if "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    forwards = -(-len(ds) // eng.B)
    staged = {k: eng.B * eng.chunk * v.nbytes for k, v in ds[0].items()}
    print(f"stream: profile of {len(ds)} clips ({forwards} forwards, chunks of {eng.chunk}): "
          f"{len(h2d)} host-to-device copies recorded of {len(staged) * forwards // eng.chunk} "
          f"staged; a chunk stages " + ", ".join(f"{k} {b / 1e6:.3f} MB"
                                                 for k, b in staged.items()), flush=True)
    if not h2d:
        return
    t0 = min(a for a, _ in kernels) if kernels else h2d[0].time_range.start
    total = 0.0
    for e in h2d:
        s, t = e.time_range.start, e.time_range.end
        beside = sum(max(0.0, min(t, b) - max(s, a)) for a, b in kernels)
        total += t - s
        print(f"stream:   copy {(t - s) / 1e3:.4f} ms at +{(s - t0) / 1e3:.3f} ms, "
              f"{100.0 * min(beside, t - s) / max(t - s, 1e-9):.1f}% beside kernels, {e.name}",
              flush=True)
    per_fwd = total / 1e3 / (len(h2d) / len(staged) * eng.chunk)
    print(f"stream: host-to-device copies {per_fwd:.4f} ms a forward (recorded copies), kinds "
          f"{sorted({e.name for e in h2d})}", flush=True)


def write_ave_tree(root, n, cfg, size=320, seed=0):
    """An AVE tree on disk: `n` videos of T JPEG frames (size x size) and
    int16 waves, with categories, annotations and split files."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    T, L = cfg.num_frames, cfg.htsat.frontend.clip_samples
    cats = [f"c{i}" for i in range(cfg.num_classes)]
    (root / "audio").mkdir(parents=True)
    rows = ["Category&VideoID&Quality&StartTime&EndTime"]
    for v in range(n):
        vid = f"v{v:03d}"
        vdir = root / "frames" / vid
        vdir.mkdir(parents=True)
        for t in range(T):
            Image.fromarray(rs.randint(0, 256, (size, size, 3), dtype=np.uint8)).save(
                vdir / f"{t:08d}.jpg", quality=90)
        np.save(root / "audio" / f"{vid}.npy",
                (np.clip(0.3 * rs.randn(T * L), -1, 1) * 32767).astype(np.int16))
        rows.append(f"{cats[v % len(cats)]}&{vid}&good&{v % 4}&{6 + v % 4}")
    (root / "categories.txt").write_text("\n".join(cats) + "\n")
    for name in ("Annotations.txt", "testSet.txt"):
        (root / name).write_text("\n".join(rows) + "\n")
    return root


def serve_from_disk(eng, cfg):
    """predict_clips over an on-disk AVE tree in both wire formats, if
    Pillow can write it; prints which decoder ran. A native build that
    fails for want of libjpeg's header falls back to PIL, any other build
    failure is fatal."""
    import tempfile

    from dg_sct_tpu_torch import native
    from dg_sct_tpu_torch.data.ave import AVEDataset

    try:
        import PIL  # noqa: F401
    except ImportError as e:
        print(f"serve disk: not run: Pillow does not import ({e})", flush=True)
        return
    if native.available():
        decoder = "native"
    elif "jpeglib.h" in (native.build_error() or ""):
        decoder = "pil"
        print(f"serve disk: native core not built, jpeglib.h missing: "
              f"{native.build_error().strip().splitlines()[0]}", flush=True)
    else:
        raise RuntimeError(f"native io core failed to build:\n{native.build_error()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ave_") as tmp:
        root = write_ave_tree(Path(tmp), CLIPS, cfg)
        for fmt, kw in (("u8+i16", {"raw_u8": True}),
                        ("yuv420+mulaw", {"yuv420": True, "wave_mulaw": True})):
            ds = AVEDataset(str(root), "test", img_size=cfg.swin.img_size,
                            frame_dir=str(root / "frames"), audio_dir=str(root / "audio"),
                            num_frames=cfg.num_frames,
                            segment_samples=cfg.htsat.frontend.clip_samples, **kw)
            t0 = time.perf_counter()
            check_clips(f"disk {fmt} ({decoder} decoder)", eng, ds, 4)
            print(f"serve disk {fmt}: decoder {decoder}, {len(ds)} clips of 320x320 JPEGs in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)


def run_serving(cfg):
    """Phase 5: the census-built model in bf16 through predict_clips."""
    from dg_sct_tpu_torch.serve import AVEInferenceEngine

    params, state = import_census_model(cfg)
    eng = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device="cuda")
    del params, state
    u8, yuv = Clips(CLIPS, cfg, seed=10), Clips(CLIPS, cfg, seed=10, yuv420=True)
    ref = eng.predict(u8.wave, u8.frames)
    ev, ie = check_clips("u8+i16", eng, u8, 4, ref)
    ev2, ie2 = check_clips("u8+i16 again", eng, u8, 4, ref)
    print(f"serve u8+i16: two runs max abs diff {np.abs(ev2 - ev).max():.3e} / "
          f"{np.abs(ie2 - ie).max():.3e}", flush=True)
    ev, ie = check_clips("yuv420+mulaw", eng, yuv, 4)
    ev2, ie2 = check_clips("yuv420+mulaw again", eng, yuv, 4)
    atol, rtol = TOL[torch.bfloat16]
    if not (np.allclose(ev2, ev, atol=atol, rtol=rtol) and np.allclose(ie2, ie, atol=atol,
                                                                       rtol=rtol)):
        raise AssertionError("yuv420+mulaw: two predict_clips runs disagree")
    print(f"serve yuv420+mulaw: two runs max abs diff {np.abs(ev2 - ev).max():.3e} / "
          f"{np.abs(ie2 - ie).max():.3e}", flush=True)
    eng.chunk = 3  # 7 clips: 4 batches in 2 chunks of 3, the last padded with 2 batches
    check_clips("u8+i16 chunk 3", eng, u8, 6, ref)
    eng.chunk = 2

    serve_from_disk(eng, cfg)

    u8, yuv = Clips(STREAM_CLIPS, cfg, seed=11), Clips(STREAM_CLIPS, cfg, seed=11, yuv420=True)
    for ds, fmt in ((u8, "u8+i16"), (yuv, "yuv420+mulaw")):
        print(f"stream: {fmt}: {ds.bytes_per_forward(BATCH) / 1e6:.3f} MB host to device a "
              f"forward of {BATCH} clips", flush=True)
    for rnd in (1, 2):
        for name, fn in (("predict_clips u8+i16", lambda: eng.predict_clips(u8)),
                         ("predict u8+i16", lambda: eng.predict(u8.wave, u8.frames)),
                         ("predict_clips yuv420+mulaw", lambda: eng.predict_clips(yuv))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
            print(f"stream: run {rnd} {name}: {STREAM_CLIPS} clips in {dt:.3f} s = "
                  f"{STREAM_CLIPS / dt:.3f} clips/s (B={BATCH}, chunk {eng.chunk}, bf16)",
                  flush=True)
    profile_chunk(eng, Clips(3 * BATCH * eng.chunk, cfg, seed=12))


# ---------------------------------------------------------------------------
# phase 6: AVE training at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH = 8      # TrainConfig.batch_size: 80 frames and 80 audio clips a mini-step
TRAIN_ACCUM = 2
TRAIN_STEPS = 4
EVAL_LAUNCHES = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 0,
                 "int8_linear": 0, "int8_quantize": 0}


def unused_leaf(path) -> bool:
    """Trainable weights the AVE forward never reads, kept for checkpoint
    parity (`models/heads/ave.py`): CMBS's AVInter / VAInter and the
    decoders' self-attention. Their gradient is zero, so Adam leaves them."""
    return (path[0] == "CMBS" and path[1] in ("AVInter", "VAInter")) or (
        path[0] == "temporal_attn" and path[1].endswith("_decoder") and "self_attn" in path)


def train_batches(cfg, n, batch, seed, device):
    """`n` seeded synthetic batches at the model's widths on `device`, each
    with a mixup lambda a clip of audio (B*T)."""
    from dg_sct_tpu_torch.data.ave import synthetic_batch

    out = []
    for i in range(n):
        b = synthetic_batch(batch, img_size=cfg.swin.img_size, num_segments=cfg.num_frames,
                            sr=cfg.htsat.frontend.clip_samples, seed=seed + i)
        b["mixup_lambda"] = np.random.RandomState(seed + i).beta(
            0.5, 0.5, size=(batch * cfg.num_frames,)).astype(np.float32)
        out.append({k: torch.as_tensor(v, device=device) for k, v in b.items()})
    return out


def timed_step(step, args):
    """One train step, synchronised -> (its outputs, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def remat_none_step(cfg, opt, tr, fr, state, opt_state, batch, device):
    """Two mini-steps of TRAIN_BATCH clips with remat "none" from the same
    inputs (the first grows the allocator's pool): ([seconds of each], peak
    GiB). An out-of-memory error is fatal."""
    from dg_sct_tpu_torch.train import ave_train

    step = ave_train.make_train_step(cfg, opt, device=device, remat_policy="none")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        (_, _, _, m), dt = timed_step(step, (tr, fr, state, opt_state, batch,
                                             torch.Generator(device=device).manual_seed(5)))
        if not math.isfinite(float(m["loss"])):
            raise AssertionError("train remat none: the loss is not finite")
        times.append(dt)
    return times, torch.cuda.max_memory_allocated() / 2**30


def run_training(cfg, device="cuda"):
    """Phase 6: the full-width model in bf16 over float32 Adam masters, remat
    "full", TRAIN_BATCH clips, accum TRAIN_ACCUM; TRAIN_STEPS mini-steps
    with SpecAugment, drop_path, dropout and mixup on, the checks of each,
    a profiled mini-step, two with remat "none", the eval step, and the
    saved train state served by the engine."""
    import dataclasses
    import tempfile

    from dg_sct_tpu_torch.configs import TrainConfig
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVEInferenceEngine
    from dg_sct_tpu_torch.train import ave_train
    from dg_sct_tpu_torch.utils import checkpoint as ckpt
    from dg_sct_tpu_torch.utils.tree import tree_paths
    from dg_sct_tpu_torch.weights import from_jax

    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    params, state = seeded_model(cfg, device)
    gen = torch.Generator(device=device)
    tr, fr = ave_train.partition_params(params)
    p0 = {p: t.cpu() for p, t in tree_paths(params)}  # on the host: not in the peak
    s0 = {p: t.cpu() for p, t in tree_paths(state)}
    opt = ave_train.make_optimizer(tr, TrainConfig(batch_size=TRAIN_BATCH,
                                                   accum_steps=TRAIN_ACCUM), steps_per_epoch=1)
    opt_state = opt.init(tr)
    step = ave_train.make_train_step(tcfg, opt, device=device, remat_policy="full")
    batches = train_batches(cfg, TRAIN_STEPS, TRAIN_BATCH, seed=20, device=device)
    gen.manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for i in range(TRAIN_STEPS):
        (tr, state, opt_state, m), dt = timed_step(step, (tr, fr, state, opt_state, batches[i],
                                                          gen))
        times.append(dt)
        loss = float(m["loss"])
        print(f"train: mini-step {i + 1}: loss {loss:.4f}, acc {float(m['acc']):.2f}, "
              f"{dt:.3f} s, applied updates {opt_state['gradient_step']}", flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"train: mini-step {i + 1}: the loss is not finite")
        if i > 1:
            continue
        now = dict(tree_paths(ave_train.merge_params(tr, fr)))
        same = {p: torch.equal(now[p].cpu(), p0[p]) for p in p0}
        if i == 0 and not all(same.values()):
            changed = [p for p in same if not same[p]]
            raise AssertionError(f"train: mini-step 1 changed {changed[:3]}")
        if i == 1:
            frozen = [p for p in same if p[0] in ("swin", "htsat")]
            moved = [p for p in same if p[0] not in ("swin", "htsat") and not same[p]]
            dead = [p for p in same if p[0] not in ("swin", "htsat") and unused_leaf(p)]
            bad = ([p for p in frozen if not same[p]]
                   + [p for p in same if p[0] not in ("swin", "htsat")
                      and same[p] != unused_leaf(p)])
            if bad:
                raise AssertionError(f"train: after mini-step 2, leaves against the rule: "
                                     f"{bad[:5]}")
            print(f"train: after mini-step 2: {len(moved)} trainable leaves changed, "
                  f"{len(dead)} unused ones and {len(frozen)} frozen ones bit-identical",
                  flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"train: the train steps launched kernels {counts}")
    bn = [(p, t) for p, t in tree_paths(state) if p[-1] in ("mean", "var")]
    still = [p for p, t in bn if torch.equal(t.cpu(), s0[p])]
    counts_bn = {int(t) for p, t in tree_paths(state) if p[-1] == "count"}
    if still or counts_bn != {TRAIN_STEPS}:
        raise AssertionError(f"train: BN state did not move: {still[:3]}, counts {counts_bn}")
    print(f"train: {TRAIN_STEPS} mini-steps of B={TRAIN_BATCH} clips, accum {TRAIN_ACCUM}, "
          f"bf16 over float32 masters, remat full: "
          + ", ".join(f"{t:.3f}" for t in times) + f" s; peak memory {peak:.3f} GiB; "
          f"{len(bn)} BN stats of bn0 and the adapters moved, counts {TRAIN_STEPS}; "
          f"kernel launches {counts}; card {torch.cuda.get_device_name(0)}", flush=True)

    profile_run(lambda: step(tr, fr, state, opt_state, batches[0], gen),
                f"one mini-step of {TRAIN_BATCH} clips, remat full", "train profile",
                host_ops=False)
    dts, peak_none = remat_none_step(tcfg, opt, tr, fr, state, opt_state, batches[0], device)
    print(f"train remat none: two mini-steps of B={TRAIN_BATCH} clips in "
          + ", ".join(f"{t:.3f}" for t in dts) + f" s, peak memory {peak_none:.3f} GiB",
          flush=True)

    estep = ave_train.make_eval_step(tcfg, device=device)
    reset_launch_counts()
    em = estep(tr, fr, state, batches[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != EVAL_LAUNCHES or not all(bool(torch.isfinite(v).all())
                                          for v in em["outputs"].values()):
        raise AssertionError(f"train eval step: launches {counts} (expected {EVAL_LAUNCHES}) "
                             f"or non-finite outputs")
    print(f"train eval step: B={TRAIN_BATCH}, correct_frac {float(em['correct_frac']):.4f}, "
          f"launches {counts}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        path = str(Path(tmp) / "train_state.npz")
        t0 = time.perf_counter()
        ckpt.save_train_state(path, params=ave_train.merge_params(tr, fr), state=state,
                              opt_state=opt_state, rng_state=gen.get_state(),
                              step=opt_state["gradient_step"])
        size = Path(path).stat().st_size
        lp, ls = ckpt.load_params_and_state(path)
        dt = time.perf_counter() - t0
    eng = AVEInferenceEngine(cfg, *from_jax(lp, ls, cfg, device=device), batch_size=BATCH,
                             device=device)
    rs = np.random.RandomState(30)
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    wave = (np.clip(0.3 * rs.randn(BATCH, T, L), -1, 1) * 32767).astype(np.int16)
    frames = rs.randint(0, 256, (BATCH, T, S, S, 3), dtype=np.uint8)
    eng.predict(wave, frames)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = eng.predict(wave, frames)
    counts = launch_counts()
    if counts != PER_FORWARD or not all(np.isfinite(v).all() for v in out.values()):
        raise AssertionError(f"train serve: launches {counts} (expected {PER_FORWARD}) or "
                             f"non-finite scores")
    print(f"train serve: train state of {size / 1e9:.3f} GB saved and read in {dt:.1f} s; "
          f"the engine folds its params and state and answers {BATCH} clips, launches "
          f"{counts}", flush=True)


# ---------------------------------------------------------------------------
# phase 7: int8 serving of the full-width model
# ---------------------------------------------------------------------------

INT8_PER_FORWARD = {"window_attention": 34, "block_attention": 2, "adapter_bottleneck": 48,
                    "int8_linear": 430, "int8_quantize": 430}
INT8_ELIGIBLE = 431     # eligible linears of towers and adapters; HTS-AT's head is never called
INT8_TOWERS_ONLY = 142  # K4 a forward with the towers alone quantized
INT8_ATTN_K1 = 10       # K1 a forward with int8_attn: HTS-AT stages 1-3 only
# f32 int8 forward, kernels against the plain path: max |delta| over the logit
# spread, per output. K1-K3 differ from their plain versions by ~1e-6, and the
# int8 forward amplifies any difference that carries a value across a rounding
# boundary of a quantize. The bounds sit between two sets of readings of this
# seeded forward on the H100: above the sound kernels' (7.2e-3, 2.3e-2) and the
# plain path's own move under a 1e-6 relative change of its inputs (5.6e-3,
# 4.7e-2, printed beside), and below what K1 gave while it read unwritten TF32
# halves of its pad rows (event_scores 0.025-0.106, is_event_scores 0.086-0.46).
# Every K4 call of the forward is also held against the plain version on the
# very input it was given (TOL).
INT8_TOL = {"event_scores": 0.02, "is_event_scores": 0.07}
INT8_NUDGE = 1e-6  # relative change of the frames for the sensitivity


def int8_variants(scales):
    """(name, engine options, launches a forward) of the other int8 runs."""
    return (("towers only", dict(int8_towers=True, act_scales=scales),
             dict(INT8_PER_FORWARD, int8_linear=INT8_TOWERS_ONLY,
                  int8_quantize=INT8_TOWERS_ONLY)),
            ("dynamic scales", dict(int8_towers=True, int8_adapters=True, act_scales=None),
             INT8_PER_FORWARD),
            ("int8_attn", dict(int8_towers=True, int8_adapters=True, act_scales=scales,
                               int8_attn=True),
             dict(INT8_PER_FORWARD, window_attention=INT8_ATTN_K1)))


def spread_err(got, ref):
    """max |got - ref| over max |ref|."""
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def check_int8_calls(qp, towers, forward, what):
    """One forward (`forward(tree)`, kernels on) of the quantized tree `qp`, in
    which every quantized linear of `towers` also sends its input through K4
    and its plain version side by side (a tag on each, as calibration
    records): (calls, max abs error). Fatal beyond TOL."""
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.ops.kernels import int8_linear as K4

    ordered = quant._ordered_towers(qp, towers)
    nodes = quant.eligible_linears(ordered)

    class Check(quant.Recorder):
        def record(self, qid, x):
            p = nodes[qid]
            args = (x.reshape(-1, x.shape[-1]), p["kernel_q"], p["kscale"], p.get("ascale"),
                    p.get("bias"))
            got, ref = K4.int8_linear(*args), K4.linear_int8_plain(*args)
            diff = torch.nan_to_num((got - ref).abs(), nan=math.inf)
            worst = (diff / (TOL[x.dtype][0] + TOL[x.dtype][1] * ref.abs())).max()
            bad_x = (~torch.isfinite(x)).sum()
            self.calls.append((qid, torch.stack([diff.max(), worst, bad_x.float()])))

    check = Check()
    tagged = dict(qp)
    tagged.update(quant.attach_qtags(ordered, recorder=check))
    with torch.inference_mode():
        forward(tagged)
    stats = torch.stack([e for _, e in check.calls]).cpu()
    order = stats[:, 1].argsort(descending=True)[:3].tolist()
    for i in order:
        qid = check.calls[i][0]
        print(f"{what}: K4 call of qid {qid} {tuple(nodes[qid]['kernel_q'].shape)}: max abs "
              f"err {stats[i, 0]:.3e}, error/tolerance {stats[i, 1]:.3e}, non-finite inputs "
              f"{int(stats[i, 2])}", flush=True)
    err = stats[:, 0].max().item()
    if not err == 0:
        raise AssertionError(f"{what}: a K4 call of the forward differs from the plain "
                             f"version ({err:.3e}), expected 0")
    return len(check.calls), err


def run_int8(cfg, device="cuda"):
    """Phase 7: calibrate on a seeded batch, serve the full-width model in int8
    (towers and adapters, static scales) in turns with a bf16 engine on the
    same weights and requests; drift, a profiled forward, the f32 int8
    forward with kernels against the plain one, and the other int8 options.
    Returns the int8 engine's launch counts over its REQUESTS requests."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.ops.basic import normalize_frames_u8
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVEInferenceEngine
    from dg_sct_tpu_torch.utils.tree import tree_paths

    torch.cuda.empty_cache()
    params, state = seeded_model(cfg, device)
    bf = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, device=device)
    # the calibration batch of bench.py:666-674, in bf16
    rs = np.random.RandomState(7)
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    cw = torch.as_tensor((rs.randn(BATCH, T, L) * 0.1).astype(np.float32), device=device)
    ci = torch.as_tensor(rs.rand(BATCH, T, S, S, 3).astype(np.float32), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scales = quant.calibrate_ave(bf.params, bf.state, bf.cfg, cw.to(torch.bfloat16),
                                 ci.to(torch.bfloat16), towers=INT8_TOWERS, gelu=bf.gelu,
                                 device=device)
    dt = time.perf_counter() - t0
    shapes = quant.qid_shape_map(quant._ordered_towers(bf.params, INT8_TOWERS))
    if len(shapes) != INT8_ELIGIBLE or len(scales) != INT8_PER_FORWARD["int8_linear"]:
        raise AssertionError(f"int8: {len(scales)} scales for {len(shapes)} eligible linears")
    print(f"int8: calibrated {len(scales)} activation scales of {len(shapes)} eligible linears "
          f"in {dt:.3f} s (one plain bf16 forward of {BATCH} clips); absmax "
          f"{min(scales.values()):.4g} to {max(scales.values()):.4g}", flush=True)

    q8 = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, device=device,
                            int8_towers=True, int8_adapters=True, act_scales=scales)
    engines = {"bf16": (bf, PER_FORWARD), "int8": (q8, INT8_PER_FORWARD)}
    requests = seeded_requests(cfg)
    for eng, _ in engines.values():
        eng.predict(*requests[0])  # warm-up
    weights = {k: sum(t.nbytes for _, t in tree_paths(eng.params) if torch.is_tensor(t))
               for k, (eng, _) in engines.items()}
    secs, work, outs = {k: 0.0 for k in engines}, {k: 0 for k in engines}, {k: [] for k in engines}
    int8_counts = dict.fromkeys(INT8_PER_FORWARD, 0)
    for r, req in enumerate(requests):  # in turns: bf16 int8, int8 bf16, bf16 int8
        for name in ("bf16", "int8") if r % 2 == 0 else ("int8", "bf16"):
            eng, want = engines[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = eng.predict(*req)
            secs[name] += time.perf_counter() - t0
            counts = launch_counts()
            work[name] = max(work[name], torch.cuda.max_memory_allocated() - resident)
            if counts != want:
                raise AssertionError(f"int8: {name} request {r}: launches {counts}, "
                                     f"expected {want}")
            if name == "int8":
                int8_counts = {k: int8_counts[k] + v for k, v in counts.items()}
            if not all(np.isfinite(v).all() for v in out.values()):
                raise AssertionError(f"int8: {name} request {r}: non-finite outputs")
            if out["event_scores"].shape != (BATCH, cfg.num_classes):
                raise AssertionError(f"int8: {name}: event_scores {out['event_scores'].shape}")
            outs[name].append(out)
    n = BATCH * len(requests)
    print(f"int8: {len(requests)} requests of {BATCH} clips in turns with bf16: int8 "
          f"{n / secs['int8']:.3f} clips/s, bf16 {n / secs['bf16']:.3f} clips/s; weights + a "
          f"request's peak above what was resident: int8 {weights['int8'] / 2**30:.3f} + "
          f"{work['int8'] / 2**30:.3f} GiB, bf16 {weights['bf16'] / 2**30:.3f} + "
          f"{work['bf16'] / 2**30:.3f} GiB; launches a forward int8 {INT8_PER_FORWARD}, bf16 "
          f"{PER_FORWARD}; card {torch.cuda.get_device_name(0)}", flush=True)
    cat = lambda name, k: np.concatenate([o[k] for o in outs[name]])
    agree = float((cat("int8", "segment_preds") == cat("bf16", "segment_preds")).mean())
    print(f"int8: drift against bf16 over {n} clips: max |delta event_scores| / max |event_scores| "
          f"{spread_err(cat('int8', 'event_scores'), cat('bf16', 'event_scores')):.4f}, "
          f"is_event_scores "
          f"{spread_err(cat('int8', 'is_event_scores'), cat('bf16', 'is_event_scores')):.4f}; "
          f"segment_preds agree {100.0 * agree:.1f}%", flush=True)

    profile_run(lambda: q8.forward_batch(*requests[0]), f"one int8 forward of {BATCH} clips",
                "int8 profile")
    del q8, engines

    # float32: the int8 forward with kernels against the int8 plain path
    fp, fs = fold_adapters_eval(params, state, cfg)
    qp = quant.quantize_eval_params(fp, towers=INT8_TOWERS, act_scales=scales)
    wave = torch.as_tensor(requests[0][0], device=device)
    frames = normalize_frames_u8(torch.as_tensor(requests[0][1], device=device), torch.float32)
    gen = torch.Generator(device).manual_seed(3)
    nudge = lambda t: t * (1.0 + INT8_NUDGE * torch.randn(t.shape, device=device, generator=gen))
    with torch.inference_mode():
        reset_launch_counts()
        got = ave.forward(qp, fs, wave, frames, cfg, kernels=True, device=device)
        counts = launch_counts()
        ref = ave.forward(qp, fs, wave, frames, cfg, kernels=False, device=device)
        near = ave.forward(qp, fs, nudge(wave), nudge(frames), cfg, kernels=False, device=device)
        flt = ave.forward(fp, fs, wave, frames, cfg, kernels=False, device=device)
    if counts != INT8_PER_FORWARD:
        raise AssertionError(f"int8 f32: launches {counts}, expected {INT8_PER_FORWARD}")
    calls, err = check_int8_calls(
        qp, INT8_TOWERS,
        lambda t: ave.forward(t, fs, wave, frames, cfg, kernels=True, device=device),
        "int8 f32")
    print(f"int8 f32: each of the {calls} K4 calls of a forward against the plain version on "
          f"its own input: max abs err {err:.3e} (must be 0)", flush=True)
    bad = []
    for k, bound in INT8_TOL.items():
        g, r = got[k].float().cpu().numpy(), ref[k].float().cpu().numpy()
        err = spread_err(g, r)
        print(f"int8 f32 {k}: kernels vs plain max |delta| / max |plain| {err:.3e} (bound "
              f"{bound}), max abs diff {np.abs(g - r).max():.3e}; the plain path moves "
              f"{spread_err(near[k].float().cpu().numpy(), r):.3e} with wave and frames "
              f"changed by {INT8_NUDGE:g} (relative); int8 against float (plain, f32) "
              f"{spread_err(r, flt[k].float().cpu().numpy()):.3e}", flush=True)
        if not np.isfinite(g).all() or err > bound:
            bad.append(f"{k} ({err:.3e})")
    if bad:
        raise AssertionError(f"int8 f32: kernels and plain path disagree: {', '.join(bad)}")
    del fp, fs, qp, got, ref, near, flt

    for name, opts, want in int8_variants(scales):
        eng = AVEInferenceEngine(cfg, params, state, batch_size=BATCH, device=device, **opts)
        eng.predict(*requests[1])  # warm-up
        reset_launch_counts()
        out = eng.predict(*requests[1])
        counts = launch_counts()
        if counts != want or not all(np.isfinite(v).all() for v in out.values()):
            raise AssertionError(f"int8 {name}: launches {counts} (expected {want}) or "
                                 f"non-finite outputs")
        print(f"int8 {name}: launches {counts}, finite; event_scores against bf16 "
              f"{spread_err(out['event_scores'], outs['bf16'][1]['event_scores']):.4f} of the "
              f"spread", flush=True)
        del eng
    return int8_counts


# ---------------------------------------------------------------------------
# phase 8: AVS serving at full width
# ---------------------------------------------------------------------------

AVS_CENSUS = Path(__file__).resolve().parent / "tests" / "golden" / "census_avs_s4.json"
# AVS adapters stay off K3, as in the JAX package
AVS_PER_FORWARD = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 0,
                   "int8_linear": 0, "int8_quantize": 0}
AVS_INT8_PER_FORWARD = {"window_attention": 34, "block_attention": 2, "adapter_bottleneck": 0,
                        "int8_linear": 142, "int8_quantize": 142}
AVS_STREAM_CLIPS = 16
AVS_INT8_TOWERS = ("swin", "htsat")  # what the AVS engine's int8_towers quantizes
# f32 engine with kernels against the plain one, max |delta logit| over max
# |logit|: above the plain path's own move under a 1e-6 relative change of
# its inputs and above the sound kernels' readings (printed beside), below
# the readings of the faults PLANTED in front of K2.
AVS_F32_TOL = 1e-3
# the f32 int8-towers forward (B=2 clips) with kernels against the plain one,
# mean |delta logit| over mean |logit| (its max moves with the int8 roundings
# that a 1e-6 change of the inputs flips, as far as a planted fault moves it):
# above the sound kernels' reading and the plain path's move under the nudge,
# below the faults planted in front of K1, which runs the 32 quantized blocks'
# attention (readings in PERF.md, section 6, PR 9)
AVS_INT8_TOL = 1.25e-2
MASK_U8_TOL = 0.5 / 255 + 1e-6
# known faults put in front of a kernel, each read against a bound above:
# the relative-position bias as a float32 kernel that staged it in bf16
# would see it, and as an off-by-one in its key index would
PLANTED = {"bias rounded to bf16": lambda b: b.to(torch.bfloat16).to(b.dtype),
           "bias rolled by one key": lambda b: b.roll(1, -1).contiguous()}


def avs_op_group(e):
    """The AVS profile's host-op groups: every kernel under a convolution
    (cuDNN), and TPAVI's two products, the forward's only direct torch.bmm
    calls (einsum's and matmul's bmm run under those ops)."""
    op = e
    while op is not None:
        if op.name == "aten::convolution":
            return "cuDNN conv"
        op = op.cpu_parent
    if e.name == "aten::bmm" and e.cpu_parent is None:
        return "TPAVI products"
    return None


def write_avs_tree(root, videos, cfg, seed=0, split="test"):
    """An AVSBench split: T PNG frames and binary masks (mask_size^2) a video
    and a float32 wave of T x clip_samples."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    T, S, L = cfg.num_frames, cfg.mask_size, cfg.htsat.frontend.clip_samples
    (root / "audio_wav").mkdir(parents=True, exist_ok=True)
    for cat, vid in videos:
        fdir = root / "visual_frames" / split / cat / vid
        mdir = root / "gt_masks" / split / cat / vid
        fdir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        for t in range(T):
            Image.fromarray(rs.randint(0, 256, (S, S, 3), dtype=np.uint8)).save(
                fdir / f"{vid}_{t}.png")
            Image.fromarray(((rs.rand(S, S) > 0.5) * 255).astype(np.uint8)).save(
                mdir / f"{vid}_{t}.png")
        np.save(root / "audio_wav" / f"{vid}.npy",
                np.clip(0.3 * rs.randn(T * L), -1, 1).astype(np.float32))
    return root


class Nudged:
    """A dataset's items with the float arrays under `keys` (image and wave)
    scaled by (1 + rel * N(0, 1))."""

    def __init__(self, ds, rel, seed, keys=("image", "wave")):
        self.ds, self.rel, self.seed, self.keys = ds, rel, seed, keys

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = dict(self.ds[i])
        rs = np.random.RandomState(self.seed + i)
        for k in self.keys:
            v = item[k].astype(np.float32)
            item[k] = (v * (1.0 + self.rel * rs.randn(*v.shape))).astype(np.float32)
        return item


class patched:
    """Within the block, `module.name` is `wrap(module.name)`."""

    def __init__(self, module, name, wrap):
        self.mod, self.attr, self.wrap = module, name, wrap

    def __enter__(self):
        self.real = getattr(self.mod, self.attr)
        setattr(self.mod, self.attr, self.wrap(self.real))

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.real)


KERNEL_CALLERS = {  # where the model calls each kernel's wrapper
    "window_attention": ("dg_sct_tpu_torch.ops.windows", "window_attention"),
    "block_attention": ("dg_sct_tpu_torch.ops.windows", "fused_attn_half_block"),
    "adapter_bottleneck": ("dg_sct_tpu_torch.ops.kernels.adapter_bottleneck", "bottleneck_rows")}


def intercept(kernel, wrap):
    """Every call of K1, K2 or K3 (`kernel`) from the model (K1 and K2 from
    its attention, `ops.windows`; K3 from the adapters' `fused_bottleneck`)
    goes through `wrap(kernel's wrapper)` within the block."""
    import importlib

    module, name = KERNEL_CALLERS[kernel]
    return patched(importlib.import_module(module), name, wrap)


def planted(kernel, fault):
    """K1 or K2 handed its relative-position bias, or K3 its down weights,
    through `fault` (a value of PLANTED or K3_PLANTED); the kernel itself
    still launches."""
    pos = {"window_attention": 3, "block_attention": 5, "adapter_bottleneck": 1}[kernel]

    def wrap(real):
        def faulty(*args, **kw):
            args = list(args)
            args[pos] = fault(args[pos])
            return real(*args, **kw)
        return faulty

    return intercept(kernel, wrap)


def side_by_side(kernel, calls):
    """Each call of K1, K2 or K3 also runs the plain version on the same
    inputs; (max abs err, error/tolerance) of each goes to `calls`, on the
    card."""
    from dg_sct_tpu_torch.ops.kernels import adapter_bottleneck as K3
    from dg_sct_tpu_torch.ops.kernels import block_attention as K2
    from dg_sct_tpu_torch.ops.kernels import window_attention as K1

    plain = {"window_attention": K1.window_attention_plain,
             "block_attention": K2.fused_attn_half_block_plain,
             "adapter_bottleneck": K3.bottleneck_rows_plain}[kernel]

    def wrap(real):
        def paired(*args, **kw):
            got = real(*args, **kw)
            ref = plain(*args, **kw).float()
            atol, rtol = TOL[got.dtype]
            diff = torch.nan_to_num((got.float() - ref).abs(), nan=math.inf)
            calls.append(torch.stack([diff.max(), (diff / (atol + rtol * ref.abs())).max()]))
            return got
        return paired

    return intercept(kernel, wrap)


def report_calls(what, kernel, calls, bad):
    """Print and check what `side_by_side` collected."""
    if not calls:
        bad.append(f"{what}: no {kernel} call to check")
        return
    stats = torch.stack(calls).cpu()
    err, worst = stats[:, 0].max().item(), stats[:, 1].max().item()
    print(f"{what}: each of the {len(calls)} {kernel} calls against the plain version on its "
          f"own input: max abs err {err:.3e}, error/tolerance {worst:.3e} (atol/rtol "
          f"{TOL[torch.float32]})", flush=True)
    if not worst <= 1.0:
        bad.append(f"{what}: a {kernel} call disagrees with the plain version ({err:.3e})")


def mean_err(got, ref):
    """mean |got - ref| over mean |ref|."""
    return float(np.abs(got - ref).mean() / max(np.abs(ref).mean(), 1e-12))


def read_planted(kernel, run, ref, bound, what, bad, stat=spread_err, faults=PLANTED):
    """`run()` under each of `faults` in front of `kernel`, read against `ref`
    by `stat`; a reading at or below `bound` goes to `bad` (the bound would
    pass that fault)."""
    for name, fault in faults.items():
        with planted(kernel, fault):
            out = run()
        err = stat(out, ref)
        print(f"{what}: planted fault, {kernel} {name}: {stat.__name__} {err:.3e} (bound "
              f"{bound:g}, must be above it); spread_err {spread_err(out, ref):.3e}, mean_err "
              f"{mean_err(out, ref):.3e}", flush=True)
        if not err > bound:
            bad.append(f"{what}: the bound passes a planted fault ({kernel}, {name}: {err:.3e})")


def stream_all(eng, ds):
    """stream_masks over the whole dataset -> (masks, metas, launch counts)."""
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = list(eng.stream_masks(ds))
    return (np.concatenate([m for m, _ in out]), [x for _, row in out for x in row],
            launch_counts())


def import_avs_census_model(cfg):
    """The AVS S4 census state dict through the port's import path:
    converter, key census (0 unexplained), `from_jax` onto the card."""
    from dg_sct_tpu_torch.utils import torch_convert as TC

    t0 = time.perf_counter()
    params, state, (pvt,), line = census_import("avs import", AVS_CENSUS, TC.convert_avs_model,
                                                TC.AVS_CKPT_IGNORED_PATTERNS, cfg)
    if pvt is None:
        raise AssertionError("avs import: the PVT-v2-b5 tower was not converted")
    print(f"{line}; PVT-v2-b5 tower converted, bypassed; on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params, state


def launches_for(per_forward, n):
    """The launch counts of serving `n` items at B=BATCH."""
    return {k: v * -(-n // BATCH) for k, v in per_forward.items()}


def check_folded(eng, what, note=""):
    """Every adapter the engine folded holds no bn1, bn2 or gate (K3 takes it)."""
    folded = [ap for k in eng.params["adapters"] for ap in eng.params["adapters"][k]]
    eligible = sum(not {"bn1", "bn2", "gate"} & set(ap) for ap in folded)
    print(f"{what} fold: {eligible} of the {len(folded)} folded adapters hold no bn1, bn2 or "
          f"gate (K3 takes them{note})", flush=True)
    if eligible != len(folded):
        raise AssertionError(f"{what} fold: an adapter kept its BN or gate after fold_eval")


def serve_timed(what, stream, eng, disk, per_forward):
    """`stream` (a `stream_*_all`, its launch counts last) over the decoded
    items once to warm up, then timed -> (its result, seconds, peak bytes);
    fails unless the launches are `per_forward` a forward."""
    stream(eng, disk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = stream(eng, disk)
    dt = time.perf_counter() - t0
    want = launches_for(per_forward, len(disk))
    if out[-1] != want:
        raise AssertionError(f"{what}: launch counts {out[-1]}, expected {want}")
    return out, dt, torch.cuda.max_memory_allocated()


def f32_against_plain(what, stream, plain, kern, disk, tol, bad, *, per_forward, checked,
                      planted_in, faults, nudge_keys=("image", "wave"), flatten=lambda x: x,
                      detail=lambda got, ref: "", hooks=(None, None)):
    """The float32 engine with kernels (`kern`) against the plain one on the
    decoded items: each call of the kernels in `checked` against its plain
    version on its own input, the launches, the first outputs (`flatten`ed)
    within `tol` by `spread_err` beside the plain path's own move under a
    relative nudge of `nudge_keys`, and `faults` planted in front of
    `planted_in`, each of which `tol` must catch. `hooks` are contexts held
    over the plain run and the kernel run. -> (ref, got)."""
    with hooks[0] or contextlib.nullcontext():
        ref = stream(plain, disk)[0]
    calls = {k: [] for k in checked}
    with contextlib.ExitStack() as stack:
        for kernel in checked:
            stack.enter_context(side_by_side(kernel, calls[kernel]))
        if hooks[1] is not None:
            stack.enter_context(hooks[1])
        out = stream(kern, disk)
    got, counts = out[0], out[-1]
    want = launches_for(per_forward, len(disk))
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, expected {want}")
    for kernel, c in calls.items():
        report_calls(what, kernel, c, bad)
    near = stream(plain, Nudged(disk, INT8_NUDGE, seed=21, keys=nudge_keys))[0]
    f_got, f_ref = flatten(got), flatten(ref)
    err, sens = spread_err(f_got, f_ref), spread_err(flatten(near), f_ref)
    print(f"{what}: kernels vs plain max |delta| / max |value| {err:.3e} (bound {tol:g}), max "
          f"abs diff {np.abs(f_got - f_ref).max():.3e}, max |value| {np.abs(f_ref).max():.3e}"
          f"{detail(got, ref)}; the plain path moves {sens:.3e} with frames and wave changed "
          f"by {INT8_NUDGE:g} (relative); launches {counts}", flush=True)
    if not np.isfinite(f_got).all() or err > tol:
        bad.append(f"{what}: kernels and plain path disagree ({err:.3e})")
    read_planted(planted_in, lambda: flatten(stream(kern, disk)[0]), f_ref, tol, what, bad,
                 faults=faults)
    return ref, got


def stream_rates(what, stream, eng, formats, keys, unit="clips", note=""):
    """Clips/s of `stream` over each (name, dataset) of `formats`, two rounds
    each; `keys` name the arrays staged to the card."""
    for fmt, data in formats:
        staged = BATCH * sum(data[0][k].nbytes for k in keys)
        for rnd in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream(eng, data)
            dt = time.perf_counter() - t0
            print(f"{what} stream: {fmt} ({staged / 1e6:.3f} MB host to device a forward): run "
                  f"{rnd}: {len(data)} {unit} in {dt:.3f} s = {len(data) / dt:.3f} clips/s "
                  f"(B={BATCH}, chunk 2, bf16{note})", flush=True)


def op_group(groups):
    """A profile's host-op groups: every kernel launched under one of the
    profiler ranges `groups` (`annotate`'s labels) goes to that range."""
    def group(e):
        op = e
        while op is not None:
            if op.name in groups:
                return op.name
            op = op.cpu_parent
        return None
    return group


def profile_batch(what, tag, eng, batch, group, ranges=()):
    """One warm `forward_batch(*batch)`, then one under the profiler with
    each (module, name, label) of `ranges` under its range, and its peak
    memory."""
    eng.forward_batch(*batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for module, name, label in ranges:
            stack.enter_context(annotate(module, name, label))
        profile_run(lambda: eng.forward_batch(*batch), what, tag, op_group=group)
    print(f"{tag}: peak memory of the profiled forward "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)


def calibrated(what, calibrate, note):
    """`calibrate()`'s activation scales, timed."""
    t0 = time.perf_counter()
    scales = calibrate()
    print(f"{what} int8: calibrated {len(scales)} activation scales in "
          f"{time.perf_counter() - t0:.3f} s ({note})", flush=True)
    return scales


def serve_int8(what, stream, eng, disk, per_forward, flatten=lambda x: x):
    """`stream` of the int8-towers engine over the decoded items -> its
    result; fails unless the launches are `per_forward` a forward and the
    outputs finite."""
    out = stream(eng, disk)
    want = launches_for(per_forward, len(disk))
    if out[-1] != want or not np.isfinite(flatten(out[0])).all():
        raise AssertionError(f"{what} int8: launches {out[-1]} (expected {want}) or non-finite")
    return out


def check_int8_forward(what, params, state, cfg, towers, scales, forward):
    """Each K4 call of the float32 int8-towers forward `forward(tree, state)`
    (the folded tree quantized with `scales`) against its plain version."""
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
    from dg_sct_tpu_torch.ops import quant

    fp, fs = fold_adapters_eval(params, state, cfg)
    qp = quant.quantize_eval_params(fp, towers=towers, act_scales=scales)
    del fp
    n_calls, kerr = check_int8_calls(qp, towers, lambda t: forward(t, fs), what)
    print(f"{what}: each of the {n_calls} K4 calls of a forward against the plain version on "
          f"its own input: max abs err {kerr:.3e} (must be 0)", flush=True)


def run_avs(device="cuda"):
    """Phase 8: the census-built full-width AVS model served through
    `stream_masks` from an on-disk tree (B=2, chunk=2, bf16), the float32
    engine with kernels against the plain one, clips/s in two wire formats,
    a profiled forward, and int8 towers (in float32 too, each K4 call held
    against its plain version)."""
    import tempfile

    from dg_sct_tpu_torch.configs import AVSModelConfig
    from dg_sct_tpu_torch.data.avs import S4Dataset
    from dg_sct_tpu_torch.models import avs
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVSInferenceEngine

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = AVSModelConfig()
    params, state = import_avs_census_model(cfg)
    eng = AVSInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device=device)
    T, S = cfg.num_frames, cfg.mask_size
    forwards = -(-CLIPS // BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_avs_") as tmp:
        videos = [(f"cat{i % 3}", f"v{i:03d}") for i in range(CLIPS)]
        root = write_avs_tree(Path(tmp), videos, cfg)
        ds = S4Dataset(str(root), "test", mask_num=T, img_size=S, num_frames=T,
                       segment_samples=cfg.htsat.frontend.clip_samples)
        disk = [ds[i] for i in range(len(ds))]  # decoded once; the checks below reuse them
    (masks, metas, counts), dt, peak = serve_timed("avs", stream_all, eng, disk,
                                                   AVS_PER_FORWARD)
    if masks.shape != (CLIPS, T, S, S) or not np.isfinite(masks).all():
        raise AssertionError(f"avs: masks {masks.shape} or non-finite")
    if masks.min() < 0.0 or masks.max() > 1.0:
        raise AssertionError("avs: mask probabilities outside [0, 1]")
    if metas != sorted(videos):
        raise AssertionError(f"avs: metas {metas[:3]}... not in dataset order")
    print(f"avs serve: {CLIPS} clips from disk (PNG frames {S}x{S}, .npy waves {T}x"
          f"{cfg.htsat.frontend.clip_samples}) through stream_masks in {dt:.3f} s (B={BATCH}, "
          f"chunk 2, bf16): masks {masks.shape} finite in [{masks.min():.4f}, {masks.max():.4f}], "
          f"mean {masks.mean():.4f}; metas in dataset order; launches {counts} ({forwards} "
          f"forwards); peak memory {peak / 2**30:.3f} GiB; card "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # float32: the engine with kernels against the plain one on the same clips
    bad = []  # bound checks, fatal at the end of the phase once every reading is printed
    f32 = dict(batch_size=BATCH, chunk=2, device=device, compute_dtype=torch.float32)
    plain = AVSInferenceEngine(cfg, params, state, kernels=False, mask_u8=False, **f32)
    kern = AVSInferenceEngine(cfg, params, state, mask_u8=False, **f32)
    ref, got = f32_against_plain("avs f32", stream_all, plain, kern, disk, AVS_F32_TOL, bad,
                                 per_forward=AVS_PER_FORWARD,
                                 checked=("window_attention", "block_attention"),
                                 planted_in="block_attention", faults=PLANTED)
    u8, _, _ = stream_all(AVSInferenceEngine(cfg, params, state, **f32), disk)
    u8_err = np.abs(u8 - 1.0 / (1.0 + np.exp(-got.astype(np.float64)))).max()
    print(f"avs f32: mask_u8 against sigmoid(logits) max abs diff {u8_err:.6e} (bound "
          f"{MASK_U8_TOL:.6e})", flush=True)
    if u8_err > MASK_U8_TOL:
        bad.append(f"avs: mask_u8 off sigmoid(logits) by {u8_err:.3e}")
    del plain, kern, ref, got, u8

    # clips/s in two wire formats, and a profiled forward
    clips = Clips(AVS_STREAM_CLIPS, cfg, seed=13, size=S, named=True)
    s4 = [disk[i % CLIPS] for i in range(AVS_STREAM_CLIPS)]  # S4Dataset's items, in memory
    stream_rates("avs", stream_all, eng,
                 (("uint8 frames, int16 wave", clips),
                  ("S4Dataset's float32 normalized frames and float32 wave", s4)),
                 ("wave", "image"), note=", uint8 masks")
    one = clips[0]
    profile_batch(f"one AVS forward of {BATCH} clips", "avs profile", eng,
                  (np.stack([one["wave"]] * BATCH), np.stack([one["image"]] * BATCH)),
                  avs_op_group)

    # int8 towers with scales calibrated on a seeded batch
    rs = np.random.RandomState(7)
    cw = torch.as_tensor((rs.randn(BATCH, T, cfg.htsat.frontend.clip_samples) * 0.1).astype(
        np.float32), device=device).to(torch.bfloat16)
    ci = torch.as_tensor(rs.rand(BATCH, T, S, S, 3).astype(np.float32), device=device).to(
        torch.bfloat16)
    scales = calibrated("avs", lambda: quant.calibrate_avs(eng.params, eng.state, eng.cfg, cw, ci,
                                                           gelu=eng.gelu, device=device),
                        f"one plain bf16 forward of {BATCH} clips")
    del eng
    q8 = AVSInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device=device,
                            int8_towers=True, act_scales=scales)
    q_masks, _, counts = serve_int8("avs", stream_all, q8, disk, AVS_INT8_PER_FORWARD)
    agree = float(((q_masks > 0.5) == (masks > 0.5)).mean())
    print(f"avs int8: launches {counts} ({forwards} forwards); drift against bf16 over "
          f"{CLIPS} clips: max |delta prob| {np.abs(q_masks - masks).max():.4f}, mean "
          f"{np.abs(q_masks - masks).mean():.5f}; mask pixels agreeing at 0.5: "
          f"{100.0 * agree:.3f}%", flush=True)
    del q8

    # float32: the int8-towers forward with kernels against the int8 plain one
    fp, fs = fold_adapters_eval(params, state, cfg)
    qp = quant.quantize_eval_params(fp, towers=AVS_INT8_TOWERS, act_scales=scales)
    del params, state
    frames = torch.as_tensor(np.stack([d["image"] for d in disk[:BATCH]]), device=device)
    wave = torch.as_tensor(np.stack([d["wave"] for d in disk[:BATCH]]), device=device)
    gen = torch.Generator(device).manual_seed(3)
    nudge = lambda t: t * (1.0 + INT8_NUDGE * torch.randn(t.shape, device=device, generator=gen))

    def fwd(p, w, f, kernels):
        with torch.inference_mode():
            out = avs.forward(p, fs, f, w, cfg, kernels=kernels, device=device)
        return out["pred"].float().cpu().numpy()

    reset_launch_counts()
    k1_calls = []
    with side_by_side("window_attention", k1_calls):
        got = fwd(qp, wave, frames, True)
    counts = launch_counts()
    report_calls("avs int8 f32", "window_attention", k1_calls, bad)
    if counts != AVS_INT8_PER_FORWARD:
        raise AssertionError(f"avs int8 f32: launches {counts}, expected {AVS_INT8_PER_FORWARD}")
    ref = fwd(qp, wave, frames, False)
    near = [fwd(qp, nudge(wave), nudge(frames), False) for _ in range(2)]
    flt = fwd(fp, wave, frames, False)
    calls, kerr = check_int8_calls(
        qp, AVS_INT8_TOWERS,
        lambda t: avs.forward(t, fs, frames, wave, cfg, kernels=True, device=device),
        "avs int8 f32")
    print(f"avs int8 f32: each of the {calls} K4 calls of a forward against the plain version "
          f"on its own input: max abs err {kerr:.3e} (must be 0)",
          flush=True)
    err = mean_err(got, ref)
    print(f"avs int8 f32: {BATCH} clips, kernels vs plain mean |delta logit| / mean |logit| "
          f"{err:.3e} (bound {AVS_INT8_TOL:g}; max |delta| / max |logit| "
          f"{spread_err(got, ref):.3e}); the plain path moves "
          f"{', '.join(f'{mean_err(n, ref):.3e} ({spread_err(n, ref):.3e})' for n in near)} "
          f"with wave and frames changed by {INT8_NUDGE:g} (relative, two draws); int8 "
          f"against float (plain, f32) {mean_err(ref, flt):.3e} "
          f"({spread_err(ref, flt):.3e}); launches {counts}", flush=True)
    if not np.isfinite(got).all() or err > AVS_INT8_TOL:
        bad.append(f"avs int8 f32: kernels and plain path disagree ({err:.3e})")
    read_planted("window_attention", lambda: fwd(qp, wave, frames, True), ref, AVS_INT8_TOL,
                 "avs int8 f32", bad, stat=mean_err)
    del fp, fs, qp
    torch.cuda.empty_cache()
    print(f"avs: phase 8 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))


# ---------------------------------------------------------------------------
# phase 9: AVS training at full width
# ---------------------------------------------------------------------------

AVS_TRAIN_BATCH = 4    # avs_main's --batch-size: 20 frames and 20 audio clips a mini-step
AVS_TRAIN_LR = 3e-4    # avs_main's --lr
AVS_S4_STEPS = 3
AVS_MS3_STEPS = 2
AVS_MAIN_VIDEOS = {"train": 4, "test": 2}  # the entry point's tree: one mini-step of B=4
NO_LAUNCHES = {name: 0 for name in SOURCES}


def avs_unused_leaf(path) -> bool:
    """Trainable weights the AVS forward never reads, kept for checkpoint
    parity: the head's per-scale decoders (`models/heads/avs.py`), the skip
    unit of path4, which takes no skip (`models/avs.py`), and each AVS
    adapter's ln_before and token_resample (the AVS variant resizes its
    prompts and has no LN before; `models/adapter.py`). Their gradient is
    zero, so Adam leaves them."""
    return ((path[0] == "temporal_attn" and path[3].endswith("_decoder"))
            or (path[0] == "paths" and path[1] == 3 and path[2] == "res1")
            or (path[0] == "adapters" and path[3] in ("ln_before", "token_resample")))


def avs_cancelled_leaf(path) -> bool:
    """TPAVI's W_z bias: a per-channel shift in front of a BN on the batch's
    statistics, which removes it. Its exact gradient is 0, so Adam moves it
    by the sign of a rounding, or not at all."""
    return path[0] == "tpavi" and path[2] == "W_z" and path[-1] == "bias"


def seeded_avs_model(cfg, device="cuda"):
    """Float32 (params, state) from seed 0, with the zero-init scalars that
    would zero their branch's gradient set from seed 1: each visual
    adapter's gate in [0.2, 0.6] and each TPAVI BN scale in [0.5, 1.5]. The
    adapters' gate_av stays zero: the insides of its cross-attention learn
    from the second step on."""
    from dg_sct_tpu_torch.models import avs

    params, state = avs.init_avs_model(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for k in ("v_p1", "v_p2"):
        for ap in params["adapters"][k]:
            ap["gate"] = torch.empty_like(ap["gate"]).uniform_(0.2, 0.6, generator=gen)
    for tp in params["tpavi"].values():
        tp["bn"]["scale"] = torch.empty_like(tp["bn"]["scale"]).uniform_(0.5, 1.5, generator=gen)
    return params, state


def avs_train_batches(cfg, n, seed, device, *, mask_frames):
    """`n` seeded synthetic batches of AVS_TRAIN_BATCH clips at the model's
    widths on `device`; mask_frames 1 (S4) or T (MS3)."""
    from dg_sct_tpu_torch.data.avs import synthetic_batch

    return [{k: torch.as_tensor(v, device=device) for k, v in synthetic_batch(
        AVS_TRAIN_BATCH, img_size=cfg.mask_size, seed=seed + i, mask_frames=mask_frames,
        num_frames=cfg.num_frames, sr=cfg.htsat.frontend.clip_samples).items()}
        for i in range(n)]


def avs_train_op_group(sides):
    """The AVS train profile's host-op groups: every kernel under a
    convolution or its backward (cuDNN), and TPAVI's products, forward and
    backward: the `bmm` calls with an operand of (B, THW, C) or (B, THW,
    THW), THW one of `sides` (no other product of the model has such an
    axis)."""
    def group(e):
        op = e
        while op is not None:
            if op.name in ("aten::convolution", "aten::convolution_backward"):
                return "cuDNN conv"
            op = op.cpu_parent
        if e.name == "aten::bmm" and any(len(s) == 3 and (s[1] in sides or s[2] in sides)
                                         for s in e.input_shapes):
            return "TPAVI products"
        return None
    return group


def tpavi_stage0_memory(params, state, cfg, device):
    """TPAVI's stage-0 block in training on AVS_TRAIN_BATCH clips, alone:
    (bytes held after its forward, for autograd and the outputs; its
    forward's peak), both above what was resident before it."""
    from dg_sct_tpu_torch.models import tpavi as TP

    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    T, S, C = cfg.num_frames, cfg.scale_sizes[0], cfg.channel
    x = torch.randn((AVS_TRAIN_BATCH, T, S, S, C), device=device, generator=gen,
                    requires_grad=True)
    audio = torch.randn((AVS_TRAIN_BATCH, T, C // 2), device=device, generator=gen)
    tp = {k: {n: t.detach().requires_grad_() for n, t in v.items()}
          for k, v in params["tpavi"]["tpavi_b1"].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = TP.tpavi(tp, state["tpavi"]["tpavi_b1"], x, audio, train=True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return held, peak


def avs_main_once(cfg, tmp):
    """`avs_main.main` in train mode, S4, one epoch, on the card by default,
    over a tree of AVS_MAIN_VIDEOS videos a split -> (result, s4_best.npz's
    bytes, the printed test line, seconds)."""
    import contextlib
    import io

    from dg_sct_tpu_torch.train import avs_main

    root = Path(tmp)
    for i, (split, n) in enumerate(AVS_MAIN_VIDEOS.items()):
        write_avs_tree(root, [(f"cat{j % 2}", f"{split}{j:03d}") for j in range(n)], cfg,
                       seed=50 + i, split=split)
    save = root / "ckpt"
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        result = avs_main.main(["--mode", "train", "--task", "s4", "--epochs", "1",
                                "--batch-size", str(AVS_TRAIN_BATCH), "--root", str(root),
                                "--save-dir", str(save)], cfg=cfg)
    dt = time.perf_counter() - t0
    best = save / "s4_best.npz"
    tests = [ln for ln in log.getvalue().splitlines() if ln.startswith("test mIoU:")]
    if (not best.exists() or result is None or len(tests) != 1
            or not all(0.0 <= result[k] <= 1.0 for k in ("miou", "f_score"))):
        raise AssertionError(f"avs main: no s4_best.npz, or no test report in range: {result}, "
                             f"{log.getvalue()[-500:]}")
    return result, best.stat().st_size, tests[0], dt


def run_avs_training(cfg=None, device="cuda"):
    """Phase 9: `cfg` (None: the full-width AVSModelConfig()) trained in float32 at the recipe's
    step (B=4 clips, accum 1, Adam at 3e-4, remat "full"): AVS_S4_STEPS S4
    mini-steps with a generator, the checks of each; AVS_MS3_STEPS MS3
    mini-steps; a mini-step with remat "none"; TPAVI stage 0's memory; a
    profiled mini-step; the eval step; the saved train state served by a
    bf16 engine; the entry point once."""
    import tempfile

    from dg_sct_tpu_torch.configs import AVSModelConfig, TrainConfig
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVSInferenceEngine
    from dg_sct_tpu_torch.train import avs_train
    from dg_sct_tpu_torch.utils import checkpoint as ckpt
    from dg_sct_tpu_torch.utils.tree import tree_paths
    from dg_sct_tpu_torch.weights import from_jax

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = cfg or AVSModelConfig()
    params, state = seeded_avs_model(cfg, device)
    tr, fr = avs_train.partition_params(params)
    p0 = {p: t.cpu() for p, t in tree_paths(params)}  # on the host: not in the peak
    s0 = {p: t.cpu() for p, t in tree_paths(state)}
    del params
    tcfg = TrainConfig(batch_size=AVS_TRAIN_BATCH, lr=AVS_TRAIN_LR, accum_steps=1)
    opt = avs_train.make_optimizer(tr, tcfg, steps_per_epoch=1)
    opt_state = opt.init(tr)
    step = avs_train.make_train_step(cfg, opt, task="s4", device=device, remat_policy="full")
    batches = avs_train_batches(cfg, AVS_S4_STEPS, seed=40, device=device, mask_frames=1)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    print(f"avs train: {'AVSModelConfig()' if cfg == AVSModelConfig() else cfg} in float32, "
          f"TF32 off; seed 0, visual adapter gates and "
          f"TPAVI BN scales set from seed 1; B={AVS_TRAIN_BATCH} clips "
          f"({AVS_TRAIN_BATCH * cfg.num_frames} frames and audio clips), accum 1, Adam at "
          f"{AVS_TRAIN_LR:g}, remat full", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for i in range(AVS_S4_STEPS):
        (tr, state, opt_state, m), dt = timed_step(step, (tr, fr, state, opt_state, batches[i],
                                                          gen))
        times.append(dt)
        loss = float(m["loss"])
        print(f"avs train: S4 mini-step {i + 1}: loss {loss:.4f}, {dt:.3f} s", flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"avs train: S4 mini-step {i + 1}: the loss is not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = launch_counts()
    if counts != NO_LAUNCHES:
        raise AssertionError(f"avs train: the train steps launched kernels {counts}")
    now = dict(tree_paths(avs_train.merge_params(tr, fr)))
    same = {p: torch.equal(now[p].cpu(), p0[p]) for p in p0}
    frozen = [p for p in same if p[0] in ("swin", "htsat")]
    trained = [p for p in same if p[0] not in ("swin", "htsat")]
    cancelled = [p for p in trained if avs_cancelled_leaf(p)]
    bad = ([p for p in frozen if not same[p]]
           + [p for p in trained if not avs_cancelled_leaf(p) and same[p] != avs_unused_leaf(p)])
    if bad:
        raise AssertionError(f"avs train: after {AVS_S4_STEPS} mini-steps, leaves against the "
                             f"rule: {bad[:5]}")
    bn = [(p, t) for p, t in tree_paths(state) if p[-1] in ("mean", "var")]
    still = [p for p, t in bn if torch.equal(t.cpu(), s0[p])]
    counts_bn = {int(t) for p, t in tree_paths(state) if p[-1] == "count"}
    if still or counts_bn != {AVS_S4_STEPS} or len(bn) != 2 * (1 + len(cfg.tpavi_stages)):
        raise AssertionError(f"avs train: BN state did not move: {still[:3]}, counts {counts_bn}")
    print(f"avs train: {AVS_S4_STEPS} S4 mini-steps: " + ", ".join(f"{t:.3f}" for t in times)
          + f" s; peak memory {peak:.3f} GiB; {sum(not same[p] for p in trained)} trainable leaves "
          f"changed, {sum(avs_unused_leaf(p) for p in trained)} unused ones and {len(frozen)} "
          f"frozen ones bit-identical, {sum(not same[p] for p in cancelled)} of the "
          f"{len(cancelled)} TPAVI W_z biases moved (exact gradient 0); {len(bn)} BN stats of bn0 "
          f"and TPAVI moved, counts {AVS_S4_STEPS}; kernel launches {counts}; card "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    del p0, s0, now

    # MS3: every frame's BCE and the KL term on the 4 TPAVI stages
    ms3_opt = avs_train.make_optimizer(tr, tcfg, steps_per_epoch=1)
    ms3_state = ms3_opt.init(tr)
    ms3 = avs_train.make_train_step(cfg, ms3_opt, task="ms3", device=device)
    ms3_batches = avs_train_batches(cfg, AVS_MS3_STEPS, seed=60, device=device,
                                    mask_frames=cfg.num_frames)
    torch.cuda.reset_peak_memory_stats()
    mtr, mstate, ms3_times, ms3_losses = tr, state, [], []
    for i in range(AVS_MS3_STEPS):
        (mtr, mstate, ms3_state, m), dt = timed_step(ms3, (mtr, fr, mstate, ms3_state,
                                                           ms3_batches[i], gen))
        ms3_times.append(dt)
        ms3_losses.append(float(m["loss"]))
    if not all(math.isfinite(v) for v in ms3_losses):
        raise AssertionError(f"avs train: MS3 losses {ms3_losses}")
    print(f"avs train: {AVS_MS3_STEPS} MS3 mini-steps (KL on stages {list(cfg.tpavi_stages)}): "
          f"losses {', '.join(f'{v:.4f}' for v in ms3_losses)}; "
          + ", ".join(f"{t:.3f}" for t in ms3_times)
          + f" s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del mtr, mstate, ms3_state, ms3_opt, ms3, ms3_batches

    held, tp_peak = tpavi_stage0_memory(avs_train.merge_params(tr, fr), state, cfg, device)
    n = cfg.num_frames * cfg.scale_sizes[0] ** 2
    print(f"avs train: TPAVI stage 0 alone in training, B={AVS_TRAIN_BATCH} (THW {n}; f is "
          f"{AVS_TRAIN_BATCH * n * n * 4 / 2**30:.3f} GiB in float32): "
          f"{held / 2**30:.3f} GiB held after its forward, forward peak {tp_peak / 2**30:.3f} GiB "
          f"above resident", flush=True)

    none = avs_train.make_train_step(cfg, opt, task="s4", device=device, remat_policy="none")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (_, _, _, m), dt = timed_step(none, (tr, fr, state, opt_state, batches[0],
                                         torch.Generator(device=device).manual_seed(5)))
    if not math.isfinite(float(m["loss"])):
        raise AssertionError("avs train remat none: the loss is not finite")
    print(f"avs train remat none: one S4 mini-step of B={AVS_TRAIN_BATCH} clips in {dt:.3f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del none

    sides = {cfg.num_frames * s * s for s in cfg.scale_sizes}
    groups = profile_run(lambda: step(tr, fr, state, opt_state, batches[0], gen),
                         f"one S4 mini-step of {AVS_TRAIN_BATCH} clips, remat full",
                         "avs train profile", op_group=avs_train_op_group(sides),
                         record_shapes=True)
    # the profiler's host-op records slow the host several times over, so the
    # idle share of the profiled span overstates the card's idle time
    unprofiled = float(np.median(times[1:]))
    print(f"avs train profile: {sum(groups.values()):.3f} ms of device time against the "
          f"unprofiled mini-steps' median {unprofiled:.3f} s: "
          f"{100.0 * (1.0 - sum(groups.values()) / 1e3 / unprofiled):.1f}% idle", flush=True)

    estep = avs_train.make_eval_step(cfg, device=device)
    reset_launch_counts()
    probs = estep(tr, fr, state, batches[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    shape = (AVS_TRAIN_BATCH * cfg.num_frames, cfg.mask_size, cfg.mask_size, 1)
    if (counts != AVS_PER_FORWARD or tuple(probs.shape) != shape
            or not bool(torch.isfinite(probs).all()) or probs.min() < 0 or probs.max() > 1):
        raise AssertionError(f"avs train eval step: launches {counts} (expected "
                             f"{AVS_PER_FORWARD}), masks {tuple(probs.shape)} or outside [0, 1]")
    print(f"avs train eval step: B={AVS_TRAIN_BATCH}, float32, masks {tuple(probs.shape)} in "
          f"[{float(probs.min()):.4f}, {float(probs.max()):.4f}], launches {counts}", flush=True)
    del probs, batches, step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_avs_train_") as tmp:
        path = str(Path(tmp) / "s4_best.npz")
        t0 = time.perf_counter()
        ckpt.save_train_state(path, params=avs_train.merge_params(tr, fr), state=state,
                              opt_state=opt_state, rng_state=gen.get_state(),
                              step=opt_state["gradient_step"])
        size = Path(path).stat().st_size
        lp, ls = ckpt.load_params_and_state(path)
        dt = time.perf_counter() - t0
    del tr, fr, state, opt_state, opt
    torch.cuda.empty_cache()
    eng = AVSInferenceEngine(cfg, *from_jax(lp, ls, cfg, device=device), batch_size=BATCH,
                             device=device)
    del lp, ls
    rs = np.random.RandomState(31)
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.mask_size
    wave = (np.clip(0.3 * rs.randn(BATCH, T, L), -1, 1) * 32767).astype(np.int16)
    frames = rs.randint(0, 256, (BATCH, T, S, S, 3), dtype=np.uint8)
    reset_launch_counts()
    masks = eng.forward_batch(wave, frames).cpu()
    counts = launch_counts()
    if counts != AVS_PER_FORWARD or tuple(masks.shape) != (BATCH * T, S, S):
        raise AssertionError(f"avs train serve: launches {counts} (expected {AVS_PER_FORWARD}) "
                             f"or masks {tuple(masks.shape)}")
    print(f"avs train serve: train state of {size / 1e9:.3f} GB saved and read in {dt:.1f} s; a "
          f"bf16 AVSInferenceEngine on it answers {BATCH} clips: uint8 masks "
          f"{tuple(masks.shape)}, mean {float(masks.float().mean()) / 255:.4f}, launches {counts}",
          flush=True)
    del eng
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_avs_main_") as tmp:
        result, size, test_line, dt = avs_main_once(cfg, tmp)
    print(f"avs main: avs_main.main(--mode train --task s4 --epochs 1 --batch-size "
          f"{AVS_TRAIN_BATCH}) over {AVS_MAIN_VIDEOS} videos on disk, on the card by default, in "
          f"{dt:.1f} s: s4_best.npz of {size / 1e9:.3f} GB saved; {test_line}", flush=True)
    torch.cuda.empty_cache()
    print(f"avs train: phase 9 in {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 10: AVVP serving at full width
# ---------------------------------------------------------------------------

AVVP_CENSUS = Path(__file__).resolve().parent / "tests" / "golden" / "census_avvp_mgn.json"
# the AVE adapters and towers: AVVP's take K3 too
AVVP_PER_FORWARD = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 48,
                    "int8_linear": 0, "int8_quantize": 0}
AVVP_INT8_PER_FORWARD = {"window_attention": 34, "block_attention": 2, "adapter_bottleneck": 48,
                         "int8_linear": 142, "int8_quantize": 142}
AVVP_SEGMENT = 32000      # LLPDataset's wave: 1 s of 32 kHz audio a segment
AVVP_STREAM_CLIPS = 16
AVVP_INT8_TOWERS = ("swin", "htsat")  # what the AVVP engine's int8_towers quantizes
# the f32 engine with kernels against the plain one, max |delta| over max
# |value| of the five outputs together: above the plain path's own move
# under a 1e-6 relative change of its inputs and the sound kernels' reading
# (printed beside), below the readings of the faults K3_PLANTED in front of
# K3 (readings in PERF.md, section 6, PR 11)
AVVP_F32_TOL = 5e-4
# known faults put in front of K3, on its down weights (g, C/g, go): as a
# float32 kernel that staged them in bf16 would see them, and with the two
# channel groups' weights swapped, as a kernel that indexed the groups wrong
K3_PLANTED = {"down weights rounded to bf16": lambda w: w.to(torch.bfloat16).to(w.dtype),
              "down weights' groups swapped": lambda w: w.flip(0).contiguous()}
K123 = ("window_attention", "block_attention", "adapter_bottleneck")  # held side by side
AVVP_OUTPUTS = ("global_prob", "a_prob", "v_prob", "a_frame_prob", "v_frame_prob")


def write_llp_tree(root, videos, cfg, seed=0):
    """An LLP tree: T JPEG frames at the towers' size a video, a float32 wave
    of T x AVVP_SEGMENT, r2plus1d features (T, 512), and the label and
    annotation csvs (every split lists every video)."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    T, S = cfg.num_frames, cfg.swin.img_size
    for d in ("frames", "audio", "st"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for vid in videos:
        (root / "frames" / vid).mkdir()
        for t in range(T):
            Image.fromarray(rs.randint(0, 256, (S, S, 3), dtype=np.uint8)).save(
                root / "frames" / vid / f"{t:08d}.jpg", quality=90)
        np.save(root / "audio" / f"{vid}.npy",
                np.clip(0.3 * rs.randn(T * AVVP_SEGMENT), -1, 1).astype(np.float32))
        np.save(root / "st" / f"{vid}.npy", rs.randn(T, 512).astype(np.float32))
    return write_llp_csvs(root, videos)


def write_llp_csvs(root, videos):
    """LLP's label and annotation csvs: every split lists every video."""
    cats = ["Speech", "Dog", "Cello", "Singing", "Car"]
    labels, events = ["filename\tevent_labels"], ["filename\tonset\toffset\tevent_labels"]
    for i, vid in enumerate(videos):
        labels.append(f"{vid}\t{cats[i % 5]},{cats[(i + 2) % 5]}")
        events.append(f"{vid}\t{i % 4}\t{i % 4 + 3}\t{cats[i % 5]}")
    for name in ("AVVP_train.csv", "AVVP_val_pd.csv", "AVVP_test_pd.csv"):
        (root / name).write_text("\n".join(labels) + "\n")
    for name in ("AVVP_eval_audio.csv", "AVVP_eval_visual.csv"):
        (root / name).write_text("\n".join(events) + "\n")
    return root


def llp_dataset(root, cfg):
    from dg_sct_tpu_torch.data.avvp import LLPDataset

    return LLPDataset(str(root / "AVVP_test_pd.csv"), frame_dir=str(root / "frames"),
                      audio_dir=str(root / "audio"), st_dir=str(root / "st"),
                      img_size=cfg.swin.img_size, num_frames=cfg.num_frames,
                      segment_samples=AVVP_SEGMENT)


class LLPClips:
    """Seeded full-width LLP clips in memory in the serving wire format: an
    int16 wave of T x AVVP_SEGMENT, uint8 frames, float32 r2plus1d features."""

    def __init__(self, n, cfg, seed):
        rs = np.random.RandomState(seed)
        T, S = cfg.num_frames, cfg.swin.img_size
        self.wave = (np.clip(0.3 * rs.randn(n, T, AVVP_SEGMENT), -1, 1) * 32767).astype(np.int16)
        self.frames = rs.randint(0, 256, (n, T, S, S, 3), dtype=np.uint8)
        self.st = rs.randn(n, T, 512).astype(np.float32)

    def __len__(self):
        return len(self.wave)

    def __getitem__(self, i):
        return {"wave": self.wave[i], "image": self.frames[i], "video_st": self.st[i],
                "video": f"mem{i:08d}"}


def stream_probs_all(eng, ds):
    """stream_probs over the whole dataset -> ({output: (n, ...)}, video ids,
    launch counts)."""
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = list(eng.stream_probs(ds))
    return ({k: np.concatenate([p[k] for p, _ in out]) for k in AVVP_OUTPUTS},
            [v for _, vids in out for v in vids], launch_counts())


def flat(probs):
    return np.concatenate([probs[k].ravel() for k in AVVP_OUTPUTS])


def han_logits(logits):
    """Within the block, the logits of every hard assignment (the HAN's, in
    the default soft configuration) go to `logits`, on the card."""
    from dg_sct_tpu_torch.models import grouping

    def wrap(real):
        def recorded(x, axis):
            logits.append(x.detach().float().movedim(axis, -1))
            return real(x, axis)
        return recorded

    return patched(grouping, "hard_softmax", wrap)


def han_margin(plain, kern):
    """(smallest top-1/top-2 logit gap of the plain path's HAN assignments,
    largest |logit| change the kernels made, rows whose argmax flipped)."""
    p = torch.cat([x.reshape(-1, x.shape[-1]) for x in plain])
    k = torch.cat([x.reshape(-1, x.shape[-1]) for x in kern])
    top2 = p.topk(2, dim=-1).values
    return (float((top2[:, 0] - top2[:, 1]).min()), float((k - p).abs().max()),
            int((p.argmax(-1) != k.argmax(-1)).sum()))


def annotate(module, name, label):
    """Within the block, each call of `module.name` runs under a profiler
    range `label` (a host-op group of `profile_run`)."""
    RANGES.add(label)

    def wrap(real):
        def ranged(*args, **kw):
            with torch.profiler.record_function(label):
                return real(*args, **kw)
        return ranged

    return patched(module, name, wrap)


AVVP_HEAD_GROUPS = ("AVVP grouping heads", "AVVP temporal gates")


def import_avvp_census_model(cfg):
    """The AVVP census state dict through the port's import path: converter,
    key census (0 unexplained), `from_jax` onto the card."""
    from dg_sct_tpu_torch.utils import torch_convert as TC

    t0 = time.perf_counter()
    params, state, _, line = census_import("avvp import", AVVP_CENSUS, TC.convert_avvp_model,
                                           TC.AVVP_CKPT_IGNORED_PATTERNS, cfg)
    tokens = [float(params[k].abs().mean()) for k in ("audio_token", "visual_token")]
    print(f"{line}; class tokens from the seed, mean |value| {tokens[0]:.4f} / "
          f"{tokens[1]:.4f}; on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    return params, state


def run_avvp(device="cuda"):
    """Phase 10: the census-built full-width AVVP model served through
    `stream_probs` from an on-disk LLP tree (B=2, chunk=2, bf16), the float32
    engine with kernels against the plain one (each K1, K2 and K3 call
    against its plain version, the HAN's margin, faults planted in front of
    K3), clips/s in two wire formats, a profiled forward, and int8 towers
    (each K4 call of a float32 int8 forward against its plain version)."""
    import tempfile

    from dg_sct_tpu_torch.configs import AVVPModelConfig
    from dg_sct_tpu_torch.models import avvp, grouping
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.serve import AVVPInferenceEngine

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = AVVPModelConfig()
    params, state = import_avvp_census_model(cfg)
    eng = AVVPInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device=device)
    check_folded(eng, "avvp")
    T, n_cls = cfg.num_frames, cfg.num_classes
    forwards = -(-CLIPS // BATCH)
    videos = [f"llp{i:08d}" for i in range(CLIPS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_avvp_") as tmp:
        ds = llp_dataset(write_llp_tree(Path(tmp), videos, cfg), cfg)
        disk = [ds[i] for i in range(len(ds))]  # decoded once; the checks below reuse them
    (probs, vids, counts), dt, peak = serve_timed("avvp", stream_probs_all, eng, disk,
                                                  AVVP_PER_FORWARD)
    shapes = {k: v.shape for k, v in probs.items()}
    if (shapes != {"global_prob": (CLIPS, n_cls), "a_prob": (CLIPS, n_cls),
                   "v_prob": (CLIPS, n_cls), "a_frame_prob": (CLIPS, T, n_cls),
                   "v_frame_prob": (CLIPS, T, n_cls)}
            or not all(np.isfinite(v).all() for v in probs.values())):
        raise AssertionError(f"avvp: outputs {shapes} or non-finite")
    clip = np.concatenate([probs[k].ravel() for k in ("global_prob", "a_prob", "v_prob")])
    frame = np.concatenate([probs[k].ravel() for k in ("a_frame_prob", "v_frame_prob")])
    # a frame probability is a clip's sigmoid times 1 + a softmax: in [0, 2]
    if clip.min() < 0 or clip.max() > 1 or frame.min() < 0 or frame.max() > 2:
        raise AssertionError("avvp: probabilities out of range")
    if vids != videos:
        raise AssertionError(f"avvp: video ids {vids[:3]}... not in dataset order")
    print(f"avvp serve: {CLIPS} clips from disk (JPEG frames {cfg.swin.img_size}, .npy waves "
          f"{T}x{AVVP_SEGMENT}, st (10, 512)) through stream_probs in {dt:.3f} s (B={BATCH}, "
          f"chunk 2, bf16): clip probabilities (7, 25) in [{clip.min():.4f}, {clip.max():.4f}], "
          f"frame probabilities (7, 10, 25) in [{frame.min():.4f}, {frame.max():.4f}]; ids in "
          f"dataset order; launches {counts} ({forwards} forwards); peak memory "
          f"{peak / 2**30:.3f} GiB; card {torch.cuda.get_device_name(0)}", flush=True)

    # float32: the engine with kernels against the plain one on the same clips
    bad = []  # bound checks, fatal at the end of the phase once every reading is printed
    f32 = dict(batch_size=BATCH, chunk=2, device=device, compute_dtype=torch.float32)
    plain = AVVPInferenceEngine(cfg, params, state, kernels=False, **f32)
    kern = AVVPInferenceEngine(cfg, params, state, **f32)
    plain_han, kern_han = [], []
    f32_against_plain(
        "avvp f32", stream_probs_all, plain, kern, disk, AVVP_F32_TOL, bad,
        per_forward=AVVP_PER_FORWARD, checked=K123, planted_in="adapter_bottleneck",
        faults=K3_PLANTED, flatten=flat, hooks=(han_logits(plain_han), han_logits(kern_han)),
        detail=lambda got, ref: ", per output " + ", ".join(
            f"{k} {np.abs(got[k] - ref[k]).max():.3e}" for k in AVVP_OUTPUTS))
    margin, moved, flips = han_margin(plain_han, kern_han)
    print(f"avvp f32: HAN hard assignment over {len(plain_han)} calls: smallest top-1/top-2 "
          f"logit gap {margin:.3e} against the kernels' largest logit change {moved:.3e} (a "
          f"flip needs the change to reach half the gap: bound {margin / 2:.3e}); rows whose "
          f"argmax flipped: {flips}", flush=True)
    if flips:
        bad.append(f"avvp f32: the HAN's argmax flipped in {flips} rows between kernels and plain")
    del plain, kern

    # clips/s in two wire formats, and a profiled forward
    clips = LLPClips(AVVP_STREAM_CLIPS, cfg, seed=13)
    llp = [disk[i % CLIPS] for i in range(AVVP_STREAM_CLIPS)]  # LLPDataset's items, in memory
    stream_rates("avvp", stream_probs_all, eng,
                 (("uint8 frames, int16 wave", clips),
                  ("LLPDataset's float32 normalized frames and float32 wave", llp)),
                 ("wave", "image", "video_st"))
    profile_batch(f"one AVVP forward of {BATCH} clips", "avvp profile", eng,
                  tuple(np.stack([clips[0][k]] * BATCH) for k in ("wave", "image", "video_st")),
                  op_group(AVVP_HEAD_GROUPS),
                  ((grouping, "modality_trans", AVVP_HEAD_GROUPS[0]),
                   (avvp, "slim_temporal_attention", AVVP_HEAD_GROUPS[1])))

    # int8 towers with scales calibrated on a seeded batch
    rs = np.random.RandomState(7)
    on_card = lambda a: torch.as_tensor(a, device=device).to(torch.bfloat16)
    cw = on_card((rs.randn(BATCH, T, AVVP_SEGMENT) * 0.1).astype(np.float32))
    ci = on_card(rs.rand(BATCH, T, cfg.swin.img_size, cfg.swin.img_size, 3).astype(np.float32))
    cst = on_card(rs.randn(BATCH, T, 512).astype(np.float32))
    scales = calibrated("avvp", lambda: quant.calibrate_avvp(eng.params, eng.state, eng.cfg, cw,
                                                             ci, cst, gelu=eng.gelu,
                                                             device=device),
                        f"one plain bf16 forward of {BATCH} clips")
    del eng
    q8 = AVVPInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device=device,
                             int8_towers=True, act_scales=scales)
    q_probs, _, counts = serve_int8("avvp", stream_probs_all, q8, disk, AVVP_INT8_PER_FORWARD,
                                    flatten=flat)
    agree = float(((q_probs["global_prob"] >= 0.5) == (probs["global_prob"] >= 0.5)).mean())
    print(f"avvp int8: launches {counts} ({forwards} forwards); drift against bf16 over {CLIPS} "
          f"clips, max |delta|: " + ", ".join(f"{k} {np.abs(q_probs[k] - probs[k]).max():.4f}"
                                               for k in AVVP_OUTPUTS)
          + f"; clip-level decisions (global_prob >= 0.5) agreeing: {100.0 * agree:.2f}%",
          flush=True)
    del q8

    # float32: each K4 call of the int8-towers forward against its plain version
    item = lambda k: torch.as_tensor(np.stack([d[k] for d in disk[:BATCH]]), device=device)
    wave, frames, st = item("wave"), item("image"), item("video_st")
    check_int8_forward("avvp int8 f32", params, state, cfg, AVVP_INT8_TOWERS, scales,
                       lambda t, fs: avvp.forward(t, fs, wave, frames, st, cfg, kernels=True,
                                                  device=device))
    del params, state
    torch.cuda.empty_cache()
    print(f"avvp: phase 10 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))


# ---------------------------------------------------------------------------
# phase 11: AVVP training at full width
# ---------------------------------------------------------------------------

AVVP_TRAIN_BATCH = 8     # avvp_main's --batch-size: 80 frames and 80 audio clips a mini-step
AVVP_TRAIN_LR = 5e-4     # avvp_main's --lr
AVVP_TRAIN_STEPS = 3
AVVP_NONE_BATCH = 2      # remat "none": float32 B=8 would not fit in 80 GB
AVVP_MAIN_VIDEOS = 8     # the entry point's tree: one mini-step of B=8, 8 videos scored


def seeded_avvp_model(cfg, device="cuda"):
    """Float32 (params, state) from seed 0 with the zero-init leaves that
    would zero their branch set from seed 1: each adapter's gate and gate_av
    in [0.2, 0.6], and the class tokens N(0, 0.5^2)."""
    from dg_sct_tpu_torch.models import avvp
    from dg_sct_tpu_torch.models.interleave import ADKEYS

    params, state = avvp.init_avvp_model(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for k in ADKEYS:
        for ap in params["adapters"][k]:
            for g in ("gate", "gate_av"):
                ap[g] = torch.empty_like(ap[g]).uniform_(0.2, 0.6, generator=gen)
    for k in ("audio_token", "visual_token"):
        params[k] = 0.5 * torch.randn(params[k].shape, device=device, generator=gen)
    return params, state


def avvp_train_batches(cfg, n, batch, seed, device):
    """`n` seeded synthetic batches of `batch` LLP clips (waves of
    AVVP_SEGMENT a segment) on `device`."""
    from dg_sct_tpu_torch.data.avvp import synthetic_batch

    return [{k: torch.as_tensor(v, device=device) for k, v in synthetic_batch(
        batch, img_size=cfg.swin.img_size, seed=seed + i, num_frames=cfg.num_frames,
        sr=AVVP_SEGMENT).items()} for i in range(n)]


def avvp_main_once(cfg, tmp):
    """`avvp_main.main` in train mode, one epoch, on the card by default, over
    a tree of AVVP_MAIN_VIDEOS videos -> (test summary, MGN_Net.npz's path,
    seconds)."""
    import contextlib
    import io

    from dg_sct_tpu_torch.train import avvp_main

    root = write_llp_tree(Path(tmp), [f"trn{i:08d}" for i in range(AVVP_MAIN_VIDEOS)], cfg,
                          seed=50)
    save = root / "ckpt"
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        summary = avvp_main.main(
            ["--mode", "train", "--epochs", "1", "--batch-size", str(AVVP_TRAIN_BATCH),
             "--label-train", str(root / "AVVP_train.csv"),
             "--label-val", str(root / "AVVP_val_pd.csv"),
             "--label-test", str(root / "AVVP_test_pd.csv"), "--eval-csv-dir", str(root),
             "--frames", str(root / "frames"), "--audio", str(root / "audio"),
             "--st", str(root / "st"), "--save-dir", str(save)], cfg=cfg)
    dt = time.perf_counter() - t0
    best = save / "MGN_Net.npz"
    if (not best.exists() or not summary
            or not all(0.0 <= v <= 100.0 for v in summary.values())):
        raise AssertionError(f"avvp main: no MGN_Net.npz, or no test report in range: {summary}, "
                             f"{log.getvalue()[-500:]}")
    return summary, best, dt


def run_avvp_training(cfg=None, device="cuda"):
    """Phase 11: `cfg` (None: the full-width AVVPModelConfig()) trained in
    float32 at the recipe's step (B=8 clips, accum 1, Adam at 5e-4, remat
    "full"): AVVP_TRAIN_STEPS mini-steps with a generator, the checks of
    each; a profiled mini-step; a mini-step with remat "none" at B=2; the eval
    step; the entry point once, and its saved train state served by a bf16
    engine."""
    import tempfile

    from dg_sct_tpu_torch.configs import AVVPModelConfig, TrainConfig
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVVPInferenceEngine
    from dg_sct_tpu_torch.train import avvp_train
    from dg_sct_tpu_torch.utils import checkpoint as ckpt
    from dg_sct_tpu_torch.utils.tree import tree_paths
    from dg_sct_tpu_torch.weights import from_jax

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = cfg or AVVPModelConfig()
    params, state = seeded_avvp_model(cfg, device)
    tr, fr = avvp_train.partition_params(params)
    p0 = {p: t.cpu() for p, t in tree_paths(params)}  # on the host: not in the peak
    s0 = {p: t.cpu() for p, t in tree_paths(state)}
    del params
    tcfg = TrainConfig(batch_size=AVVP_TRAIN_BATCH, lr=AVVP_TRAIN_LR, accum_steps=1)
    opt = avvp_train.make_optimizer(tr, tcfg, steps_per_epoch=1)
    opt_state = opt.init(tr)
    step = avvp_train.make_train_step(cfg, opt, device=device, remat_policy="full")
    batches = avvp_train_batches(cfg, AVVP_TRAIN_STEPS, AVVP_TRAIN_BATCH, seed=40, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    n_train = sum(t.numel() for _, t in tree_paths(tr))
    print(f"avvp train: {'AVVPModelConfig()' if cfg == AVVPModelConfig() else cfg} in float32, "
          f"TF32 off; seed 0, adapter gates and class tokens set from seed 1; "
          f"B={AVVP_TRAIN_BATCH} clips ({AVVP_TRAIN_BATCH * cfg.num_frames} frames and audio "
          f"clips of {AVVP_SEGMENT} samples), accum 1, Adam at {AVVP_TRAIN_LR:g}, remat full; "
          f"{n_train / 1e6:.1f} M trainable parameters", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for i in range(AVVP_TRAIN_STEPS):
        (tr, state, opt_state, m), dt = timed_step(step, (tr, fr, state, opt_state, batches[i],
                                                          gen))
        times.append(dt)
        loss = float(m["loss"])
        print(f"avvp train: mini-step {i + 1}: loss {loss:.4f}, {dt:.3f} s", flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"avvp train: mini-step {i + 1}: the loss is not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = launch_counts()
    if counts != NO_LAUNCHES:
        raise AssertionError(f"avvp train: the train steps launched kernels {counts}")
    now = dict(tree_paths(avvp_train.merge_params(tr, fr)))
    same = {p: torch.equal(now[p].cpu(), p0[p]) for p in p0}
    frozen = [p for p in same if p[0] in ("swin", "htsat")]
    trained = [p for p in same if p[0] not in ("swin", "htsat")]
    # the AVVP forward reads every trainable leaf, so every one must move
    unmoved = [p for p in trained if same[p]]
    if unmoved or not all(same[p] for p in frozen):
        raise AssertionError(f"avvp train: after {AVVP_TRAIN_STEPS} mini-steps, unmoved trainable "
                             f"leaves {unmoved[:5]} or a frozen leaf changed")
    bn = [(p, t) for p, t in tree_paths(state) if p[-1] in ("mean", "var")]
    still = [p for p, t in bn if torch.equal(t.cpu(), s0[p])]
    counts_bn = {int(t) for p, t in tree_paths(state) if p[-1] == "count"}
    if still or counts_bn != {AVVP_TRAIN_STEPS}:
        raise AssertionError(f"avvp train: BN state did not move: {still[:3]}, counts {counts_bn}")
    print(f"avvp train: {AVVP_TRAIN_STEPS} mini-steps: " + ", ".join(f"{t:.3f}" for t in times)
          + f" s; peak memory {peak:.3f} GiB; all {len(trained)} trainable leaves changed (the "
          f"forward reads each; unmoved: {len(unmoved)}), {len(frozen)} frozen ones "
          f"bit-identical; {len(bn)} BN stats of bn0 and the adapters moved, counts "
          f"{AVVP_TRAIN_STEPS}; kernel launches {counts}; card {torch.cuda.get_device_name(0)}",
          flush=True)
    del p0, s0, now

    groups = profile_run(lambda: step(tr, fr, state, opt_state, batches[0], gen),
                         f"one mini-step of {AVVP_TRAIN_BATCH} clips, remat full",
                         "avvp train profile", host_ops=False)
    unprofiled = float(np.median(times[1:]))
    print(f"avvp train profile: {sum(groups.values()):.3f} ms of device time against the "
          f"unprofiled mini-steps' median {unprofiled:.3f} s: "
          f"{100.0 * (1.0 - sum(groups.values()) / 1e3 / unprofiled):.1f}% idle", flush=True)

    none = avvp_train.make_train_step(cfg, opt, device=device, remat_policy="none")
    small = {k: v[:AVVP_NONE_BATCH] for k, v in batches[0].items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (_, _, _, m), dt = timed_step(none, (tr, fr, state, opt_state, small,
                                         torch.Generator(device=device).manual_seed(5)))
    if not math.isfinite(float(m["loss"])):
        raise AssertionError("avvp train remat none: the loss is not finite")
    print(f"avvp train remat none: one mini-step of B={AVVP_NONE_BATCH} clips in {dt:.3f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del none, small

    estep = avvp_train.make_eval_step(cfg, device=device)
    reset_launch_counts()
    out = estep(tr, fr, state, batches[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != EVAL_LAUNCHES or not all(bool(torch.isfinite(v).all()) for v in out.values()):
        raise AssertionError(f"avvp train eval step: launches {counts} (expected "
                             f"{EVAL_LAUNCHES}) or non-finite outputs")
    print(f"avvp train eval step: B={AVVP_TRAIN_BATCH}, float32, global_prob in "
          f"[{float(out['global_prob'].min()):.4f}, {float(out['global_prob'].max()):.4f}], "
          f"launches {counts}", flush=True)
    del out, batches, step, tr, fr, state, opt_state, opt
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_avvp_main_") as tmp:
        summary, best, dt = avvp_main_once(cfg, tmp)
        size = best.stat().st_size
        print(f"avvp main: avvp_main.main(--mode train --epochs 1 --batch-size "
              f"{AVVP_TRAIN_BATCH}) over {AVVP_MAIN_VIDEOS} videos on disk, on the card by "
              f"default, in {dt:.1f} s: MGN_Net.npz of {size / 1e9:.3f} GB saved; test "
              f"segment_type_avg {summary['segment_type_avg']:.2f}, event_type_avg "
              f"{summary['event_type_avg']:.2f}", flush=True)
        t0 = time.perf_counter()
        lp, ls = ckpt.load_params_and_state(str(best))
        dt = time.perf_counter() - t0
    torch.cuda.empty_cache()
    eng = AVVPInferenceEngine(cfg, *from_jax(lp, ls, cfg, device=device), batch_size=BATCH,
                              device=device)
    del lp, ls
    clips = LLPClips(BATCH, cfg, seed=31)
    wave, frames, st = (np.stack([clips[i][k] for i in range(BATCH)])
                        for k in ("wave", "image", "video_st"))
    reset_launch_counts()
    out = eng.forward_batch(wave, frames, st)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != AVVP_PER_FORWARD or not all(bool(torch.isfinite(v).all()) for v in out.values()):
        raise AssertionError(f"avvp train serve: launches {counts} (expected {AVVP_PER_FORWARD}) "
                             f"or non-finite outputs")
    print(f"avvp train serve: the entry point's train state of {size / 1e9:.3f} GB read in "
          f"{dt:.1f} s; a bf16 AVVPInferenceEngine on it (adapters folded) answers {BATCH} clips: "
          f"global_prob mean {float(out['global_prob'].mean()):.4f}, launches {counts}",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    print(f"avvp train: phase 11 in {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 12: AVQA serving at full width
# ---------------------------------------------------------------------------

AVQA_CENSUS = Path(__file__).resolve().parent / "tests" / "golden" / "census_avqa_fusion.json"
AVQA_GROUNDING_CENSUS = (Path(__file__).resolve().parent / "tests" / "golden"
                         / "census_avqa_grounding.json")
# the visual gates fold into ln_post: all 48 take K3
AVQA_PER_FORWARD = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 48,
                    "int8_linear": 0, "int8_quantize": 0}
AVQA_INT8_PER_FORWARD = {"window_attention": 34, "block_attention": 2, "adapter_bottleneck": 48,
                         "int8_linear": 142, "int8_quantize": 142}
AVQA_SEGMENT = 320000     # avqa_main.make_dataset's wave: the model's clip length a segment
AVQA_STREAM_QUESTIONS = 16
AVQA_INT8_TOWERS = ("swin", "htsat")  # what the AVQA engine's int8_towers quantizes
# the f32 engine with kernels against the plain one, max |delta logit| over
# max |logit| of the answer logits: above the plain path's own move under a
# 1e-6 relative change of its inputs and the sound kernels' reading (printed
# beside), below the readings of the faults K3_PLANTED in front of K3
# (readings in PERF.md, section 6, the AVQA family)
AVQA_F32_TOL = 5e-4
AVQA_WORDS = ["<pad>", "is", "there", "a", "in", "the", "video", "what", "how", "many",
              "instruments", "are", "sounding", "louder", "than", "which", "first", "violin",
              "piano", "cello", "guitar", "flute", "drum", "left", "right"]
AVQA_ANSWERS = ["yes", "no", "zero", "one", "two", "three", "violin", "piano", "cello",
                "guitar", "flute", "drum", "left", "right"]
AVQA_TYPES = [["Audio", "Counting"], ["Audio", "Comparative"], ["Visual", "Counting"],
              ["Visual", "Location"], ["Audio-Visual", "Existential"],
              ["Audio-Visual", "Counting"], ["Audio-Visual", "Location"],
              ["Audio-Visual", "Comparative"], ["Audio-Visual", "Temporal"]]
AVQA_TEMPLATES = [("is there a <Object> in the video?", 1),
                  ("how many instruments are sounding in the video?", 0),
                  ("is the <Object> louder than the <Object>?", 2),
                  ("which <Object> is sounding first?", 1)]
AVQA_HEAD_GROUPS = ("AVQA question encoder", "AVQA grounding and fusion heads")


def write_avqa_tree(root, splits, cfg, seed=0):
    """A MUSIC-AVQA tree: T JPEG frames at the towers' size a video, a float32
    wave of T x AVQA_SEGMENT, ques_vocab.txt and ans_vocab.txt, and
    avqa-{split}.json with templated questions, one video a question,
    `splits` {split: questions}."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    T, S = cfg.num_frames, cfg.swin.img_size
    for d in ("frames", "audio"):
        (root / d).mkdir(parents=True, exist_ok=True)
    (root / "ques_vocab.txt").write_text("\n".join(AVQA_WORDS) + "\n")
    (root / "ans_vocab.txt").write_text("\n".join(AVQA_ANSWERS) + "\n")
    objects = AVQA_WORDS[17:23]
    for split, n in splits.items():
        samples = []
        for i in range(n):
            vid = f"{split}{i:05d}"
            (root / "frames" / vid).mkdir()
            for t in range(T):
                Image.fromarray(rs.randint(0, 256, (S, S, 3), dtype=np.uint8)).save(
                    root / "frames" / vid / f"{t:08d}.jpg", quality=90)
            np.save(root / "audio" / f"{vid}.npy",
                    np.clip(0.3 * rs.randn(T * AVQA_SEGMENT), -1, 1).astype(np.float32))
            text, slots = AVQA_TEMPLATES[i % len(AVQA_TEMPLATES)]
            samples.append({"video_id": vid, "question_content": text,
                            "templ_values": str([objects[(i + k) % 6] for k in range(slots)]),
                            "anser": AVQA_ANSWERS[(3 * i) % len(AVQA_ANSWERS)],
                            "type": str(AVQA_TYPES[i % len(AVQA_TYPES)])})
        (root / f"avqa-{split}.json").write_text(json.dumps(samples))
    return root


def avqa_dataset(root, cfg, split="test"):
    from dg_sct_tpu_torch.data.avqa import AVQADataset

    return AVQADataset(str(root), str(root / f"avqa-{split}.json"),
                       frame_dir=str(root / "frames"), audio_dir=str(root / "audio"),
                       img_size=cfg.swin.img_size, num_frames=cfg.num_frames,
                       segment_samples=AVQA_SEGMENT, with_nega=False)


class AVQAQuestions:
    """Seeded full-width questions in memory in the serving wire format: an
    int16 wave of T x AVQA_SEGMENT, uint8 frames, token ids, answers and
    types."""

    def __init__(self, n, cfg, seed):
        rs = np.random.RandomState(seed)
        T, S = cfg.num_frames, cfg.swin.img_size
        self.wave = (np.clip(0.3 * rs.randn(n, T, AVQA_SEGMENT), -1, 1) * 32767).astype(np.int16)
        self.frames = rs.randint(0, 256, (n, T, S, S, 3), dtype=np.uint8)
        self.question = rs.randint(1, len(AVQA_WORDS), (n, cfg.max_qst_len)).astype(np.int64)
        self.answer = rs.randint(0, len(AVQA_ANSWERS), n).astype(np.int64)

    def __len__(self):
        return len(self.wave)

    def __getitem__(self, i):
        return {"wave": self.wave[i], "visual_posi": self.frames[i],
                "question": self.question[i], "answer": self.answer[i],
                "type": str(AVQA_TYPES[i % len(AVQA_TYPES)])}


def stream_answers_all(eng, ds):
    """stream_answers over the whole dataset -> (logits, answers, metas,
    launch counts)."""
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = list(eng.stream_answers(ds))
    return (np.concatenate([lg for lg, _, _ in out]), np.concatenate([a for _, a, _ in out]),
            [m for _, _, ms in out for m in ms], launch_counts())


def import_avqa_census_models(cfg, device):
    """The AVQA census state dicts through the port's import path: the
    grounding generator's (converter, key census with 0 unexplained, shape
    audit on "meta") and the fusion net's (the same, `from_jax` onto the
    card)."""
    from dg_sct_tpu_torch.utils import torch_convert as TC

    t0 = time.perf_counter()
    line = census_import("avqa import", AVQA_GROUNDING_CENSUS, TC.convert_avqa_grounding,
                         TC.AVQA_GROUNDING_CKPT_IGNORED_PATTERNS, cfg, device="meta",
                         grounding=True)[-1]
    print(f"{line}; shape audit OK", flush=True)
    params, state, _, line = census_import("avqa import", AVQA_CENSUS, TC.convert_avqa_fusion,
                                           TC.AVQA_CKPT_IGNORED_PATTERNS, cfg, device=device)
    gates = [float(ap["gate"]) for ap in params["adapters"]["v_p1"] + params["adapters"]["v_p2"]]
    print(f"{line}; visual adapter gates from the seed in [{min(gates):.3f}, {max(gates):.3f}]; "
          f"on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    return params, state


def run_avqa(device="cuda"):
    """Phase 12: the census-built full-width AVQA model served through
    `stream_answers` from an on-disk MUSIC-AVQA tree (B=2, chunk=2, bf16),
    the float32 engine with kernels against the plain one (each K1, K2 and
    K3 call against its plain version, faults planted in front of K3),
    clips/s in two wire formats, a profiled forward, and int8 towers (each K4
    call of a float32 int8 forward against its plain version)."""
    import tempfile

    from dg_sct_tpu_torch.configs import AVQAModelConfig
    from dg_sct_tpu_torch.models import avqa
    from dg_sct_tpu_torch.ops import quant
    from dg_sct_tpu_torch.serve import AVQAInferenceEngine

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = AVQAModelConfig()
    params, state = import_avqa_census_models(cfg, device)
    eng = AVQAInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device=device)
    check_folded(eng, "avqa", f"; groups {cfg.adapter.num_conv_group}, tokens "
                              f"{cfg.adapter.num_tokens}")
    T, n_ans = cfg.num_frames, cfg.ans_vocab_size
    forwards = -(-CLIPS // BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_avqa_") as tmp:
        ds = avqa_dataset(write_avqa_tree(Path(tmp), {"test": CLIPS}, cfg), cfg)
        disk = [ds[i] for i in range(len(ds))]  # decoded once; the checks below reuse them
    truth = [(int(d["answer"]), d["type"]) for d in disk]
    (logits, answers, metas, counts), dt, peak = serve_timed("avqa", stream_answers_all, eng,
                                                             disk, AVQA_PER_FORWARD)
    if logits.shape != (CLIPS, n_ans) or not np.isfinite(logits).all():
        raise AssertionError(f"avqa: logits {logits.shape} or non-finite")
    if metas != truth or not np.array_equal(answers, logits.argmax(-1)):
        raise AssertionError(f"avqa: metas {metas[:3]}... not in dataset order")
    print(f"avqa serve: {CLIPS} questions from disk (JPEG frames {cfg.swin.img_size}, .npy waves "
          f"{T}x{AVQA_SEGMENT}, templated questions) through stream_answers in {dt:.3f} s "
          f"(B={BATCH}, chunk 2, bf16): logits {logits.shape} finite in [{logits.min():.4f}, "
          f"{logits.max():.4f}], answers {answers.tolist()}; metas in dataset order; launches "
          f"{counts} ({forwards} forwards); peak memory {peak / 2**30:.3f} GiB; card "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # float32: the engine with kernels against the plain one on the same questions
    bad = []  # bound checks, fatal at the end of the phase once every reading is printed
    f32 = dict(batch_size=BATCH, chunk=2, device=device, compute_dtype=torch.float32)
    f32_against_plain(
        "avqa f32", stream_answers_all, AVQAInferenceEngine(cfg, params, state, kernels=False,
                                                            **f32),
        AVQAInferenceEngine(cfg, params, state, **f32), disk, AVQA_F32_TOL, bad,
        per_forward=AVQA_PER_FORWARD, checked=K123, planted_in="adapter_bottleneck",
        faults=K3_PLANTED, nudge_keys=("visual_posi", "wave"),
        detail=lambda got, ref: f", answers agreeing "
                                f"{int((got.argmax(-1) == ref.argmax(-1)).sum())} of {len(got)}")

    # clips/s in two wire formats, and a profiled forward
    mem = AVQAQuestions(AVQA_STREAM_QUESTIONS, cfg, seed=13)
    items = [disk[i % CLIPS] for i in range(AVQA_STREAM_QUESTIONS)]  # AVQADataset's, in memory
    stream_rates("avqa", stream_answers_all, eng,
                 (("uint8 frames, int16 wave", mem),
                  ("AVQADataset's float32 normalized frames and float32 wave", items)),
                 ("wave", "visual_posi", "question"), unit="questions")
    profile_batch(f"one AVQA forward of {BATCH} questions", "avqa profile", eng,
                  tuple(np.stack([mem[i][k] for i in range(BATCH)])
                        for k in ("wave", "visual_posi", "question")),
                  op_group(AVQA_HEAD_GROUPS),
                  ((avqa, "qst_encoder", AVQA_HEAD_GROUPS[0]),
                   (avqa, "heads", AVQA_HEAD_GROUPS[1])))

    # int8 towers with scales calibrated on a seeded batch
    rs = np.random.RandomState(7)
    on_card = lambda a: torch.as_tensor(a, device=device).to(torch.bfloat16)
    cw = on_card((rs.randn(BATCH, T, AVQA_SEGMENT) * 0.1).astype(np.float32))
    ci = on_card(rs.rand(BATCH, T, cfg.swin.img_size, cfg.swin.img_size, 3).astype(np.float32))
    cq = torch.as_tensor(rs.randint(1, len(AVQA_WORDS), (BATCH, cfg.max_qst_len)), device=device)
    scales = calibrated("avqa", lambda: quant.calibrate_avqa(eng.params, eng.state, eng.cfg, cw,
                                                             ci, cq, gelu=eng.gelu,
                                                             device=device),
                        f"one plain bf16 forward of {BATCH} questions, the negative branch fed "
                        f"the same frames, as the JAX package calibrates")
    del eng
    q8 = AVQAInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device=device,
                             int8_towers=True, act_scales=scales)
    q_logits, q_answers, _, counts = serve_int8("avqa", stream_answers_all, q8, disk,
                                                AVQA_INT8_PER_FORWARD)
    print(f"avqa int8: launches {counts} ({forwards} forwards); drift against bf16 over {CLIPS} "
          f"questions: max |delta logit| {np.abs(q_logits - logits).max():.4f} "
          f"({spread_err(q_logits, logits):.3e} of the largest); answers agreeing "
          f"{int((q_answers == answers).sum())} of {CLIPS}", flush=True)
    del q8

    # float32: each K4 call of the int8-towers forward against its plain version
    item = lambda k: torch.as_tensor(np.stack([d[k] for d in disk[:BATCH]]), device=device)
    wave, frames, q = item("wave"), item("visual_posi"), item("question")
    check_int8_forward("avqa int8 f32", params, state, cfg, AVQA_INT8_TOWERS, scales,
                       lambda t, fs: avqa.forward(t, fs, wave, frames, None, q, cfg,
                                                  kernels=True, device=device))
    del params, state
    torch.cuda.empty_cache()
    print(f"avqa: phase 12 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))


# ---------------------------------------------------------------------------
# phase 13: AVQA training at full width
# ---------------------------------------------------------------------------

AVQA_TRAIN_BATCH = 2     # avqa_main's --batch-size: 20 frames and 20 audio clips a mini-step
AVQA_TRAIN_LR = 1e-4     # avqa_main's --lr, both stages
AVQA_TRAIN_STEPS = 3
# K1-K4 a mini-step: stage 1 runs both frozen towers alone in eval form
# (Swin-V2 on 2B frames, HTS-AT on B clips); stage 2 only the negative
# branch's frozen Swin-V2 (B*T frames); the trainer's eval step K3 in
# float32 on the 24 audio adapters (no BN, no gate: already in folded form)
AVQA_STAGE1_LAUNCHES = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 0,
                        "int8_linear": 0, "int8_quantize": 0}
AVQA_STAGE2_LAUNCHES = {"window_attention": 2, "block_attention": 22, "adapter_bottleneck": 0,
                        "int8_linear": 0, "int8_quantize": 0}
AVQA_EVAL_LAUNCHES = {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 24,
                      "int8_linear": 0, "int8_quantize": 0}
AVQA_MAIN_SPLITS = {"train": 2, "val": 2, "test": 2}  # the entry point's tree: one step a split


def seeded_avqa_model(cfg, device="cuda"):
    """Float32 (params, state) from seed 0 with each adapter's gate_av and
    each visual adapter's gate in [0.2, 0.6] from seed 1 (zero at init, they
    would zero their branch)."""
    from dg_sct_tpu_torch.models import avqa
    from dg_sct_tpu_torch.models.interleave import ADKEYS

    params, state = avqa.init_avqa_model(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for k in ADKEYS:
        for ap in params["adapters"][k]:
            for g in ("gate", "gate_av"):
                if g in ap:
                    ap[g] = torch.empty_like(ap[g]).uniform_(0.2, 0.6, generator=gen)
    return params, state


def avqa_train_batches(cfg, n, seed, device):
    """`n` seeded synthetic batches of AVQA_TRAIN_BATCH questions (waves of
    AVQA_SEGMENT a segment) on `device`."""
    from dg_sct_tpu_torch.data.avqa import synthetic_batch

    return [{k: torch.as_tensor(v, device=device) for k, v in synthetic_batch(
        AVQA_TRAIN_BATCH, img_size=cfg.swin.img_size, num_frames=cfg.num_frames,
        seed=seed + i, sr=AVQA_SEGMENT).items()} for i in range(n)]


def moved_leaves(tr, fr, p0, what, frozen=("swin", "htsat")):
    """{path: unchanged} of every leaf against the host copy `p0`, and a fatal
    error where a leaf under a `frozen` root changed."""
    from dg_sct_tpu_torch.train.ave_train import merge_params
    from dg_sct_tpu_torch.utils.tree import tree_paths

    now = dict(tree_paths(merge_params(tr, fr)))
    same = {p: torch.equal(now[p].cpu(), p0[p]) for p in p0}
    changed = [p for p in same if p[0] in frozen and not same[p]]
    if changed:
        raise AssertionError(f"{what}: frozen leaves changed: {changed[:5]}")
    return same


def train_steps(step, tr, fr, state, opt_state, batches, gen, what, want):
    """Run the mini-steps, each timed and its launches checked against `want`
    -> (tr, state, opt_state, seconds, peak GiB)."""
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, b in enumerate(batches):
        reset_launch_counts()
        (tr, state, opt_state, m), dt = timed_step(step, (tr, fr, state, opt_state, b, gen))
        counts = launch_counts()
        times.append(dt)
        loss = float(m["loss"])
        acc = m.get("acc", m.get("qa_acc"))
        acc = "" if acc is None else f"accuracy {float(acc):.3f}, "
        print(f"{what}: mini-step {i + 1}: loss {loss:.4f}, {acc}{dt:.3f} s, launches {counts}",
              flush=True)
        if not math.isfinite(loss) or counts != want:
            raise AssertionError(f"{what}: mini-step {i + 1}: loss {loss} or launches {counts} "
                                 f"(expected {want})")
    return tr, state, opt_state, times, torch.cuda.max_memory_allocated() / 2**30


def avqa_main_once(cfg, tmp):
    """`avqa_main.main` in train mode, one epoch each, on the card by default:
    stage 1, then stage 2 from its checkpoint, over a tree of
    AVQA_MAIN_SPLITS -> (stage-1 path, stage-2 accuracies, stage-2 path,
    seconds of each)."""
    import contextlib
    import io

    from dg_sct_tpu_torch.train import avqa_main

    root = write_avqa_tree(Path(tmp), AVQA_MAIN_SPLITS, cfg, seed=50)
    save = root / "ckpt"
    common = ["--meta", str(root), "--frames", str(root / "frames"), "--audio",
              str(root / "audio"), "--epochs", "1", "--batch-size", str(AVQA_TRAIN_BATCH),
              "--save-dir", str(save)]
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        s1 = avqa_main.main(["--mode", "train", "--stage", "1"] + common, cfg=cfg)
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        accs = avqa_main.main(["--mode", "train", "--stage", "2", "--stage1-ckpt", s1] + common,
                              cfg=cfg)
    t2 = time.perf_counter()
    best = save / "avst_best.npz"
    text = log.getvalue()
    if (not s1 or not Path(s1).exists() or not best.exists() or not accs
            or not all(0.0 <= v <= 100.0 for v in accs.values())
            or "transferred stage-1 heads" not in text or "test Avg accuracy" not in text):
        raise AssertionError(f"avqa main: no grounding_gen_best.npz or avst_best.npz, or no "
                             f"test report in range: {accs}, {text[-500:]}")
    return Path(s1), accs, best, (t1 - t0, t2 - t1)


def run_avqa_training(cfg=None, device="cuda"):
    """Phase 13: `cfg` (None: the full-width AVQAModelConfig()) trained in
    float32 at the recipe's step (B=2, Adam at 1e-4): AVQA_TRAIN_STEPS
    grounding mini-steps (plain Adam), the heads taken over, AVQA_TRAIN_STEPS
    stage-2 mini-steps under StepLR with remat "full", the checks of each; a
    stage-2 mini-step with remat "none"; a profiled one; the eval step; the
    entry point once for each stage, and its saved train state served by a
    bf16 engine."""
    import tempfile

    from dg_sct_tpu_torch.configs import AVQAModelConfig, TrainConfig
    from dg_sct_tpu_torch.models import avqa_grounding
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.serve import AVQAInferenceEngine
    from dg_sct_tpu_torch.train import avqa_main, avqa_train
    from dg_sct_tpu_torch.utils import checkpoint as ckpt
    from dg_sct_tpu_torch.utils.tree import tree_map, tree_paths
    from dg_sct_tpu_torch.weights import from_jax

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = cfg or AVQAModelConfig()
    name = "AVQAModelConfig()" if cfg == AVQAModelConfig() else cfg
    batches = avqa_train_batches(cfg, AVQA_TRAIN_STEPS, seed=40, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)

    # stage 1: the grounding generator, plain Adam
    params, state = avqa_grounding.init_grounding_model(cfg, seed=0, device=device)
    tr, fr = avqa_train.partition_params(params)
    p0 = {p: t.cpu() for p, t in tree_paths(params)}
    s0 = {p: t.cpu() for p, t in tree_paths(state)}
    del params
    opt = avqa_main.plain_adam(AVQA_TRAIN_LR)
    step, estep = avqa_main.make_stage1_steps(cfg, opt, device=device)
    print(f"avqa train stage 1: {name} grounding generator in float32, TF32 off; seed 0; "
          f"B={AVQA_TRAIN_BATCH} (frame 0 of each positive and negative clip, segment 0's "
          f"{AVQA_SEGMENT} samples), plain Adam at {AVQA_TRAIN_LR:g}; "
          f"{sum(t.numel() for _, t in tree_paths(tr)) / 1e6:.2f} M trainable parameters",
          flush=True)
    tr, state, opt_state, times, peak = train_steps(step, tr, fr, state, opt.init(tr), batches,
                                                    gen, "avqa train stage 1",
                                                    AVQA_STAGE1_LAUNCHES)
    same = moved_leaves(tr, fr, p0, "avqa train stage 1")
    unmoved = [p for p in same if p[0] not in ("swin", "htsat") and same[p]]
    bn = [p for p, t in tree_paths(state) if p[-1] in ("mean", "var")
          and torch.equal(t.cpu(), s0[p])]
    if unmoved or bn:
        raise AssertionError(f"avqa train stage 1: unmoved heads {unmoved[:5]} or bn0 {bn}")
    towers = sum(p[0] in ("swin", "htsat") for p in same)
    print(f"avqa train stage 1: {AVQA_TRAIN_STEPS} mini-steps: " + ", ".join(f"{t:.3f}"
                                                                          for t in times)
          + f" s; peak memory {peak:.3f} GiB; all {len(same) - towers} head leaves (fc_a1, fc_a2, "
          f"fc_gl, fc1-fc4) changed, {towers} tower leaves bit-identical; bn0's state moved",
          flush=True)
    stage1 = {k: tree_map(lambda t: t.cpu().numpy(), v) for k, v in tr.items()}
    del tr, fr, state, opt_state, step, estep, p0, s0

    # stage 2: the fusion net with the stage-1 heads, Adam under StepLR, remat full
    params, state = seeded_avqa_model(cfg, device)
    params = avqa_main.transfer_stage1(params, stage1)
    tr, fr = avqa_train.partition_params(params)
    p0 = {p: t.cpu() for p, t in tree_paths(params)}
    s0 = {p: t.cpu() for p, t in tree_paths(state)}
    del params
    tcfg = TrainConfig(batch_size=AVQA_TRAIN_BATCH, lr=AVQA_TRAIN_LR, lr_mlp=AVQA_TRAIN_LR,
                       accum_steps=1)
    opt = avqa_train.make_optimizer(tr, tcfg, steps_per_epoch=1)
    opt_state = opt.init(tr)
    step = avqa_train.make_train_step(cfg, opt, device=device, remat_policy="full")
    n_train = sum(t.numel() for _, t in tree_paths(tr))
    print(f"avqa train stage 2: {name} in float32, TF32 off; seed 0, adapter gates from seed "
          f"1, the stage-1 heads taken over; B={AVQA_TRAIN_BATCH} "
          f"({AVQA_TRAIN_BATCH * cfg.num_frames} frames and audio clips of {AVQA_SEGMENT} "
          f"samples, the negative clips' frames through the frozen Swin-V2), Adam at "
          f"{AVQA_TRAIN_LR:g} under StepLR, remat full; {n_train / 1e6:.1f} M trainable "
          f"parameters", flush=True)
    tr, state, opt_state, times, peak = train_steps(step, tr, fr, state, opt_state, batches, gen,
                                                    "avqa train stage 2", AVQA_STAGE2_LAUNCHES)
    same = moved_leaves(tr, fr, p0, "avqa train stage 2")
    trained = [p for p in same if p[0] not in ("swin", "htsat")]
    # the loss reads every trainable leaf: the answer the question encoder,
    # the attention blocks and the fusion, the match terms the grounding and
    # the audio projection, the towers' tokens every adapter
    unmoved = [p for p in trained if same[p]]
    bn = [(p, t) for p, t in tree_paths(state) if p[-1] in ("mean", "var")]
    still = [p for p, t in bn if torch.equal(t.cpu(), s0[p])]
    counts_bn = {int(t) for p, t in tree_paths(state) if p[-1] == "count"}
    if unmoved or still or counts_bn != {AVQA_TRAIN_STEPS}:
        raise AssertionError(f"avqa train stage 2: unmoved trainable leaves {unmoved[:5]}, BN "
                             f"state unmoved {still[:3]} or counts {counts_bn}")
    print(f"avqa train stage 2: {AVQA_TRAIN_STEPS} mini-steps: " + ", ".join(f"{t:.3f}"
                                                                          for t in times)
          + f" s; peak memory {peak:.3f} GiB; all {len(trained)} trainable leaves changed "
          f"(unread: none), {len(same) - len(trained)} frozen ones bit-identical; {len(bn)} BN "
          f"stats (bn0) moved, count {AVQA_TRAIN_STEPS}; card {torch.cuda.get_device_name(0)}",
          flush=True)
    del p0, s0

    groups = profile_run(lambda: step(tr, fr, state, opt_state, batches[0], gen),
                         f"one stage-2 mini-step of {AVQA_TRAIN_BATCH} questions, remat full",
                         "avqa train profile", host_ops=False)
    unprofiled = float(np.median(times[1:]))
    print(f"avqa train profile: {sum(groups.values()):.3f} ms of device time against the "
          f"unprofiled mini-steps' median {unprofiled:.3f} s: "
          f"{100.0 * (1.0 - sum(groups.values()) / 1e3 / unprofiled):.1f}% idle", flush=True)

    none = avqa_train.make_train_step(cfg, opt, device=device, remat_policy="none")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (_, _, _, m), dt = timed_step(none, (tr, fr, state, opt_state, batches[0],
                                         torch.Generator(device=device).manual_seed(5)))
    if not math.isfinite(float(m["loss"])):
        raise AssertionError("avqa train remat none: the loss is not finite")
    print(f"avqa train remat none: one stage-2 mini-step of B={AVQA_TRAIN_BATCH} in {dt:.3f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del none

    estep = avqa_train.make_eval_step(cfg, device=device)
    reset_launch_counts()
    out = estep(tr, fr, state, batches[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != AVQA_EVAL_LAUNCHES or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"avqa train eval step: launches {counts} (expected "
                             f"{AVQA_EVAL_LAUNCHES}) or non-finite logits")
    print(f"avqa train eval step: B={AVQA_TRAIN_BATCH}, float32, no negative branch, logits "
          f"{tuple(out.shape)} in [{float(out.min()):.4f}, {float(out.max()):.4f}], launches "
          f"{counts} (K3 in float32 on the 24 audio adapters)", flush=True)
    del out, batches, step, tr, fr, state, opt_state, opt
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_avqa_main_") as tmp:
        s1, accs, best, (dt1, dt2) = avqa_main_once(cfg, tmp)
        size1, size = s1.stat().st_size, best.stat().st_size
        print(f"avqa main: avqa_main.main(--mode train --stage 1 --epochs 1) then (--stage 2 "
              f"--stage1-ckpt) over {AVQA_MAIN_SPLITS} questions on disk, on the card by "
              f"default, in {dt1:.1f} and {dt2:.1f} s: grounding_gen_best.npz of "
              f"{size1 / 1e9:.3f} GB and avst_best.npz of {size / 1e9:.3f} GB saved; test "
              f"accuracies " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(accs.items())),
              flush=True)
        t0 = time.perf_counter()
        lp, ls = ckpt.load_params_and_state(str(best))
        dt = time.perf_counter() - t0
    torch.cuda.empty_cache()
    eng = AVQAInferenceEngine(cfg, *from_jax(lp, ls, cfg, device=device), batch_size=BATCH,
                              device=device)
    del lp, ls
    mem = AVQAQuestions(BATCH, cfg, seed=31)
    wave, frames, q = (np.stack([mem[i][k] for i in range(BATCH)])
                       for k in ("wave", "visual_posi", "question"))
    reset_launch_counts()
    out = eng.forward_batch(wave, frames, q)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != AVQA_PER_FORWARD or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"avqa train serve: launches {counts} (expected {AVQA_PER_FORWARD}) "
                             f"or non-finite logits")
    print(f"avqa train serve: the entry point's train state of {size / 1e9:.3f} GB read in "
          f"{dt:.1f} s; a bf16 AVQAInferenceEngine on it (adapters folded) answers {BATCH} "
          f"questions: answers {out.argmax(-1).tolist()}, launches {counts}", flush=True)
    del eng
    torch.cuda.empty_cache()
    print(f"avqa train: phase 13 in {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 14: the CLIP x CLAP pretrain model's zero-shot forward at full width
# ---------------------------------------------------------------------------

# K1/K2/K3/K4 a pretrain forward: K2 in HTS-AT's 12 eval blocks; K3 in all
# 48 adapters once they are folded, none on the adapters as loaded
PRETRAIN_PER_FORWARD = {"window_attention": 0, "block_attention": 12, "adapter_bottleneck": 0,
                        "int8_linear": 0, "int8_quantize": 0}
PRETRAIN_FOLDED_PER_FORWARD = dict(PRETRAIN_PER_FORWARD, adapter_bottleneck=48)
# f32 kernels against plain: the largest |delta| of v_cls, a_cls and the two
# contrastive logits, each over its own largest value; above the sound
# readings and the plain path's move under a 1e-6 nudge (printed beside),
# below faults planted in front of K3 (readings in PERF.md, section 6)
PRETRAIN_F32_TOL = 5e-4
PRETRAIN_OUTPUTS = ("v_cls", "a_cls", "logits_audio_image", "logits_image_audio")
PRETRAIN_GROUPS = ("pretrain text tower", "pretrain ViT", "pretrain HTS-AT", "pretrain adapters")
PRETRAIN_WORDS = ("playing", "dog", "people", "engine", "bird", "guitar", "singing", "water",
                  "car", "baby", "violin", "crowd")


def pretrain_names(n):
    """`n` seeded class names of two to four words, VGGSound's style."""
    rs = np.random.RandomState(5)
    return [" ".join(PRETRAIN_WORDS[j] for j in rs.randint(len(PRETRAIN_WORDS), size=2 + i % 3))
            + f" {i}" for i in range(n)]


def seeded_pretrain_model(cfg, names, device, clap_text_features=None):
    """Float32 (params, state, buffers) from seed 0, each adapter's gate and
    gate_av in [0.2, 0.6] from seed 1 (zero at init, they would zero the
    adapters' branches)."""
    from dg_sct_tpu_torch.models import pretrain

    params, state, buffers = pretrain.init_pretrain_model(
        cfg, names, clap_text_features=clap_text_features, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for k in pretrain.ADKEYS:
        for ap in params["adapters"][k]:
            for g in ("gate", "gate_av"):
                ap[g] = torch.empty_like(ap[g]).uniform_(0.2, 0.6, generator=gen)
    return params, state, buffers


def pretrain_inputs(cfg, batch, seed, device):
    """A seeded float32 batch on `device`: waves (B, T, clip_samples) in
    [-1, 1], frames (B, T, 224, 224, 3) in [0, 1) and one-hot clip labels."""
    rs = np.random.RandomState(seed)
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.clip.image_size
    n = cfg.num_classes
    arrays = {"wave": np.clip(0.3 * rs.randn(batch, T, L), -1, 1).astype(np.float32),
              "image": rs.rand(batch, T, S, S, 3).astype(np.float32),
              "label": np.eye(n, dtype=np.float32)[rs.randint(n, size=batch)]}
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def outer_group(groups):
    """A profile's host-op groups: the outermost of the ranges `groups`
    around the op (the text tower's blocks run the same halves as the ViT's)."""
    def group(e):
        found, op = None, e
        while op is not None:
            if op.name in groups:
                found = op.name
            op = op.cpu_parent
        return found
    return group


def pretrain_ranges():
    """(module, name, label) of the profile's groups."""
    from dg_sct_tpu_torch.models import adapter, clip, htsat

    text, vit, aud, ad = PRETRAIN_GROUPS
    return ([(clip, "encode_text_embeddings", text)]
            + [(clip, n, vit) for n in ("visual_embed", "attention_part", "mlp_part",
                                         "visual_project")]
            + [(htsat, n, aud) for n in ("frontend", "block", "patch_merging", "tscam_latent")]
            + [(adapter, "adapter", ad)])


def pretrain_forward_timed(fwd, params, state, what, want):
    """One warm-up forward, then one timed with its launches checked against
    `want` -> (outputs, seconds, peak GiB)."""
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    fwd(params, state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fwd(params, state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, expected {want}")
    return out, dt, torch.cuda.max_memory_allocated() / 2**30


def run_pretrain(device="cuda"):
    """Phase 14: PretrainModelConfig() at full width in float32 (141 classes,
    seeded weights, the CLAP text features from a seeded RoBERTa-base): the
    zero-shot forward at B=2 on the adapters as loaded (0/12/0/0) and folded
    (0/12/48/0), each K2 and K3 call against its plain version, the folded
    forward with kernels against the plain one (PRETRAIN_F32_TOL, beside the
    nudge and faults planted in front of K3), a profiled forward."""
    from dg_sct_tpu_torch.configs import PretrainModelConfig
    from dg_sct_tpu_torch.models import pretrain
    from dg_sct_tpu_torch.models.clap_text import compute_clap_text_features
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
    from dg_sct_tpu_torch.train.pretrain_train import partition_pretrain_params
    from dg_sct_tpu_torch.utils.tree import tree_paths

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = PretrainModelConfig()
    names = pretrain_names(cfg.num_classes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = compute_clap_text_features(names, device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if feats.shape != (cfg.num_classes, cfg.clip.embed_dim) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"pretrain clap: features {tuple(feats.shape)} or non-finite")
    print(f"pretrain clap: compute_clap_text_features over {len(names)} prompts (\"The sounds "
          f"of <name>\", byte-level ids, 77 tokens) through a seeded RoBERTa-base and the "
          f"768 -> 512 -> 512 projection on the card in {dt:.3f} s (initialiser included): "
          f"{tuple(feats.shape)} float32", flush=True)
    params, state, buffers = seeded_pretrain_model(cfg, names, device, clap_text_features=feats)
    tr, fr = partition_pretrain_params(params)
    count = lambda tree: sum(t.numel() for _, t in tree_paths(tree))
    print(f"pretrain: PretrainModelConfig() in float32, TF32 off: {count(params) / 1e6:.2f} M "
          f"parameters, {count(fr) / 1e6:.2f} M frozen (visual {count(fr['visual']) / 1e6:.2f}, "
          f"text {count(fr['text']) / 1e6:.2f}, htsat {count(fr['htsat']) / 1e6:.2f}), "
          f"{count(tr) / 1e6:.2f} M trainable (adapters {count(tr['adapters']) / 1e6:.2f}); "
          f"{len(names)} classes, seed 0, adapter gates from seed 1", flush=True)
    del tr, fr
    batch = pretrain_inputs(cfg, BATCH, seed=0, device=device)

    def fwd(p, s, wave=batch["wave"], image=batch["image"], **kw):
        return pretrain.forward(p, s, buffers, wave, image, cfg, device=device, **kw)

    B, T = BATCH, cfg.num_frames
    with torch.inference_mode():
        out, dt, peak = pretrain_forward_timed(fwd, params, state, "pretrain unfolded",
                                               PRETRAIN_PER_FORWARD)
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if (shapes["event_scores"] != (B * T, cfg.num_classes)
                or shapes["logits_audio_image"] != (B, B)
                or not all(bool(torch.isfinite(v).all()) for v in out.values())):
            raise AssertionError(f"pretrain: outputs {shapes} or non-finite")
        print(f"pretrain serve: B={B} ({B * T} frames of {cfg.clip.image_size} and {B * T} audio "
              f"clips of {cfg.htsat.frontend.clip_samples} samples), adapters as loaded: "
              f"{dt * 1e3:.3f} ms, peak memory {peak:.3f} GiB, launches {PRETRAIN_PER_FORWARD}; "
              f"outputs {shapes}", flush=True)
        fp, fs = fold_adapters_eval(params, state, cfg)
        del params, state
        folded = [ap for k in fp["adapters"] for ap in fp["adapters"][k]]
        eligible = sum(not {"bn1", "bn2", "gate"} & set(ap) for ap in folded)
        if eligible != len(folded):
            raise AssertionError(f"pretrain fold: {eligible} of {len(folded)} adapters "
                                 f"K3-eligible")
        got, dt, peak = pretrain_forward_timed(fwd, fp, fs, "pretrain folded",
                                               PRETRAIN_FOLDED_PER_FORWARD)
        print(f"pretrain serve folded: {eligible} of {len(folded)} adapters folded (BN and gate into the "
              f"bottleneck and ln_post): {dt * 1e3:.3f} ms, peak memory {peak:.3f} GiB, launches "
              f"{PRETRAIN_FOLDED_PER_FORWARD}; event_scores against the unfolded forward: max abs "
              f"diff {(got['event_scores'] - out['event_scores']).abs().max().item():.3e}",
              flush=True)

        # float32: each K2 and K3 call, then the folded forward, against plain
        bad = []
        calls = {"block_attention": [], "adapter_bottleneck": []}
        with contextlib.ExitStack() as stack:
            for kernel, c in calls.items():
                stack.enter_context(side_by_side(kernel, c))
            got = fwd(fp, fs)
        for kernel, c in calls.items():
            report_calls("pretrain f32", kernel, c, bad)
        ref = fwd(fp, fs, kernels=False)
        scale = {k: max(ref[k].abs().max().item(), 1e-6) for k in PRETRAIN_OUTPUTS}
        flat = lambda o: np.concatenate([(o[k].float() / scale[k]).cpu().numpy().ravel()
                                         for k in PRETRAIN_OUTPUTS])
        rs = np.random.RandomState(21)
        nudge = lambda t: t * (1.0 + INT8_NUDGE * torch.as_tensor(
            rs.randn(*t.shape), device=device, dtype=t.dtype))
        near = fwd(fp, fs, wave=nudge(batch["wave"]), image=nudge(batch["image"]), kernels=False)
        f_got, f_ref = flat(got), flat(ref)
        err, sens = spread_err(f_got, f_ref), spread_err(flat(near), f_ref)
        ev_g, ev_r = got["event_scores"], ref["event_scores"]
        print(f"pretrain f32: kernels vs plain, the largest |delta| of "
              f"{', '.join(PRETRAIN_OUTPUTS)} over each one's largest value {err:.3e} (per output "
              + ", ".join(f"{k} {(got[k] - ref[k]).abs().max().item() / scale[k]:.3e}"
                          for k in PRETRAIN_OUTPUTS)
              + f"; bound {PRETRAIN_F32_TOL:g}); the plain path moves {sens:.3e} with frames and "
              f"wave changed by {INT8_NUDGE:g} (relative); event_scores max abs diff "
              f"{(ev_g - ev_r).abs().max().item():.3e} of max |value| "
              f"{ev_r.abs().max().item():.3e}, argmax agreeing in "
              f"{int((ev_g.argmax(-1) == ev_r.argmax(-1)).sum())} of {B * T} segments", flush=True)
        if not np.isfinite(f_got).all() or err > PRETRAIN_F32_TOL:
            bad.append(f"pretrain f32: kernels and plain path disagree ({err:.3e})")
        read_planted("adapter_bottleneck", lambda: flat(fwd(fp, fs)), f_ref, PRETRAIN_F32_TOL,
                     "pretrain f32", bad, faults=K3_PLANTED)
        del got, ref, near

        # one profiled folded forward, its groups by the host op's range
        fwd(fp, fs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            for module, name, label in pretrain_ranges():
                stack.enter_context(annotate(module, name, label))
            profile_run(lambda: fwd(fp, fs), f"one folded pretrain forward of {B} clips, float32",
                        "pretrain profile", op_group=outer_group(PRETRAIN_GROUPS))
        print(f"pretrain profile: peak memory of the profiled forward "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del fp, fs, buffers, batch, feats
    torch.cuda.empty_cache()
    print(f"pretrain: phase 14 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))


# ---------------------------------------------------------------------------
# phase 15: pretrain and few-shot training at full width, and the entry points
# ---------------------------------------------------------------------------

PRETRAIN_TRAIN_BATCH = 2   # pretrain_main --mode smoke's B: 20 frames and 20 audio clips
PRETRAIN_RECIPE_BATCH = 8  # pretrain_main's --batch-size, one mini-step
PRETRAIN_LR = 1e-4         # pretrain_main's and few_shot_main's --lr
PRETRAIN_STEPS = 3
PRETRAIN_FROZEN = ("visual", "text", "htsat", "clap_text_features")
# the trainable leaves the forward never reads: CoCoOp's meta_net (zero
# gradient, so Adam leaves them)
PRETRAIN_UNREAD = ("prompt_learner", "meta_net")
PRETRAIN_MAIN_VIDEOS = 4   # each entry point's tree: one mini-step of B=2 a split


def write_vggsound_tree(root, videos, cats, cfg, seed=0):
    """A VGGSound-AVEL tree: T JPEG frames (256 x 256) and an int16 wave of T x
    clip_samples a video, the categories file and the labels csv (even
    videos train, odd ones test; 6-digit numeric ids)."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    T, L = cfg.num_frames, cfg.htsat.frontend.clip_samples
    (root / "audio").mkdir(parents=True)
    rows = ["video_id,split,category,label"]
    for v in range(videos):
        vid = f"{v + 1:06d}"
        (root / "frames" / vid).mkdir(parents=True)
        for t in range(T):
            Image.fromarray(rs.randint(0, 256, (256, 256, 3), dtype=np.uint8)).save(
                root / "frames" / vid / f"{t:08d}.jpg", quality=90)
        np.save(root / "audio" / f"{vid}.npy",
                (np.clip(0.3 * rs.randn(T * L), -1, 1) * 32767).astype(np.int16))
        flags = [1] * T if v % 3 else [1] * (T // 2) + [0] * (T - T // 2)
        rows.append(f'{vid},{"train" if v % 2 == 0 else "test"},{cats[v % len(cats)]},"{flags}"')
    (root / "VggsoundAVEL40kCategories.txt").write_text("\n".join(cats) + "\n")
    (root / "vggsound-avel40k_labels.csv").write_text("\n".join(rows) + "\n")
    return root


def pretrain_mains_once(cfg, tmp):
    """pretrain_main in train mode (1 epoch over a VGGSound-AVEL tree), then
    zero_shot_main in eval mode on AVE and LLP trees and few_shot_main in
    train mode on the AVE tree, each from the saved `pretrain_best.npz`, all
    on the card by default -> (pretrain path, {run: accuracy}, {run: s})."""
    import dataclasses
    import io
    import types

    from dg_sct_tpu_torch.train import few_shot_main, pretrain_main, zero_shot_main

    tmp = Path(tmp)
    vgg = write_vggsound_tree(tmp / "vgg", PRETRAIN_MAIN_VIDEOS,
                              ["dog barking", "playing violin", "people whistling"], cfg, seed=70)
    ave = write_ave_tree(tmp / "ave", PRETRAIN_MAIN_VIDEOS,
                         dataclasses.replace(cfg, num_classes=4), seed=71)
    (ave / "trainSet.txt").write_text((ave / "testSet.txt").read_text())
    llp = write_llp_tree(tmp / "llp", [f"llp{i:08d}" for i in range(PRETRAIN_MAIN_VIDEOS)],
                         types.SimpleNamespace(num_frames=cfg.num_frames,
                                               swin=types.SimpleNamespace(img_size=224)), seed=72)
    media = lambda root: ["--frames", str(root / "frames"), "--audio", str(root / "audio")]
    log, accs, secs = io.StringIO(), {}, {}

    def run(name, main, argv):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            out = main(argv)
        secs[name] = time.perf_counter() - t0
        return out

    best = run("pretrain_main train", pretrain_main.main,
               ["--mode", "train", "--root", str(vgg), "--epochs", "1", "--batch-size", "2",
                "--save-dir", str(tmp / "ckpt")] + media(vgg))
    if not best or not Path(best).exists():
        raise AssertionError(f"pretrain main: no pretrain_best.npz: {log.getvalue()[-500:]}")
    common = ["--ckpt", best, "--batch-size", "2"]
    accs["zero-shot AVE events"] = run("zero_shot_main AVE", zero_shot_main.main,
                                       ["--mode", "eval", "--dataset", "AVE", "--meta", str(ave)]
                                       + media(ave) + common)
    accs["zero-shot LLP cls"] = run("zero_shot_main LLP", zero_shot_main.main,
                                    ["--mode", "eval", "--dataset", "LLP", "--label-test",
                                     str(llp / "AVVP_test_pd.csv")] + media(llp) + common)
    accs["few-shot AVE cls"] = run("few_shot_main AVE", few_shot_main.main,
                                   ["--mode", "train", "--dataset", "AVE", "--meta", str(ave),
                                    "--k-shot", "1", "--epochs", "1", "--save-dir",
                                    str(tmp / "few")] + media(ave) + common)
    text = log.getvalue()
    if (not (tmp / "few" / "few_shot_AVE_cls_best.npz").exists()
            or not all(0.0 <= a <= 100.0 for a in accs.values())
            or "weak accuracy" not in text or "ckpt: skipped" not in text):
        raise AssertionError(f"pretrain mains: {accs}, {text[-800:]}")
    return Path(best), accs, secs


def run_pretrain_training(cfg=None, device="cuda"):
    """Phase 15: `cfg` (None: the full-width PretrainModelConfig()) trained in
    float32 at pretrain_main's step (plain Adam at 1e-4, no remat):
    PRETRAIN_STEPS mini-steps of B=2, the checks of each; a profiled one;
    one at the recipe's B=8; one few-shot mini-step for each loss (the
    global-norm clip, then Adam); then the three entry points once each."""
    import dataclasses
    import tempfile

    from dg_sct_tpu_torch.configs import PretrainModelConfig, PromptConfig
    from dg_sct_tpu_torch.train import few_shot_main
    from dg_sct_tpu_torch.train import pretrain_train as PT
    from dg_sct_tpu_torch.train.optim import ClippedAdam
    from dg_sct_tpu_torch.utils.tree import tree_paths

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = cfg or PretrainModelConfig()
    name = "PretrainModelConfig()" if cfg == PretrainModelConfig() else cfg
    names = pretrain_names(cfg.num_classes)
    params, state, buffers = seeded_pretrain_model(cfg, names, device)
    tr, fr = PT.partition_pretrain_params(params)
    p0 = {p: t.cpu() for p, t in tree_paths(params)}
    s0 = {p: t.cpu() for p, t in tree_paths(state)}
    del params
    opt = PT.plain_adam(PRETRAIN_LR)
    step = PT.make_pretrain_step(cfg, buffers, opt, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    batches = [pretrain_inputs(cfg, PRETRAIN_TRAIN_BATCH, 60 + i, device)
               for i in range(PRETRAIN_STEPS)]
    print(f"pretrain train: {name} in float32, TF32 off, no remat; seed 0, adapter gates from "
          f"seed 1; B={PRETRAIN_TRAIN_BATCH} ({PRETRAIN_TRAIN_BATCH * cfg.num_frames} frames and "
          f"audio clips), plain Adam at {PRETRAIN_LR:g}, SpecAugment from a generator; "
          f"{sum(t.numel() for _, t in tree_paths(tr)) / 1e6:.2f} M trainable parameters; the "
          f"text tower over {cfg.num_classes} x {cfg.clip.context_length} tokens in the graph",
          flush=True)
    tr, state, opt_state, times, peak = train_steps(step, tr, fr, state, opt.init(tr), batches,
                                                    gen, "pretrain train", NO_LAUNCHES)
    same = moved_leaves(tr, fr, p0, "pretrain train", frozen=PRETRAIN_FROZEN)
    trained = [p for p in same if p[0] not in PRETRAIN_FROZEN]
    unread = [p for p in trained if p[:2] == PRETRAIN_UNREAD]
    unmoved = [p for p in trained if same[p] and p[:2] != PRETRAIN_UNREAD]
    still_unread = [p for p in unread if not same[p]]
    bn = [(p, t) for p, t in tree_paths(state) if p[-1] in ("mean", "var")]
    still = [p for p, t in bn if torch.equal(t.cpu(), s0[p])]
    counts_bn = {int(t) for p, t in tree_paths(state) if p[-1] == "count"}
    if unmoved or still_unread or still or counts_bn != {PRETRAIN_STEPS}:
        raise AssertionError(f"pretrain train: unmoved trainable leaves {unmoved[:5]}, moved "
                             f"unread ones {still_unread}, BN state unmoved {still[:3]} or counts "
                             f"{counts_bn}")
    print(f"pretrain train: {PRETRAIN_STEPS} mini-steps: " + ", ".join(f"{t:.3f}" for t in times)
          + f" s; peak memory {peak:.3f} GiB; {len(trained) - len(unread)} of the {len(trained)} "
          f"trainable leaves changed, the {len(unread)} of prompt_learner.meta_net unchanged "
          f"(the forward never reads them: zero gradient); {len(same) - len(trained)} frozen "
          f"leaves bit-identical; {len(bn)} BN stats (bn0 and the adapters' bn1 and bn2) moved, "
          f"count {PRETRAIN_STEPS}; card {torch.cuda.get_device_name(0)}", flush=True)
    del p0, s0

    groups = profile_run(lambda: step(tr, fr, state, opt_state, batches[0], gen),
                         f"one pretrain mini-step of {PRETRAIN_TRAIN_BATCH} clips",
                         "pretrain train profile", host_ops=False)
    unprofiled = float(np.median(times[1:]))
    print(f"pretrain train profile: {sum(groups.values()):.3f} ms of device time against the "
          f"unprofiled mini-steps' median {unprofiled:.3f} s: "
          f"{100.0 * (1.0 - sum(groups.values()) / 1e3 / unprofiled):.1f}% idle", flush=True)

    del batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    big = pretrain_inputs(cfg, PRETRAIN_RECIPE_BATCH, 66, device)
    (_, _, _, m), dt = timed_step(step, (tr, fr, state, opt_state, big, gen))
    if not math.isfinite(float(m["loss"])):
        raise AssertionError("pretrain train B=8: the loss is not finite")
    print(f"pretrain train B={PRETRAIN_RECIPE_BATCH}: one mini-step at the recipe's batch "
          f"({PRETRAIN_RECIPE_BATCH * cfg.num_frames} frames and audio clips) in {dt:.3f} s, "
          f"loss {float(m['loss']):.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del big, step, opt_state, m

    sched = {"train": lambda count: PRETRAIN_LR}
    for task, loss_fn in (("cls", few_shot_main.few_shot_loss),
                          ("events", few_shot_main.few_shot_event_loss)):
        if task == "events":  # the background prompt: another class count
            del tr, fr, state, buffers
            torch.cuda.empty_cache()
            ecfg = dataclasses.replace(cfg, prompt=PromptConfig(weak=False))
            params, state, buffers = seeded_pretrain_model(ecfg, names, device)
            tr, fr = PT.partition_pretrain_params(params)
            del params
        fopt = ClippedAdam(sched, 1.0)
        fstep = few_shot_main.make_few_shot_step(ecfg if task == "events" else cfg, buffers, fopt,
                                                 loss_fn, device=device)
        b = pretrain_inputs(cfg, PRETRAIN_TRAIN_BATCH, 80, device)
        if task == "events":
            rs = np.random.RandomState(81)
            n = cfg.num_classes + 1
            b["label"] = torch.as_tensor(np.eye(n, dtype=np.float32)[rs.randint(
                n, size=(PRETRAIN_TRAIN_BATCH, cfg.num_frames))], device=device)
        tr, state, _, _, _ = train_steps(fstep, tr, fr, state, fopt.init(tr), [b], gen,
                                         f"few-shot train {task}", NO_LAUNCHES)
    del tr, fr, state, buffers, fstep, fopt, b
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pretrain_main_") as tmp:
        best, accs, secs = pretrain_mains_once(cfg, tmp)
        size = best.stat().st_size
    print(f"pretrain main: pretrain_main.main(--mode train --epochs 1) over "
          f"{PRETRAIN_MAIN_VIDEOS} VGGSound-AVEL videos on disk, on the card by default: "
          f"pretrain_best.npz of {size / 1e9:.3f} GB; from it zero_shot_main (--mode eval) on AVE "
          f"and LLP trees and few_shot_main (--mode train --k-shot 1 --epochs 1) on AVE: "
          + ", ".join(f"{k} {v:.1f} %" for k, v in accs.items()) + "; seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    torch.cuda.empty_cache()
    print(f"pretrain train: phase 15 in {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 16: video features extracted on the card, served through AVVP
# ---------------------------------------------------------------------------

FEATURE_VIDEOS = 7
FEATURE_FRAMES = 80        # 10 s at 8 fps: the feature scripts' n_frame_steps
FEATURE_SIZE = 224         # the frames as written, the RGB script's size
WAV_SR = 44100
# card against the CPU on the same inputs and weights, max |delta| / max
# |value| of the features: both float32 with TF32 off, apart by summation
# order only; above the card's own move under a 1e-6 relative nudge of the
# frames (printed beside)
FEATURES_TOL = 1e-4
CPU_FRAMES = 16            # the RGB check: one batch of one video
CPU_CLIPS = 4              # the clip check: one video's first clips
NUDGE = 1e-6


def write_feature_media(root, videos, seed=0):
    """Raw media of `videos`, seeded: FEATURE_FRAMES JPEGs at FEATURE_SIZE a
    video (frames/<vid>/%08d.jpg, from 1) and a 10-s 44.1-kHz stereo int16
    wav (wav/<vid>.wav)."""
    from PIL import Image
    from scipy.io import wavfile

    rs = np.random.RandomState(seed)
    (root / "wav").mkdir(parents=True)
    for vid in videos:
        d = root / "frames" / vid
        d.mkdir(parents=True)
        for t in range(FEATURE_FRAMES):
            Image.fromarray(rs.randint(0, 256, (FEATURE_SIZE, FEATURE_SIZE, 3), dtype=np.uint8)
                            ).save(d / f"{t + 1:08d}.jpg", quality=90)
        wave = np.clip(0.3 * rs.randn(WAV_SR * 10, 2), -1, 1) * 32767
        wavfile.write(root / "wav" / f"{vid}.wav", WAV_SR, wave.astype(np.int16))


def ffmpeg_frames(root, vid):
    """If ffmpeg is on the path, one video's frames encoded into an 8-fps
    MPEG-4 file and decoded back by `preprocess.extract_frames` -> what ran."""
    from dg_sct_tpu_torch.data import preprocess

    if not preprocess.have_ffmpeg():
        return "ffmpeg is not on the path: extract_frames not run"
    mp4 = root / f"{vid}.mp4"
    subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-framerate", "8", "-i",
                    str(root / "frames" / vid / "%08d.jpg"), "-c:v", "mpeg4", str(mp4)],
                   check=True, timeout=120)
    n = preprocess.extract_frames(str(mp4), str(root / "ffmpeg_frames"), fps=8)
    if n < FEATURE_FRAMES - 1:
        raise AssertionError(f"features media: extract_frames gave {n} frames")
    return f"ffmpeg is on the path: extract_frames decoded {n} frames of an 8-fps MPEG-4 video"


def card_against_cpu(what, fn, params, x, tol, bad):
    """`fn(params, x)` on the card against the same call on the CPU (params
    and x copied), max |delta| / max |value|, beside the card's move under a
    NUDGE relative change of x."""
    from dg_sct_tpu_torch.utils.tree import tree_map

    gen = torch.Generator(device=x.device)
    gen.manual_seed(31)
    flat = lambda y: np.concatenate([t.float().cpu().numpy().ravel()
                                     for t in (y if isinstance(y, list) else [y])])
    with torch.inference_mode():
        got = flat(fn(params, x))
        near = flat(fn(params, x * (1 + NUDGE * torch.randn(x.shape, generator=gen,
                                                            device=x.device))))
        t0 = time.perf_counter()
        ref = flat(fn(tree_map(lambda t: t.cpu() if torch.is_tensor(t) else t, params), x.cpu()))
        cpu_s = time.perf_counter() - t0
    err, sens = spread_err(got, ref), spread_err(near, got)
    print(f"{what}: card against the CPU on {tuple(x.shape)}: max |delta| / max |value| "
          f"{err:.3e} (bound {tol:g}), max abs diff {np.abs(got - ref).max():.3e}, max |value| "
          f"{np.abs(ref).max():.3e}; the card moves {sens:.3e} with the input changed by "
          f"{NUDGE:g} (relative); the CPU took {cpu_s:.2f} s", flush=True)
    if not np.isfinite(got).all() or not err <= tol:
        bad.append(f"{what}: card and CPU disagree ({err:.3e})")
    return err


def run_features(device="cuda"):
    """Phase 16: raw media (7 videos of 80 JPEG frames at 224, 44.1-kHz
    stereo wavs) into an LLP tree through the port's own preprocessing and
    feature extraction on the card (ResNet-152 frames and R(2+1)D-18 clips,
    float32, TF32 off, seeded weights), each backbone held against the CPU,
    then the tree served by a bf16 AVVPInferenceEngine on the census
    weights (launches 4 x 2/34/48/0)."""
    import tempfile

    from dg_sct_tpu_torch.configs import AVVPModelConfig
    from dg_sct_tpu_torch.data import feature_extract as FE
    from dg_sct_tpu_torch.data import preprocess
    from dg_sct_tpu_torch.models import video_feats as VF
    from dg_sct_tpu_torch.ops.basic import seeded_init
    from dg_sct_tpu_torch.serve import AVVPInferenceEngine

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    bad = []
    cfg = AVVPModelConfig()
    videos = [f"llp{i:08d}" for i in range(FEATURE_VIDEOS)]  # LLP ids: 11 characters
    with tempfile.TemporaryDirectory(prefix="chip_smoke_features_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_feature_media(root, videos)
        t_media = time.perf_counter() - t0
        t0 = time.perf_counter()
        waves = [preprocess.wav_to_wave_npy(str(root / "wav" / f"{v}.wav"),
                                            str(root / "audio" / f"{v}.npy")) for v in videos]
        t_wav = time.perf_counter() - t0
        if any(w.shape != (10 * preprocess.TARGET_SR,) or w.dtype != np.float32
               or np.abs(w).max() > 1 for w in waves):
            raise AssertionError("features media: a wave is not 10 s at 32 kHz in [-1, 1]")
        print(f"features media: {FEATURE_VIDEOS} videos of {FEATURE_FRAMES} JPEG frames at "
              f"{FEATURE_SIZE} and {FEATURE_VIDEOS} 10-s {WAV_SR}-Hz stereo int16 wavs written "
              f"in {t_media:.2f} s; wav_to_wave_npy to 10-s {preprocess.TARGET_SR}-Hz float32 "
              f"waves in "
              f"{t_wav:.2f} s; {ffmpeg_frames(root, videos[0])}", flush=True)

        rgb_params = VF.init_resnet152(seeded_init(0, device))
        clip_params = VF.init_r2plus1d_18(seeded_init(0, device))
        for name, extract, params, out, n_out, dim in (
                ("rgb", FE.extract_rgb_feats, rgb_params, "rgb", FEATURE_FRAMES, 2048),
                ("clip", FE.extract_3d_feats, clip_params, "st", FEATURE_FRAMES // 8, 512)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = extract(str(root / "frames"), str(root / out), n_frame_steps=FEATURE_FRAMES,
                          params=params, device=device)
            dt = time.perf_counter() - t0
            feats = [np.load(root / out / f"{v}.npy") for v in got]
            if got != videos or any(f.shape != (n_out, dim) or f.dtype != np.float32
                                    or not np.isfinite(f).all() for f in feats):
                raise AssertionError(f"features {name}: {got} or the features' shapes "
                                     f"{[f.shape for f in feats][:2]} or non-finite")
            size = 224 if name == "rgb" else 112
            print(f"features {name}: feature_extract {name} over {len(videos)} videos "
                  f"({FEATURE_FRAMES} frames each at {size}, float32, TF32 off, seeded weights) "
                  f"in {dt:.3f} s = {len(videos) * FEATURE_FRAMES / dt:.1f} frames/s end to "
                  f"end (JPEG decode and resize on the host included), peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; ({n_out}, {dim}) a "
                  f"video, |value| up to {max(np.abs(f).max() for f in feats):.3e}", flush=True)

        frames224 = FE._frames(str(root / "frames"), videos[0], FEATURE_FRAMES, 224)
        frames112 = FE._frames(str(root / "frames"), videos[0], FEATURE_FRAMES, 112)
        x_rgb = torch.as_tensor(frames224[:FE.RGB_BATCH], device=device)
        x_clip = torch.as_tensor(frames112.reshape((-1, FE.CLIP_FRAMES) + frames112.shape[1:]),
                                 device=device)
        with torch.inference_mode():
            for name, fn, params, x, n in (
                    ("rgb", VF.resnet152_features, rgb_params, x_rgb, FE.RGB_BATCH),
                    ("clip", VF.r2plus1d_18_features, clip_params, x_clip, FEATURE_FRAMES)):
                torch.cuda.reset_peak_memory_stats()
                ms, dev_ms, _ = time_ms(lambda: fn(params, x))
                print(f"features {name} backbone: one call on {tuple(x.shape)} {ms:.3f} ms "
                      f"({dev_ms:.3f} ms on the card alone) = {n / dev_ms * 1e3:.1f} frames/s, "
                      f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
                      flush=True)
                profile_run(lambda: fn(params, x), f"one call on {tuple(x.shape)}",
                            f"features {name} profile")
        card_against_cpu("features rgb", VF.resnet152_features, rgb_params,
                         x_rgb[:CPU_FRAMES], FEATURES_TOL, bad)
        card_against_cpu("features clip", VF.r2plus1d_18_features, clip_params,
                         x_clip[:CPU_CLIPS], FEATURES_TOL, bad)
        del rgb_params, clip_params, x_rgb, x_clip
        torch.cuda.empty_cache()

        write_llp_csvs(root, videos)
        ds = llp_dataset(root, cfg)
        disk = [ds[i] for i in range(len(ds))]
        for v, item in zip(videos, disk):
            if not np.array_equal(item["video_st"], np.load(root / "st" / f"{v}.npy")):
                raise AssertionError(f"features: LLPDataset's video_st of {v} is not the "
                                     f"extracted features")
    params, state = import_avvp_census_model(cfg)
    eng = AVVPInferenceEngine(cfg, params, state, batch_size=BATCH, chunk=2, device=device)
    del params, state
    (probs, vids, counts), dt, peak = serve_timed("features avvp", stream_probs_all, eng, disk,
                                                  AVVP_PER_FORWARD)
    clip = np.concatenate([probs[k].ravel() for k in ("global_prob", "a_prob", "v_prob")])
    frame = np.concatenate([probs[k].ravel() for k in ("a_frame_prob", "v_frame_prob")])
    if (vids != videos or probs["global_prob"].shape != (FEATURE_VIDEOS, cfg.num_classes)
            or probs["v_frame_prob"].shape != (FEATURE_VIDEOS, cfg.num_frames, cfg.num_classes)
            or not np.isfinite(clip).all() or not np.isfinite(frame).all()
            or clip.min() < 0 or clip.max() > 1 or frame.min() < 0 or frame.max() > 2):
        raise AssertionError("features avvp: outputs' shapes, order or range")
    print(f"features avvp: the extracted tree (LLPDataset: frames at {cfg.swin.img_size}, "
          f"wav_to_wave_npy's waves, st/ from feature_extract clip) through a bf16 "
          f"AVVPInferenceEngine on the census weights (B={BATCH}, chunk 2) in {dt:.3f} s: clip "
          f"probabilities in [{clip.min():.4f}, {clip.max():.4f}], frame probabilities in "
          f"[{frame.min():.4f}, {frame.max():.4f}]; launches {counts} "
          f"({-(-FEATURE_VIDEOS // BATCH)} forwards); peak memory {peak / 2**30:.3f} GiB",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    print(f"features: phase 16 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))


# ---------------------------------------------------------------------------
# phase 17: the standalone modules at full width
# ---------------------------------------------------------------------------

HTSAT_CENSUS = Path(__file__).resolve().parent / "tests" / "golden" / "census_htsat_audioset.json"
PVT_CENSUS = Path(__file__).resolve().parent / "tests" / "golden" / "census_avs_pvt_v2_b5.json"
# the 12 HTS-AT blocks of one tower pass
CLASSIFIER_PER_PASS = {"window_attention": 0, "block_attention": 12, "adapter_bottleneck": 0,
                       "int8_linear": 0, "int8_quantize": 0}
CLASSIFIER_OUTPUTS = ("clipwise_output", "framewise_output", "latent_output")
# the f32 classifier with K2 against the plain one, spread_err of the three
# outputs (clipwise and framewise as logits) each over its largest |value|:
# above the sound kernels' reading (8.7e-6) and the plain path's move under
# a 1e-6 relative change of the wave (1.2e-6), below K2's bias rolled by one
# key (5.4e-3). K2's bias staged in bf16 moves the outputs 1.6e-5, 1.8x the
# sound kernels' own rounding: no bound on these outputs separates it, so it
# is reported beside (readings in PERF.md, section 6)
CLASSIFIER_F32_TOL = 1e-4
CLASSIFIER_PLANTED = ("bias rolled by one key",)
PVT_FRAMES = 5             # an AVS clip's frames, B=2 clips a forward
STANDALONE_TOL = 1e-4      # PVT-v2-b5 and VGGish, card against the CPU, as FEATURES_TOL
AVENET_SPEC = (257, 1004)  # VGGSound's 10-s spectrogram: 16 kHz, nperseg 512, noverlap 353


def import_classifier(device):
    """The AudioSet HTS-AT census state dict (`sed_model.` stripped) through
    the port's `convert_htsat` (527 classes, the tscam conv) onto the card by
    `from_jax_tree` -> (params, state, line)."""
    from dg_sct_tpu_torch.configs import HTSATConfig
    from dg_sct_tpu_torch.models import htsat
    from dg_sct_tpu_torch.ops.basic import seeded_init
    from dg_sct_tpu_torch.utils import torch_convert as TC
    from dg_sct_tpu_torch.weights import from_jax_tree

    sd = TC.track(TC.strip_prefix(census_state_dict(HTSAT_CENSUS), "sed_model."))
    params, state = TC.convert_htsat(sd)
    unread = sorted(set(sd) - sd.accessed)
    ref_p, ref_s = htsat.init_htsat(seeded_init(0, "meta"), HTSATConfig())
    params = from_jax_tree(params, ref_p, device=device)
    state = from_jax_tree(state, ref_s, device=device)
    return params, state, (f"{len(sd)} keys of {HTSAT_CENSUS.name}: {len(sd.accessed)} read, "
                           f"{len(unread)} unread ({', '.join(unread)})")


def classifier_arrays(out):
    """The classifier's outputs as float64 arrays, the clipwise and framewise
    probabilities as their logits (a saturated sigmoid hides a change)."""
    return {k: (torch.logit(out[k].double()) if k != "latent_output" else out[k].double())
            .cpu().numpy() for k in CLASSIFIER_OUTPUTS}


def classifier_flat(out, scale):
    """The three outputs as one array, each over its reference's largest
    |value| in `scale`: spread_err of two such arrays is the largest of the
    three outputs' own."""
    arrays = classifier_arrays(out)
    return np.concatenate([arrays[k].ravel() / scale[k] for k in CLASSIFIER_OUTPUTS])


def run_classifier(bad, device):
    """The AudioSet classifier at B=2: 10-s and 20-s waves in bf16 and f32
    (launches 0/12/0/0 and 0/24/0/0), the train branch once from a
    generator (0/0/0/0), and in f32 each K2 call against its plain version
    and the outputs against the plain forward, beside the nudge and the
    faults planted in front of K2. -> (bf16 params, state, 10-s wave)."""
    from dg_sct_tpu_torch.configs import HTSATConfig
    from dg_sct_tpu_torch.models import htsat
    from dg_sct_tpu_torch.models.ave import cast_for_compute
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg = HTSATConfig()
    params, state, line = import_classifier(device)
    print(f"standalone htsat import: {line}", flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    sr, clip = cfg.frontend.sample_rate, cfg.frontend.clip_samples
    # one clip's length (10 s: mel T <= target_t) and two (20 s: two sliding crops)
    waves = {n: 0.1 * torch.randn(BATCH, n * clip, generator=gen, device=device) for n in (1, 2)}
    per = lambda n: {k: v * n for k, v in CLASSIFIER_PER_PASS.items()}
    cfb = htsat.tscam_freq_bins(cfg)
    st = cfg.stage_resolution(cfg.num_layers - 1)[1]
    n_framewise = (st // cfb) * st * 8 * cfg.patch_stride[1]
    trees = {torch.bfloat16: cast_for_compute(params, torch.bfloat16), torch.float32: params}
    with torch.inference_mode():
        for dtype, tree in trees.items():
            for passes in (1, 2):
                secs = passes * clip // sr
                fwd = lambda p, s, w=waves[passes]: htsat.classifier_forward(p, s, w, cfg)[0]
                out, dt, peak = pretrain_forward_timed(fwd, tree, state,
                                                       f"standalone htsat {secs} s", per(passes))
                shapes = {k: tuple(v.shape) for k, v in out.items()}
                if (shapes != {"clipwise_output": (BATCH, cfg.num_classes),
                               "framewise_output": (BATCH, n_framewise, cfg.num_classes),
                               "latent_output": (BATCH, cfg.num_features)}
                        or not all(bool(torch.isfinite(v).all()) for v in out.values())):
                    raise AssertionError(f"standalone htsat: outputs {shapes} or non-finite")
                print(f"standalone htsat serve: classifier_forward, B={BATCH} {secs}-s waves "
                      f"({passes * clip} samples, mel T = "
                      f"{passes * clip // cfg.frontend.hop_size + 1}, "
                      f"{passes} tower pass{'es' if passes > 1 else ''}), {str(dtype)[6:]}: "
                      f"{dt * 1e3:.3f} ms, peak memory {peak:.3f} GiB, launches {per(passes)}; "
                      f"clipwise in [{float(out['clipwise_output'].min()):.4f}, "
                      f"{float(out['clipwise_output'].max()):.4f}]", flush=True)
        profile_run(lambda: htsat.classifier_forward(trees[torch.bfloat16], state, waves[2], cfg),
                    f"one bf16 forward of {BATCH} {2 * clip // sr}-s waves",
                    "standalone htsat profile")
        reset_launch_counts()
        out, new_state = htsat.classifier_forward(params, state, waves[2], cfg, train=True,
                                                  gen=gen)
        counts = launch_counts()
        if counts != NO_LAUNCHES or int(new_state["bn0"]["count"]) != 1 or not all(
                bool(torch.isfinite(v).all()) for v in out.values()):
            raise AssertionError(f"standalone htsat train: launches {counts}, bn0 count or "
                                 f"non-finite")
        print(f"standalone htsat train: the {2 * clip // sr}-s waves through the train branch "
              f"(one random crop to {cfg.frontend.target_t} frames and SpecAugment from the "
              f"generator, bn0 on the batch, the plain tower): launches {counts}, outputs "
              f"finite", flush=True)

        # float32: K2 side by side, the outputs against the plain forward
        w = waves[2]
        ref = htsat.classifier_forward(params, state, w, cfg, kernels=False)[0]
        scale = {k: float(np.abs(v).max()) for k, v in classifier_arrays(ref).items()}
        f_ref = classifier_flat(ref, scale)
        calls = []
        reset_launch_counts()
        with side_by_side("block_attention", calls):
            got = htsat.classifier_forward(params, state, w, cfg)[0]
        want_calls = per(2)["block_attention"] if device == "cuda" else len(calls)
        if launch_counts() != per(2) or not calls or len(calls) != want_calls:
            raise AssertionError(f"standalone htsat f32: launches {launch_counts()}, "
                                 f"{len(calls)} K2 calls checked")
        report_calls("standalone htsat f32", "block_attention", calls, bad)
        near = htsat.classifier_forward(
            params, state, w * (1 + NUDGE * torch.randn(w.shape, generator=gen, device=device)),
            cfg, kernels=False)[0]
        f_got, f_near = classifier_flat(got, scale), classifier_flat(near, scale)
        err, sens = spread_err(f_got, f_ref), spread_err(f_near, f_ref)
        ga, ra = classifier_arrays(got), classifier_arrays(ref)
        print(f"standalone htsat f32: {2 * clip // sr}-s waves, kernels vs plain (the three "
              f"outputs, clipwise and framewise as logits, each over its largest |value|): "
              f"spread_err {err:.3e} (bound {CLASSIFIER_F32_TOL:g}), mean_err "
              f"{mean_err(f_got, f_ref):.3e}; per output "
              + ", ".join(f"{k} {np.abs(ga[k] - ra[k]).max() / scale[k]:.3e}"
                          for k in CLASSIFIER_OUTPUTS)
              + f"; the plain path moves {sens:.3e} (mean_err {mean_err(f_near, f_ref):.3e}) "
              f"with the wave changed by {NUDGE:g} (relative)", flush=True)
        if not np.isfinite(f_got).all() or not err <= CLASSIFIER_F32_TOL:
            bad.append(f"standalone htsat f32: kernels and plain path disagree ({err:.3e})")
        run = lambda: classifier_flat(htsat.classifier_forward(params, state, w, cfg)[0], scale)
        read_planted("block_attention", run, f_ref, CLASSIFIER_F32_TOL, "standalone htsat f32",
                     bad, faults={k: PLANTED[k] for k in CLASSIFIER_PLANTED})
        for name in set(PLANTED) - set(CLASSIFIER_PLANTED):
            with planted("block_attention", PLANTED[name]):
                out = run()
            print(f"standalone htsat f32: planted fault, block_attention {name}: spread_err "
                  f"{spread_err(out, f_ref):.3e}, mean_err {mean_err(out, f_ref):.3e} (reported, "
                  f"not bounded: the outputs move about as much under the kernels' own float32 "
                  f"rounding)", flush=True)
    return trees[torch.bfloat16], state, waves[1]


def timed_call(fn):
    """fn() once to warm up, then once timed -> (output, ms)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def import_pvt(device):
    """PVT-v2-b5 synthesized from the AVS census through `convert_pvt_v2`,
    onto the card by `from_jax_tree` -> (params, config)."""
    from dg_sct_tpu_torch.models import pvt
    from dg_sct_tpu_torch.ops.basic import seeded_init
    from dg_sct_tpu_torch.utils import torch_convert as TC
    from dg_sct_tpu_torch.weights import from_jax_tree

    pcfg = pvt.pvt_v2_b5()
    tree = TC.convert_pvt_v2(census_state_dict(PVT_CENSUS))
    return from_jax_tree(tree, pvt.init_pvt_v2(seeded_init(0, "meta"), pcfg), device=device), pcfg


def run_pvt_vggish(bad, device):
    """PVT-v2-b5 from the AVS census at B=2 x 5 frames of 224, and VGGish on
    10 s of 16-kHz audio, each timed and held against the CPU."""
    from dg_sct_tpu_torch.models import pvt, vggish
    from dg_sct_tpu_torch.ops.basic import seeded_init

    params, pcfg = import_pvt(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    S = pcfg.img_size
    x = torch.randn(BATCH * PVT_FRAMES, S, S, 3, generator=gen, device=device)
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        maps, ms = timed_call(lambda: pvt.forward_features(params, x, pcfg))
        shapes = [tuple(m.shape) for m in maps]
        want = [(BATCH * PVT_FRAMES, S // r, S // r, c)
                for r, c in zip((4, 8, 16, 32), pcfg.embed_dims)]
        if shapes != want or not all(bool(torch.isfinite(m).all()) for m in maps):
            raise AssertionError(f"standalone pvt: maps {shapes} or non-finite")
        print(f"standalone pvt: PVT-v2-b5 from {PVT_CENSUS.name} through convert_pvt_v2 and "
              f"from_jax_tree, forward_features on {BATCH} x {PVT_FRAMES} frames of {S}, "
              f"float32: {ms:.3f} ms, peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
              f"GiB; maps {shapes}", flush=True)
        profile_run(lambda: pvt.forward_features(params, x, pcfg),
                    f"forward_features on {BATCH * PVT_FRAMES} frames", "standalone pvt profile")
    card_against_cpu("standalone pvt", lambda p, im: pvt.forward_features(p, im, pcfg), params,
                     x[:1], STANDALONE_TOL, bad)
    del params, maps

    vp = vggish.init_vggish(seeded_init(0, device))
    pca = vggish.init_postprocessor(seeded_init(1, device))
    t = np.arange(10 * vggish.SAMPLE_RATE) / vggish.SAMPLE_RATE
    wave = (0.3 * np.sin(2 * np.pi * 440.0 * t)
            + 0.05 * np.random.RandomState(3).randn(t.size)).astype(np.float32)
    t0 = time.perf_counter()
    ex = vggish.waveform_to_examples(wave)
    host_ms = (time.perf_counter() - t0) * 1e3
    ex_t = torch.as_tensor(ex, device=device)
    with torch.inference_mode():
        emb, ms = timed_call(lambda: vggish.vggish(vp, ex_t))
        codes = vggish.postprocess(pca, emb)
        codes_cpu = vggish.postprocess({k: v.cpu() for k, v in pca.items()}, emb.cpu()).numpy()
    codes = codes.cpu().numpy()
    if (ex.shape != (10, 96, 64, 1) or tuple(emb.shape) != (10, 128) or codes.min() < 0
            or codes.max() > 255 or not (codes == np.round(codes)).all()):
        raise AssertionError(f"standalone vggish: examples {ex.shape}, embeddings "
                             f"{tuple(emb.shape)} or codes out of 0..255")
    print(f"standalone vggish: 10 s of 16-kHz audio -> waveform_to_examples {ex.shape} on the "
          f"host in {host_ms:.3f} ms -> vggish (10, 128) on the card in {ms:.3f} ms -> "
          f"postprocess: PCA codes in [{codes.min():.0f}, {codes.max():.0f}], integral; the "
          f"codes of the card's embeddings on the CPU differ by at most "
          f"{np.abs(codes - codes_cpu).max():.0f}", flush=True)
    if np.abs(codes - codes_cpu).max() > 0:
        bad.append("standalone vggish: postprocess differs between card and CPU")
    card_against_cpu("standalone vggish", vggish.vggish, vp, ex_t, STANDALONE_TOL, bad)


def dormant_cases(device):
    """(name, call, output shape) of each dormant module at its reference
    widths, seeded weights and inputs on the card."""
    from dg_sct_tpu_torch.models import attentions as A
    from dg_sct_tpu_torch.models import legacy as L
    from dg_sct_tpu_torch.models import legacy_backbones as LB
    from dg_sct_tpu_torch.models import phm
    from dg_sct_tpu_torch.ops.basic import seeded_init

    init = seeded_init(0, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    x = lambda *shape, scale=1.0: scale * torch.randn(shape, generator=gen, device=device)
    B, T, D = BATCH, 10, 512
    ast = LB.init_ast(init)
    rn50, rn50_state = LB.init_modified_resnet(init)
    ave_net, ave_state = LB.init_avenet(init)
    cas, weak = L.init_cas_module(init, 256), L.init_weakly_localization(init, 256)
    avc, ava = L.init_audio_visual_contrastive(init), L.init_audio_visual_adapter(init)
    naga = L.init_new_audio_guided_attention(init)
    add, loc = A.init_additive(init, D), A.init_location_aware(init, D)
    mhloc, mh = A.init_multi_head_location_aware(init, D), A.init_multi_head(init, D)
    rel, cust = A.init_relative_multi_head(init, D), A.init_customizing(init, D)
    ph = phm.init_phm_linear(init, 768, 768, 4, phm_init_range=0.02)
    mel, img, spec = x(B, 1024, 128), x(B, 224, 224, 3), x(B, *AVENET_SPEC)
    q, kv, pos = x(B, 1, D), x(B, 100, D), x(B, 100, D)
    return [
        ("AST (128 x 1024 mel, stride 10, 527 labels)",
         lambda: LB.ast_forward(ast, mel, num_heads=12, apply_head=True), (B, 527)),
        ("ModifiedResNet RN50 at 224", lambda: LB.modified_resnet(rn50, rn50_state, img)[0],
         (B, 1024)),
        (f"AVENet (ResNet-18 on {AVENET_SPEC[0]} x {AVENET_SPEC[1]} spectrograms)",
         lambda: LB.avenet(ave_net, ave_state, spec)[0], (B, 309)),
        ("CAS_Module (d_model 256)", lambda: L.cas_module(cas, x(B, T, 256)), (B, T, 29)),
        ("WeaklyLocalizationModule (256)", lambda: L.weakly_localization(weak, x(T, B, 256))[2],
         (B, 29)),
        ("AudioVisualContrastive (36 x 1536 visual, 768 audio)",
         lambda: L.audio_visual_contrastive(avc, x(B * T, 36, 1536), x(B * T, 768),
                                            torch.softmax(x(B * T, 1, 36), -1)), (B * B, T, 1)),
        ("AudioVisualAdapter (1536 / 768)",
         lambda: L.audio_visual_adapter(ava, x(B * T, 1536), x(B * T, 768))[0], (B * T, 1536)),
        ("New_Audio_Guided_Attention (7 x 7 x 512 visual, 128 audio)",
         lambda: L.new_audio_guided_attention(naga, x(B, T, 7, 7, 512, scale=0.3),
                                              x(T, B, 128)), (B, T, 512)),
        ("ScaledDotProductAttention", lambda: A.scaled_dot_product_attention(q, kv, kv)[0],
         (B, 1, D)),
        ("DotProductAttention", lambda: A.dot_product_attention(q, kv)[0], (B, 1, D)),
        ("AdditiveAttention", lambda: A.additive_attention(add, q, kv, kv)[0], (B, 1, D)),
        ("LocationAwareAttention", lambda: A.location_aware_attention(loc, q, kv)[0], (B, D)),
        ("MultiHeadLocationAwareAttention",
         lambda: A.multi_head_location_aware_attention(mhloc, q, kv)[0], (B, 1, D)),
        ("MultiHeadAttention", lambda: A.multi_head_attention(mh, kv, kv, kv)[0], (B, 100, D)),
        ("RelativeMultiHeadAttention",
         lambda: A.relative_multi_head_attention(rel, kv, kv, kv, pos), (B, 100, D)),
        ("CustomizingAttention", lambda: A.customizing_attention(cust, q, kv)[0], (B, 1, D)),
        ("PHM linear (768 -> 768, phm_dim 4)", lambda: phm.phm_linear(ph, x(B, 100, 768)),
         (B, 100, 768)),
    ]


def run_standalone(device="cuda"):
    """Phase 17: the AudioSet HTS-AT classifier with its long-clip branches,
    PVT-v2-b5, VGGish and the dormant set at full width, then the profiling
    utilities (flops_estimate of the full-width AVE forward, a trace of a
    classifier forward)."""
    import tempfile

    from dg_sct_tpu_torch.configs import AVEModelConfig, HTSATConfig
    from dg_sct_tpu_torch.models import ave, htsat
    from dg_sct_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    bad = []
    cls_params, cls_state, wave10 = run_classifier(bad, device)
    run_pvt_vggish(bad, device)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        for name, call, shape in dormant_cases(device):
            out, ms = timed_call(call)
            if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"standalone dormant {name}: {tuple(out.shape)} (expected "
                                     f"{shape}) or non-finite")
            print(f"standalone dormant: {name}: {tuple(out.shape)} finite, {ms:.3f} ms (float32, "
                  f"B={BATCH})", flush=True)
    torch.cuda.empty_cache()

    cfg = AVEModelConfig()
    p, s = ave.init_ave_model(cfg, device="meta")
    T, S = cfg.num_frames, cfg.swin.img_size
    wave = torch.empty(BATCH, T, cfg.htsat.frontend.clip_samples, device="meta")
    frames = torch.empty(BATCH, T, S, S, 3, device="meta")
    t0 = time.perf_counter()
    est = profiling.flops_estimate(
        lambda p, s, w, i: ave.forward(p, s, w, i, cfg, kernels=False, device="meta"),
        p, s, wave, frames)
    top = sorted(((k, v) for k, v in est.items() if k != "flops"), key=lambda kv: -kv[1])[:3]
    print(f"standalone profiling: flops_estimate of the full-width AVE forward at B={BATCH} "
          f"(plain path on the meta device, PyTorch's count) {est['flops'] / 1e12:.3f} TFLOP in "
          f"{time.perf_counter() - t0:.2f} s; " + ", ".join(f"{k} {v / 1e12:.3f}" for k, v in top),
          flush=True)
    hcfg = HTSATConfig()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp, torch.inference_mode():
        htsat.classifier_forward(cls_params, cls_state, wave10, hcfg)
        with profiling.trace(tmp) as prof:
            htsat.classifier_forward(cls_params, cls_state, wave10, hcfg)
        path = Path(tmp) / "trace.json"
        n_dev = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
        print(f"standalone profiling: trace() of one bf16 classifier forward (B={BATCH}, 10 s): "
              f"{path.name} of {path.stat().st_size / 1e6:.3f} MB, {n_dev} device events",
              flush=True)
        if not path.stat().st_size or not n_dev:
            bad.append("standalone profiling: the trace holds no device event")
    print(f"standalone: phase 17 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))



# ---------------------------------------------------------------------------
# phase 18: the parallel modes
# ---------------------------------------------------------------------------

PAR_LR = 5e-4             # ave_main's --lr: Adam's first step moves an element by about lr
PAR_BATCH = 4             # the data-parallel global batch: 2 clips a rank
PAR_SEED = 43             # ave_main's --seed, the generator of the draws
PAR_EVAL_BATCH = 2        # the eval worlds' clips (20 frames and 20 audio clips a forward)
PIPE_RANKS = 3            # stage 2 at full width: [None, None, b0] x 6, three repeated pairs
PIPE_MICRO = 4            # microbatches of the 20 rows through the pipe
PAR_JOIN_S = 420.0        # a world's whole run (each process group times out after 120 s)
# the backward through the pipe: the first 5 of one clip's 10 segments (5 rows, num_frames 5:
# no weight depends on it) in 5 microbatches of 1. The three ranks share the card, each with
# its float64 weights, gradient and GPipe's saved activations of stages 0, 1, 3 and its pair:
# at 10 rows they passed the card's 80 GB (PERF.md)
PIPE_GRAD_FRAMES = 5
PIPE_GRAD_MICRO = 5
PIPE_GRAD_F64_RTOL = 1e-9    # float64: the gradient's relative L2, as the DP check's
PIPE_GRAD_F32_FACTOR = 4.0   # float32: of one process's own float32-vs-float64 move
PIPE_GRAD_PARTS = ("swin", "htsat", "adapters")
TP4_RANKS = 4             # TP at data 1 x model 4 (heads 6 of Swin stage 0 do not split)
TP4_BUDGET_S = 40.0       # the model-4 world's planned time, start-up included
# DP against one process on the card. Float32 rounding of this model's gradient is amplified
# by the backward through the towers (one process's own gradient moves by several percent
# under reordered clips, the adapters' leaves carrying the move; read here in both dtypes), so
# the gradients and Adam's step are held in float64, where that move collapses:
PAR_STAT_RTOL = 1e-4      # float32: loss and BN running stats, relative
PAR_F64_RTOL = 1e-9       # float64: loss, BN running stats and the gradient's relative L2
PAR_F64_STEP = 1e-3       # float64: every param after Adam's step, in units of lr
# eval of one mode against the one-process forward, max |delta| per output (event_scores and
# the per-frame is_event_scores): float32 (rounding only: other GEMM heights and reduction
# orders), and bf16 at this factor times the bf16 forward's own drift from the float32 one
PAR_F32_TOL = 1e-4
PAR_BF16_FACTOR = 4.0
PAR_OUTPUTS = ("event_scores", "is_event_scores")
# a rank's forward in each eval mode (K1/K2/K3/K4); the pipe ranks run stages 0, 1 and 3
# whole (K1 2, K2 10, K3 24) and one of stage 2's three pairs (K2 8, K3 8) a microbatch
PAR_LAUNCHES = {
    "sp": {"window_attention": 2, "block_attention": 34, "adapter_bottleneck": 48,
           "int8_linear": 0, "int8_quantize": 0},
    "tp": {"window_attention": 36, "block_attention": 0, "adapter_bottleneck": 0,
           "int8_linear": 0, "int8_quantize": 0},
    # model 4: Swin stage 0's 6 heads stay whole (K2 in its 2 blocks), the adapters' 2 groups too
    # (K3 in all 48, folded), every other attention splits by heads (K1 in 34 blocks)
    "tp4": {"window_attention": 34, "block_attention": 2, "adapter_bottleneck": 48,
            "int8_linear": 0, "int8_quantize": 0},
    "pipe": {"window_attention": 2, "block_attention": 10 + 8 * PIPE_MICRO,
             "adapter_bottleneck": 24 + 8 * PIPE_MICRO, "int8_linear": 0, "int8_quantize": 0},
}


def par_world_backend(world):
    """One rank a card with NCCL where the machine has `world` cards; else
    every rank on card 0 under gloo (NCCL refuses two ranks on one card)."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def par_eval_inputs(cfg):
    """The eval worlds' seeded clips: wave (B, T, L) and ImageNet-normalized
    frames (B, T, S, S, 3), float32 numpy."""
    rs = np.random.RandomState(7)
    T, L, S = cfg.num_frames, cfg.htsat.frontend.clip_samples, cfg.swin.img_size
    wave = (0.3 * rs.randn(PAR_EVAL_BATCH, T, L)).clip(-1, 1).astype(np.float32)
    frames = rs.randn(PAR_EVAL_BATCH, T, S, S, 3).astype(np.float32)
    return wave, frames


def par_eval_model(cfg, device, dtype):
    """The eval worlds' weights: seeded_model's, adapters folded (K3 takes
    them), cast to `dtype` once; and the config of that compute dtype."""
    import dataclasses
    from dg_sct_tpu_torch.models.ave import cast_for_compute
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval

    params, state = seeded_model(cfg, device=device)
    params, state = fold_adapters_eval(params, state, cfg)
    return (cast_for_compute(params, dtype), state,
            dataclasses.replace(cfg, compute_dtype=dtype))


def par_dp_batch(cfg):
    """The DP step's seeded global batch, with mixup lambdas (numpy)."""
    from dg_sct_tpu_torch.data.ave import synthetic_batch

    T = cfg.num_frames
    b = synthetic_batch(PAR_BATCH, img_size=cfg.swin.img_size, num_segments=T,
                        sr=cfg.htsat.frontend.clip_samples, seed=3)
    b["mixup_lambda"] = np.random.RandomState(3).beta(0.5, 0.5, size=(PAR_BATCH * T,)).astype(
        np.float32)
    return b


def par_dp_step(cfg, device, group, rows, *, dtype=torch.float32, seed=PAR_SEED,
                reverse=False):
    """One AVE train mini-step (accum 1, Adam at PAR_LR, remat "full") in
    `dtype` from seeded_model's weights on `rows(batch)` with mixup and a
    generator of `seed` (SpecAugment, drop_path, dropout; None: no draws);
    `reverse`: the global batch's clips in reverse order -> (loss, new
    trainable, new state, launches, seconds, Adam's first moment)."""
    import dataclasses
    from dg_sct_tpu_torch.configs import TrainConfig
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.train import ave_train
    from dg_sct_tpu_torch.utils.tree import tree_map

    params, state = seeded_model(cfg, device=device)
    params, state = (tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)
                     for tree in (params, state))
    tr, fr = ave_train.partition_params(params)
    opt = ave_train.make_optimizer(tr, TrainConfig(accum_steps=1, lr=PAR_LR, lr_mlp=PAR_LR),
                                   steps_per_epoch=1)
    step = ave_train.make_train_step(dataclasses.replace(cfg, compute_dtype=dtype), opt,
                                     device=device, group=group)
    b = par_dp_batch(cfg)
    if reverse:
        b = {k: np.ascontiguousarray(v.reshape((PAR_BATCH, -1) + v.shape[1:])[::-1].reshape(v.shape))
             for k, v in b.items()}
    batch = {k: torch.as_tensor(v, device=device) for k, v in rows(b).items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    gen = None
    if seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    torch.cuda.synchronize(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    tr, state, opt_state, m = step(tr, fr, state, opt.init(tr), batch, gen)
    loss = float(m["loss"])
    return loss, tr, state, launch_counts(), time.perf_counter() - t0, opt_state["mu"]


def par_task_steps(device, group, rows):
    """One AVS-S4 and one AVQA stage-2 train step at full width (f32, no
    generator) on this rank's rows of a global batch of 4 -> their losses."""
    from dg_sct_tpu_torch import configs
    from dg_sct_tpu_torch.configs import TrainConfig
    from dg_sct_tpu_torch.data.avqa import synthetic_batch as avqa_batch
    from dg_sct_tpu_torch.data.avs import synthetic_batch as avs_batch
    from dg_sct_tpu_torch.train import ave_train, avqa_train, avs_train

    losses = {}
    for task, cfg in (("avs", configs.AVSModelConfig()), ("avqa", configs.AVQAModelConfig())):
        if task == "avs":
            params, state = seeded_avs_model(cfg, device=device)
            batch = avs_batch(4, img_size=cfg.mask_size, seed=5, mask_frames=1,
                              num_frames=cfg.num_frames, sr=cfg.htsat.frontend.clip_samples)
        else:
            params, state = seeded_avqa_model(cfg, device=device)
            batch = avqa_batch(4, img_size=cfg.swin.img_size, num_frames=cfg.num_frames,
                               seed=5, sr=AVQA_SEGMENT)
        tr, fr = ave_train.partition_params(params)
        opt = ave_train.make_optimizer(tr, TrainConfig(accum_steps=1, lr=1e-4, lr_mlp=1e-4),
                                       steps_per_epoch=1)
        make = avs_train.make_train_step if task == "avs" else avqa_train.make_train_step
        kw = {"task": "s4"} if task == "avs" else {}
        step = make(cfg, opt, device=device, group=group, **kw)
        local = {k: torch.as_tensor(v, device=device) for k, v in rows(batch).items()}
        _, _, _, m = step(tr, fr, state, opt.init(tr), local)
        losses[task] = float(m["loss"])
        del params, state, tr, fr, opt, step, local
        torch.cuda.empty_cache()
    return losses


def par_eval(mode, cfg, device, mesh_, dtype):
    """One eval forward (kernels on) in `dtype` of this rank's part under
    `mode` (None: one process) -> ({output: numpy} of PAR_OUTPUTS,
    launches, seconds, bytes of the params it holds, bytes of those under
    swin and htsat)."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dg_sct_tpu_torch.parallel import mesh as M
    from dg_sct_tpu_torch.parallel.tp import TensorParallel
    from dg_sct_tpu_torch.utils.tree import tree_paths

    params, state, ecfg = par_eval_model(cfg, device, dtype)
    wave, frames = par_eval_inputs(cfg)
    batch, kw = {"wave": wave, "image": frames}, {}
    if mode in ("tp", "tp4"):
        params = M.tp_shard_params(params, mesh_)
        kw["tp"] = TensorParallel(mesh_.group(M.MODEL_AXIS))
        torch.cuda.empty_cache()
    elif mode == "sp":
        batch = M.shard_batch_seq(batch, mesh_)
        kw["seq"] = mesh_.group(M.SEQ_AXIS)
    elif mode == "pipe":
        kw["pipeline"] = (mesh_.group(M.PIPE_AXIS), PIPE_MICRO)
    nbytes = lambda keep: sum(t.numel() * t.element_size() for p, t in tree_paths(params)
                              if keep(p))
    run = lambda: ave.forward(params, state, batch["wave"], batch["image"], ecfg, kernels=True,
                              device=device, **kw)
    with torch.inference_mode():
        run()                                      # warm-up: cuBLAS, the libraries' loads
        torch.cuda.synchronize(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    res = {"out": {k: out[k].float().cpu().numpy() for k in PAR_OUTPUTS},
           "launches": launch_counts(), "seconds": dt, "bytes": nbytes(lambda p: True),
           "tower_bytes": nbytes(lambda p: p[0] in ("swin", "htsat"))}
    if mode == "pipe":
        res["pipelined"] = list(out["pipelined_stages"])
    return res


def pipe_grad_model(cfg, device, dtype):
    """seeded_model's weights in `dtype`, every float param leaf requiring grad."""
    from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_map

    params, state = (tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)
                     for tree in seeded_model(cfg, device=device))
    for t in tree_leaves(params):
        if t.is_floating_point():
            t.requires_grad_()
    return params, state


def pipe_grad(cfg, device, model, pipeline=None, kernels=False):
    """One backward through the AVE eval forward (`pipeline` = (pipe group,
    n_micro), or one process) of `model` (pipe_grad_model's) on the first
    PIPE_GRAD_FRAMES segments of par_eval_inputs' first clip; loss sum(w *
    event_scores) + sum(w' * is_event_scores), w and w' seeded -> (loss,
    {path: gradient or None} of the leaves under PIPE_GRAD_PARTS)."""
    import dataclasses
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.utils.tree import tree_paths

    params, state = model
    dtype = params["swin"]["patch_embed"]["kernel"].dtype
    wave, frames = (a[:1, :PIPE_GRAD_FRAMES] for a in par_eval_inputs(cfg))
    kw = {} if pipeline is None else {"pipeline": pipeline}
    ecfg = dataclasses.replace(cfg, compute_dtype=dtype, num_frames=PIPE_GRAD_FRAMES)
    out = ave.forward(params, state, wave, frames, ecfg, kernels=kernels, device=device, **kw)
    rs = np.random.RandomState(11)
    loss = sum((torch.as_tensor(rs.randn(*out[k].shape), device=device, dtype=dtype) * out[k]).sum()
               for k in PAR_OUTPUTS)
    keep = [(p, t) for p, t in tree_paths(params) if p[0] in PIPE_GRAD_PARTS and t.requires_grad]
    grads = torch.autograd.grad(loss, [t for _, t in keep], allow_unused=True)
    return float(loss.detach()), {"/".join(map(str, p)): g for (p, _), g in zip(keep, grads)}


def par_pipe_grad(cfg, device, mesh_, rank, world):
    """Phase 18's pipe backward on this rank, float64 then float32: the
    pipelined gradient (the world's time, this rank's peak), then one
    process's gradient of the unpipelined forward on the same weights, on
    every rank at once -> per dtype the loss, times, peaks and, per leaf this
    rank got, (sum (g - ref)^2, sum ref^2); rank 0 also one process's own
    float32 move from float64; then whether the pipelined forward with the
    kernels on raised."""
    import torch.distributed as dist
    from dg_sct_tpu_torch.parallel import mesh as M

    group = mesh_.group(M.PIPE_AXIS)
    res, ref64 = {}, None
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        model = pipe_grad_model(cfg, device, dtype)
        dist.barrier(group)
        t0 = time.perf_counter()
        loss, grads = pipe_grad(cfg, device, model, pipeline=(group, PIPE_GRAD_MICRO))
        torch.cuda.synchronize(device)
        dist.barrier(group)
        r = {"loss": loss, "seconds": time.perf_counter() - t0,
             "peak": torch.cuda.max_memory_allocated(device), "leaves": {}, "unused": []}
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        r["ref_loss"], ref = pipe_grad(cfg, device, model)
        torch.cuda.synchronize(device)
        r["ref_seconds"] = time.perf_counter() - t0
        r["ref_peak"] = torch.cuda.max_memory_allocated(device)
        r["read"] = sum(g is not None for g in ref.values())
        for path, g in grads.items():
            want = ref[path]
            if want is None:
                r["unused"].append(path)
            elif g is not None:
                r["leaves"][path] = (float(((g.double() - want.double()) ** 2).sum()),
                                     float((want.double() ** 2).sum()))
        if rank == 0 and dtype == torch.float64:
            ref64 = {p: g for p, g in ref.items() if g is not None}
        elif rank == 0:
            num = sum(float(((ref[p].double() - g) ** 2).sum()) for p, g in ref64.items())
            den = sum(float((g ** 2).sum()) for g in ref64.values())
            res["move"] = (num / den) ** 0.5
            ref64 = None
        del ref, grads
        res[name] = r
        dist.barrier(group)
    torch.cuda.empty_cache()
    try:
        pipe_grad(cfg, device, model, pipeline=(group, PIPE_GRAD_MICRO), kernels=True)
        res["kernels_error"] = None
    except RuntimeError as e:
        res["kernels_error"] = str(e)
    del model
    torch.cuda.empty_cache()
    dist.barrier(group)
    return res


def par_check_pipe_grad(ranks, card, bad):
    """Print and check the pipe backward of every rank against one process's."""
    g = [r["pipe_grad"] for r in ranks]
    move = g[0]["move"]
    for name, bound in (("f64", PIPE_GRAD_F64_RTOL), ("f32", PIPE_GRAD_F32_FACTOR * move)):
        per = [x[name] for x in g]
        paths = set().union(*(x["leaves"] for x in per))
        unused = set(per[0]["unused"])
        # a leaf on several ranks (outside stage 2's pairs) counts with its worst rank's error
        num = sum(max(x["leaves"][p][0] for x in per if p in x["leaves"]) for p in paths)
        den = sum(next(x["leaves"][p][1] for x in per if p in x["leaves"]) for p in paths)
        err = (num / den) ** 0.5
        each = [(sum(v[0] for v in x["leaves"].values())
                 / sum(v[1] for v in x["leaves"].values())) ** 0.5 for x in per]
        print(f"parallel pipe grad {name}: {len(ranks)} ranks, {PIPE_GRAD_FRAMES} rows (one clip's "
              f"first segments) in {PIPE_GRAD_MICRO} microbatches, kernels off: world {max(x['seconds'] for x in per):.3f} s "
              f"(forward and backward), peak {[round(x['peak'] / 2**30, 3) for x in per]} GiB, loss "
              f"{per[0]['loss']:.9e} (one process {per[0]['ref_loss']:.9e}, on every rank at once "
              f"{max(x['ref_seconds'] for x in per):.3f} s, a rank's peak then "
              f"{max(x['ref_peak'] for x in per) / 2**30:.3f} GiB); relative L2 from one process "
              f"over {len(paths)} leaves of {'/'.join(PIPE_GRAD_PARTS)} {err:.3e}, each rank's "
              f"{[f'{e:.3e}' for e in each]} (bound {bound:.3e}"
              + (f" = {PIPE_GRAD_F32_FACTOR} x one process's own f32 move from f64 {move:.3e}"
                 if name == "f32" else "") + f"); {len(unused)} leaves unread ({card})",
              flush=True)
        if not err <= bound or not all(e <= bound for e in each):
            bad.append(f"pipe grad {name}: relative L2 {err:.3e} from one process")
        if any(set(x["unused"]) != unused for x in per) or len(paths) != per[0]["read"]:
            bad.append(f"pipe grad {name}: {len(paths)} leaves got a gradient on some rank of "
                       f"{per[0]['read']} the forward reads")
    errs = [x["kernels_error"] for x in g]
    print(f"parallel pipe grad kernels on: every rank raised {all(e and 'no backward' in e for e in errs)}"
          f" ({(errs[0] or 'no error').splitlines()[0][:120]})", flush=True)
    if not all(e and "no backward" in e for e in errs):
        bad.append("pipe grad: the forward with the kernels on did not refuse the gradient")


def par_evals(mode, cfg, device, mesh_, res):
    """`mode`'s bf16 and float32 eval forwards into res[mode] and
    res[mode + "_f32"], each with this rank's peak memory."""
    for key, dtype in ((mode, torch.bfloat16), (mode + "_f32", torch.float32)):
        torch.cuda.reset_peak_memory_stats(device)
        res[key] = par_eval(mode, cfg, device, mesh_, dtype)
        res[key]["peak"] = torch.cuda.max_memory_allocated(device)
        torch.cuda.empty_cache()


def par_rank(rank, world, init_file, job, out_dir, results):
    """One rank of a phase-18 world: "dp_eval" (2 ranks: the DP AVE step in
    float32 and in float64, the AVS-S4 and AVQA stage-2 DP steps, SP eval
    over data 1 x seq 2, TP eval over data 1 x model 2), "tp4" (TP4_RANKS
    ranks: TP eval over data 1 x model 4) or "pipe" (PIPE_RANKS ranks). Puts (rank, "ok", readings) or (rank, "error",
    traceback) on `results`."""
    import traceback
    import torch.distributed as dist

    try:
        backend = par_world_backend(world)
        device = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from dg_sct_tpu_torch.configs import AVEModelConfig
        from dg_sct_tpu_torch.parallel import mesh as M
        from dg_sct_tpu_torch.utils.tree import tree_leaves

        M.init_world(backend, f"file://{init_file}", rank, world)
        cfg, res = AVEModelConfig(), {"backend": backend, "device": str(device)}
        if job == "dp_eval":
            data = M.make_mesh(world)
            group = data.group(M.DATA_AXIS)
            rows = lambda b: M.shard_batch(b, data)
            for key, dtype in (("dp", torch.float32), ("dp_f64", torch.float64)):
                torch.cuda.reset_peak_memory_stats(device)
                loss, tr, state, counts, dt, mu = par_dp_step(cfg, device, group, rows,
                                                              dtype=dtype)
                # every rank's trainable leaves against rank 0's, bit for bit
                flat = torch.cat([t.reshape(-1) for t in tree_leaves(tr)])
                ref = flat.clone()
                dist.broadcast(ref, src=0, group=group)
                res[key] = {"loss": loss, "launches": counts, "seconds": dt,
                            "same_as_rank0": bool(torch.equal(flat, ref)),
                            "peak": torch.cuda.max_memory_allocated(device)}
                if rank == 0:
                    keep = {"state": state} if dtype == torch.float32 else {
                        "trainable": tr, "state": state, "mu": mu}
                    torch.save(keep, Path(out_dir) / f"{key}_rank0.pt")
                del tr, state, mu, flat, ref
                torch.cuda.empty_cache()
            res["tasks"] = par_task_steps(device, group, rows)
            for mode, shape in (("sp", {M.DATA_AXIS: 1, M.SEQ_AXIS: world}),
                                ("tp", {M.DATA_AXIS: 1, M.MODEL_AXIS: world})):
                par_evals(mode, cfg, device, M.Mesh(shape), res)
        elif job == "tp4":
            par_evals("tp4", cfg, device, M.Mesh({M.DATA_AXIS: 1, M.MODEL_AXIS: world}), res)
        else:
            pipe = M.make_mesh(world, M.PIPE_AXIS)
            par_evals("pipe", cfg, device, pipe, res)
            res["pipe_grad"] = par_pipe_grad(cfg, device, pipe, rank, world)
        dist.destroy_process_group()
        results.put((rank, "ok", res))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def par_world(job, world, tmp):
    """`par_rank` in `world` spawned processes (spawn: this process has
    initialized CUDA) -> each rank's readings. A rank's failure, a rank that
    ends without a result, or a world past PAR_JOIN_S raises; every process
    it started is gone when it returns."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = Path(tmp) / f"{job}.rendezvous"
    procs = [ctx.Process(target=par_rank, args=(r, world, str(init_file), job, str(tmp), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors, deadline = {}, [], time.monotonic() + PAR_JOIN_S
    try:
        while len(got) < world and not errors:
            try:
                rank, status, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in got]
                if dead:
                    errors.append(f"ranks {dead} ended without a result")
                elif time.monotonic() > deadline:
                    errors.append(f"the world did not finish within {PAR_JOIN_S} s")
                continue
            if status == "ok":
                got[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            p.join(timeout=30 if errors else PAR_JOIN_S)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    if errors:
        raise AssertionError(f"parallel world {job}: " + "\n".join(errors))
    return [got[r] for r in range(world)]


def par_check_launches(mode, key, ranks, bad):
    """Each rank's launches of res[key] against PAR_LAUNCHES[mode]; returns
    their sum."""
    total = {k: 0 for k in PAR_LAUNCHES[mode]}
    for r, res in enumerate(ranks):
        got = res[key]["launches"]
        if got != PAR_LAUNCHES[mode]:
            bad.append(f"{key} rank {r}: launches {got}, expected {PAR_LAUNCHES[mode]}")
        for k in total:
            total[k] += got[k]
    return total


def par_check_eval(mode, ranks, one, drift, bad, extra=""):
    """Print and check `mode`'s bf16 and float32 evals (each rank's outputs
    against the one-process forward of its dtype, `one`) -> the bf16
    launches summed over ranks."""
    launches = None
    for key, dtype in ((mode, "bf16"), (mode + "_f32", "f32")):
        err = {k: max(float(np.abs(r[key]["out"][k] - one[dtype][k]).max()) for r in ranks)
               for k in PAR_OUTPUTS}
        bound = ({k: PAR_BF16_FACTOR * drift[k] for k in PAR_OUTPUTS} if dtype == "bf16"
                 else {k: PAR_F32_TOL for k in PAR_OUTPUTS})
        total = par_check_launches(mode, key, ranks, bad)
        launches = launches or total
        print(f"parallel {mode} {dtype}: {len(ranks)} ranks ({ranks[0]['backend']}), "
              f"B={PAR_EVAL_BATCH}: forward {max(r[key]['seconds'] for r in ranks):.3f} s, peak "
              f"{[round(r[key]['peak'] / 2**30, 3) for r in ranks]} GiB, max |delta| from one "
              f"process "
              + ", ".join(f"{k} {err[k]:.3e} (bound {bound[k]:.3e})" for k in PAR_OUTPUTS)
              + f", launches a rank {ranks[0][key]['launches']}{extra if dtype == 'bf16' else ''}",
              flush=True)
        for k in PAR_OUTPUTS:
            if not err[k] <= bound[k]:
                bad.append(f"{mode} {dtype}: {k} {err[k]:.3e} from the one-process forward")
    return launches


def run_parallel(device="cuda"):
    """Phase 18 -> {mode: bf16 launches summed over ranks}."""
    import tempfile
    from dg_sct_tpu_torch.configs import AVEModelConfig
    from dg_sct_tpu_torch.train import ave_main
    from dg_sct_tpu_torch.utils.tree import tree_paths
    import torch.distributed as dist

    t_phase = time.perf_counter()
    cfg, bad, launches = AVEModelConfig(), [], {}
    card = card_line()
    # one process: the eval forward in bf16 and in float32 (the bf16 bound is
    # this drift), then the train steps on the global batch
    one = {"bf16": par_eval(None, cfg, device, None, torch.bfloat16),
           "f32": par_eval(None, cfg, device, None, torch.float32)}
    drift = {k: float(np.abs(one["bf16"]["out"][k] - one["f32"]["out"][k]).max())
             for k in PAR_OUTPUTS}
    one_bytes = one["bf16"]["tower_bytes"]
    one = {k: v["out"] for k, v in one.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss1, _, st1, _, dt1, _ = par_dp_step(cfg, device, None, lambda b: b)
    one_peak = torch.cuda.max_memory_allocated()
    loss64, tr64, st64, _, dt64, mu64 = par_dp_step(cfg, device, None, lambda b: b,
                                                    dtype=torch.float64)

    def rel_l2(got, ref, keep=lambda p: True):
        """|got - ref| / |ref| over the leaves (by path) that `keep`."""
        num = sum(((got[p] - t) ** 2).sum() for p, t in ref.items() if keep(p))
        return float(torch.sqrt(num / sum((t ** 2).sum() for p, t in ref.items() if keep(p))))

    # one process's own gradient under the global batch's clips in reverse
    # order (no draws: reordered clips would take other draws), in both dtypes
    reorder = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        mu, mu_rev = (dict(tree_paths(par_dp_step(cfg, device, None, lambda b: b, dtype=dtype,
                                                  seed=None, reverse=rev)[-1]))
                      for rev in (False, True))
        reorder[name] = {part: rel_l2(mu_rev, mu, lambda p: (p[0] == "adapters") == ad)
                         for part, ad in (("adapters", True), ("the rest", False))}
        reorder[name]["all"] = rel_l2(mu_rev, mu)
        del mu, mu_rev
        torch.cuda.empty_cache()
    print(f"parallel one process: f32 train step B={PAR_BATCH} in {dt1:.3f} s, loss "
          f"{loss1:.6f}, peak {one_peak / 2**30:.3f} GiB; f64 in {dt64:.3f} s, loss {loss64:.9f}; "
          f"the gradient's relative L2 move under reordered clips: "
          + "; ".join(f"{n} " + ", ".join(f"{part} {v:.3e}" for part, v in r.items())
                      for n, r in reorder.items())
          + f"; bf16 eval's drift from f32 {', '.join(f'{k} {v:.3e}' for k, v in drift.items())}"
          f" ({card})", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = par_world("dp_eval", 2, tmp)
        dp_s = time.perf_counter() - t0
        # the data-parallel step against the one-process step on the global batch
        rel = lambda a, b: abs(a - b) / abs(b)
        state_rel = lambda got, ref: max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for (_, a), (_, b) in zip(tree_paths(got), tree_paths(ref)))
        got = torch.load(Path(tmp) / "dp_rank0.pt", map_location=device)
        dp = [r["dp"] for r in ranks]
        loss_err, st_err = rel(dp[0]["loss"], loss1), state_rel(got["state"], st1)
        got = torch.load(Path(tmp) / "dp_f64_rank0.pt", map_location=device)
        d64 = [r["dp_f64"] for r in ranks]
        loss64_err, st64_err = rel(d64[0]["loss"], loss64), state_rel(got["state"], st64)
        grad_err = rel_l2(dict(tree_paths(got["mu"])), dict(tree_paths(mu64)))
        ref_tr = dict(tree_paths(tr64))
        step_err = max(float((t - ref_tr[p]).abs().max()) for p, t in tree_paths(got["trainable"]))
        del got, st1, tr64, st64, mu64, ref_tr
        torch.cuda.empty_cache()
        print(f"parallel dp: 2 ranks ({ranks[0]['backend']}, {ranks[0]['device']} and "
              f"{ranks[1]['device']}) B={PAR_BATCH // 2} each, draws and mixup on: world "
              f"{dp_s:.1f} s; f32 step {max(r['seconds'] for r in dp):.3f} s, peak "
              f"{[round(r['peak'] / 2**30, 3) for r in dp]} GiB, loss {dp[0]['loss']:.6f} vs one "
              f"process {loss1:.6f} (rel {loss_err:.2e}, bound {PAR_STAT_RTOL}), BN state rel "
              f"{st_err:.2e} (bound {PAR_STAT_RTOL}); f64 step "
              f"{max(r['seconds'] for r in d64):.3f} s, peak "
              f"{[round(r['peak'] / 2**30, 3) for r in d64]} GiB, loss rel {loss64_err:.2e}, "
              f"BN state rel {st64_err:.2e}, gradient relative L2 {grad_err:.2e} (bounds "
              f"{PAR_F64_RTOL}), params after Adam's step max |delta| {step_err / PAR_LR:.2e} lr "
              f"(bound {PAR_F64_STEP} lr); ranks' params bit-identical "
              f"{[r['same_as_rank0'] for r in dp + d64]}; launches "
              f"{[r['launches'] for r in dp + d64]}", flush=True)
        if not (loss_err <= PAR_STAT_RTOL and st_err <= PAR_STAT_RTOL
                and loss64_err <= PAR_F64_RTOL and st64_err <= PAR_F64_RTOL
                and grad_err <= PAR_F64_RTOL and step_err <= PAR_F64_STEP * PAR_LR
                and all(r["same_as_rank0"] for r in dp + d64)):
            bad.append("dp: the data-parallel step is not the one-process step")
        if any(sum(r["launches"].values()) for r in dp + d64):
            bad.append("dp: a train step launched a kernel")
        tasks = [r["tasks"] for r in ranks]
        print(f"parallel dp tasks: AVS-S4 loss {tasks[0]['avs']:.6f}, AVQA stage-2 loss "
              f"{tasks[0]['avqa']:.6f} (2 ranks, global batch 4, f32)", flush=True)
        if not all(np.isfinite(t[k]) and t[k] == tasks[0][k] for t in tasks for k in t):
            bad.append(f"dp tasks: losses {tasks}")
        launches["sp"] = par_check_eval("sp", ranks, one, drift, bad)
        tb = [r["tp"]["tower_bytes"] for r in ranks]
        launches["tp"] = par_check_eval(
            "tp", ranks, one, drift, bad,
            f"; tower bytes a rank {tb} against one process's {one_bytes} ({tb[0] / one_bytes:.3f})")
        if max(tb) > 0.6 * one_bytes:
            bad.append("tp: a rank holds more than 0.6 of the towers")

        t0 = time.perf_counter()
        ranks = par_world("tp4", TP4_RANKS, tmp)
        tp4_s = time.perf_counter() - t0
        tb = [r["tp4"]["tower_bytes"] for r in ranks]
        launches["tp4"] = par_check_eval(
            "tp4", ranks, one, drift, bad,
            f"; tower bytes a rank {tb} against one process's {one_bytes} ({tb[0] / one_bytes:.3f});"
            f" world {tp4_s:.1f} s (budget {TP4_BUDGET_S:.0f} s)")
        if max(tb) > 0.4 * one_bytes:
            bad.append("tp4: a rank holds more than 0.4 of the towers")

        t0 = time.perf_counter()
        ranks = par_world("pipe", PIPE_RANKS, tmp)
        print(f"parallel pipe: world {time.perf_counter() - t0:.1f} s, n_micro {PIPE_MICRO}, "
              f"pipelined stages {[r['pipe']['pipelined'] for r in ranks]}", flush=True)
        launches["pipe"] = par_check_eval("pipe", ranks, one, drift, bad)
        if any(r[k]["pipelined"] != [2] for r in ranks for k in ("pipe", "pipe_f32")):
            bad.append("pipe: stage 2 was not pipelined")
        par_check_pipe_grad(ranks, card, bad)

    # ave_main through the entry point in a world of one rank under NCCL
    t0 = time.perf_counter()
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    res = ave_main.main(["--mode", "smoke", "--batch-size", "2", "--synthetic-steps", "1",
                         "--world-size", "1", "--rank", "0", "--init-method",
                         f"tcp://127.0.0.1:{port}", "--dist-backend", "nccl"])
    backend = dist.get_backend()
    dist.destroy_process_group()
    print(f"parallel ave_main: a {backend} world of one rank, --mode smoke B=2: loss "
          f"{res['loss']:.6f}, eval accuracy {res['eval_acc']:.2f} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (np.isfinite(res["loss"]) and backend == "nccl"):
        bad.append("ave_main: no finite loss in an NCCL world")
    print(f"parallel: phase 18 in {time.perf_counter() - t_phase:.1f} s ({card}); times of "
          f"several ranks on one card are not speeds of a mode: the ranks share its SMs and "
          f"hand over through host memory", flush=True)
    if bad:
        raise AssertionError("phase 18: " + "; ".join(bad))
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", action="append",
                    choices=sorted(SOURCES) + ["avs", "avs_train", "avvp", "avvp_train", "avqa",
                                               "avqa_train", "pretrain", "pretrain_train",
                                               "features", "standalone", "parallel"],
                    help="check and time only this kernel (repeatable), or run only phase "
                         "8 (avs), 9 (avs_train), 10 (avvp), 11 (avvp_train), 12 (avqa), 13 "
                         "(avqa_train), 14 (pretrain), 15 (pretrain_train), 16 (features), 17 "
                         "(standalone) or 18 (parallel); skips the other phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dg_sct_tpu_torch.configs import AVEModelConfig
    from dg_sct_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s "
          f"({build.build_dir()})", flush=True)
    for name in libs:
        entry = "?"
        for line in (build.build_dir() / f"{name}.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "Used" in line or "spill" in line:
                print(f"ptxas {name} {entry[:100]}: {line.strip()}")

    cfg = AVEModelConfig()
    rows = check_kernels(cfg, args.only)
    if args.only:
        if "avs" in args.only:
            run_avs()
        if "avs_train" in args.only:
            run_avs_training()
        if "avvp" in args.only:
            run_avvp()
        if "avvp_train" in args.only:
            run_avvp_training()
        if "avqa" in args.only:
            run_avqa()
        if "avqa_train" in args.only:
            run_avqa_training()
        if "pretrain" in args.only:
            run_pretrain()
        if "pretrain_train" in args.only:
            run_pretrain_training()
        if "features" in args.only:
            run_features()
        if "standalone" in args.only:
            run_standalone()
        par = run_parallel() if "parallel" in args.only else None
        print(json.dumps(kernels_line(rows, {name: None for name in SOURCES}, par)))
        print(card)
        print(f"partial run ({', '.join(args.only)}): no ok line", flush=True)
        return 0
    counts = run_model(cfg)
    run_serving(cfg)
    t0 = time.perf_counter()
    run_training(cfg)
    print(f"train: phase 6 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    int8_counts = run_int8(cfg)
    print(f"int8: phase 7 in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in INT8_NAMES:  # K4's main path is phase 7
        counts[name] = int8_counts[name]
    run_avs()
    run_avs_training()
    run_avvp()
    run_avvp_training()
    run_avqa()
    run_avqa_training()
    run_pretrain()
    run_pretrain_training()
    run_features()
    run_standalone()
    par = run_parallel()
    print(json.dumps(kernels_line(rows, counts, par)))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
