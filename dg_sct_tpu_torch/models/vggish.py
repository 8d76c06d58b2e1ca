"""VGGish audio embeddings over the JAX package's tree
(`dg_sct_tpu/models/vggish.py`): the 0.96 s log-mel example frontend
(`waveform_to_examples`, numpy on the host), the VGG network (`vggish`:
(N, 96, 64, 1) examples -> (N, 128)) and the PCA postprocessor with its
8-bit quantize (`postprocess`). The reference builds VGGish for AVS but
reads HTS-AT instead; `utils.torch_convert.convert_vggish` and
`convert_vggish_pca` load torchvggish's weights.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.basic import Init, conv2d, conv2d_init, linear, linear_init, max_pool2d

SAMPLE_RATE = 16000
STFT_WINDOW_S = 0.025
STFT_HOP_S = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_S = 0.96   # 96 frames of 10 ms
EMBEDDING_SIZE = 128
N_FFT = 512

_LAYOUT = ((64,), (128,), (256, 256), (512, 512))  # convolutions between the 2x2 pools


def init_vggish(init: Init):
    convs, in_ch = [], 1
    for blk in _LAYOUT:
        for out_ch in blk:
            convs.append(conv2d_init(init, 3, 3, in_ch, out_ch))
            in_ch = out_ch
    return {"convs": convs,
            "fc1": linear_init(init, 512 * 4 * 6, 4096),
            "fc2": linear_init(init, 4096, 4096),
            "fc3": linear_init(init, 4096, EMBEDDING_SIZE)}


def vggish(params, x):
    """x (N, 96, 64, 1) log-mel examples -> (N, 128) embeddings. The
    channels-last maps flatten in the order torchvggish gets by moving
    channels last before its view."""
    ci = 0
    for blk in _LAYOUT:
        for _ in blk:
            x = torch.relu(conv2d(params["convs"][ci], x))
            ci += 1
        x = max_pool2d(x, 2, 2)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(linear(params["fc1"], x))
    x = torch.relu(linear(params["fc2"], x))
    return torch.relu(linear(params["fc3"], x))


@functools.lru_cache(maxsize=None)
def _mel_matrix():
    """(257, 64) HTK-scale triangles, 125 to 7500 Hz, the DC row zeroed."""
    fft_freqs = np.linspace(0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    htk = lambda f: 1127.0 * np.log1p(np.asarray(f) / 700.0)
    edges = np.linspace(htk(MEL_MIN_HZ), htk(MEL_MAX_HZ), NUM_MEL_BINS + 2)
    spec_mel = htk(fft_freqs)
    weights = np.zeros((len(fft_freqs), NUM_MEL_BINS))
    for i in range(NUM_MEL_BINS):
        lo, c, hi = edges[i:i + 3]
        weights[:, i] = np.maximum(0.0, np.minimum((spec_mel - lo) / (c - lo),
                                                   (hi - spec_mel) / (hi - c)))
    weights[0, :] = 0.0
    return weights.astype(np.float32)


def waveform_to_examples(wave) -> np.ndarray:
    """(L,) 16 kHz wave -> (n_examples, 96, 64, 1) float32 log-mel examples:
    25 ms symmetric Hann window (numpy's), 10 ms hop, 512-point FFT
    magnitude, HTK mel, log(mel + 0.01), non-overlapping 0.96 s examples."""
    wave = np.asarray(wave, np.float32)
    win = int(round(SAMPLE_RATE * STFT_WINDOW_S))
    hop = int(round(SAMPLE_RATE * STFT_HOP_S))
    n_frames = 1 + (len(wave) - win) // hop
    if n_frames < 1:
        return np.zeros((0, 96, NUM_MEL_BINS, 1), np.float32)
    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wave[idx] * np.hanning(win).astype(np.float32)
    spec = np.abs(np.fft.rfft(frames, N_FFT)).astype(np.float32)
    logmel = np.log(spec @ _mel_matrix() + np.float32(LOG_OFFSET))
    ex = int(round(EXAMPLE_WINDOW_S / STFT_HOP_S))
    n_ex = logmel.shape[0] // ex
    return logmel[:n_ex * ex].reshape(n_ex, ex, NUM_MEL_BINS, 1).astype(np.float32)


def init_postprocessor(init: Init):
    return {"pca_matrix": init.normal((EMBEDDING_SIZE, EMBEDDING_SIZE), 0.1),
            "pca_means": init.zeros((EMBEDDING_SIZE,))}


def postprocess(params, embeddings, quantize=True):
    """PCA, then optionally clipped to [-2, 2] and quantized to 0..255."""
    x = (embeddings - params["pca_means"]) @ params["pca_matrix"].T
    if quantize:
        x = torch.round((torch.clamp(x, -2.0, 2.0) + 2.0) * (255.0 / 4.0))
    return x
