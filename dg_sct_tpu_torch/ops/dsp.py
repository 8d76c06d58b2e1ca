"""Audio DSP frontend: wave -> power spectrogram -> log-mel -> mel "image".

Every stage is a dense matmul against a constant matrix built in numpy
(windowed DFT basis, slaney mel bank, bicubic resize matrix): torchlibrosa
`Spectrogram`/`LogmelFilterBank` semantics (n_fft 1024, hop 320, hann,
center=True, reflect pad, power 2, slaney mel, ref 1, amin 1e-10) and the
reference HTS-AT `reshape_wav2img` (bicubic, align_corners=True).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import AudioFrontendConfig
from ..device import constant
from ..parallel.comm import gather_rows, rank_and_size
from .draws import draw


# ---------------------------------------------------------------------------
# constant matrices (numpy, built once per configuration)
# ---------------------------------------------------------------------------

def hann_window(n: int) -> np.ndarray:
    """Periodic Hann (torch.hann_window default)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=None)
def dft_basis(n_fft: int):
    """Windowed real-DFT bases: (n_fft, n_fft//2+1) cos and -sin matrices."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    w = hann_window(n_fft)[:, None]
    return (np.cos(ang) * w).astype(np.float32), (-np.sin(ang) * w).astype(np.float32)


@functools.lru_cache(maxsize=None)
def stft_basis(n_fft: int) -> np.ndarray:
    """(n_fft, 2 (n_fft//2+1)): the cos and -sin bases side by side."""
    return np.concatenate(dft_basis(n_fft), axis=1)


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    mel = 3.0 * f / 200.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep, mel)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = 200.0 * m / 3.0
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), f)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') transposed to
    (n_fft//2+1, n_mels)."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz_slaney(np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax),
                                           n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def _cubic_kernel(x, a=-0.75):
    x = np.abs(x)
    return np.where(x <= 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, *, kernel: str = "cubic",
                  align_corners: bool = True) -> np.ndarray:
    """(n_out, n_in) matrix M with (M @ x) == torch F.interpolate along one
    axis (mode 'bicubic' or 'bilinear', with the align_corners semantics)."""
    M = np.zeros((n_out, n_in), np.float64)
    if n_in == n_out and align_corners:
        return np.eye(n_out, dtype=np.float32)
    if align_corners:
        scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        src = np.arange(n_out) * scale
    else:
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    if kernel == "cubic":
        taps, kfn = range(-1, 3), _cubic_kernel
    else:
        taps, kfn = range(0, 2), lambda x: np.maximum(0.0, 1.0 - np.abs(x))
    for tap in taps:
        idx = np.clip(i0 + tap, 0, n_in - 1)
        np.add.at(M, (np.arange(n_out), idx), kfn(tap - frac))
    return M.astype(np.float32)


def bicubic_resize_matrix(n_in: int, n_out: int, align_corners: bool = True) -> np.ndarray:
    return resize_matrix(n_in, n_out, kernel="cubic", align_corners=align_corners)


def _resize_basis(n_in: int, n_out: int, kernel: str, align_corners: bool) -> np.ndarray:
    """`resize_matrix` with positional arguments only, as `device.constant`
    takes them."""
    return resize_matrix(n_in, n_out, kernel=kernel, align_corners=align_corners)


# ---------------------------------------------------------------------------
# forward ops
# ---------------------------------------------------------------------------

def resize_2d(x, out_h: int, out_w: int, *, kernel: str = "cubic", align_corners: bool = False):
    """(N, H, W, C) -> (N, out_h, out_w, C): torch F.interpolate semantics as
    two products with resize matrices, held on x's device in x's type."""
    Mh = constant(_resize_basis, x.shape[1], out_h, kernel, align_corners, device=x.device,
                  dtype=x.dtype)
    Mw = constant(_resize_basis, x.shape[2], out_w, kernel, align_corners, device=x.device,
                  dtype=x.dtype)
    x = torch.einsum("oh,nhwc->nowc", Mh, x)
    return torch.einsum("ow,nhwc->nhoc", Mw, x)


def power_spectrogram(wave, cfg: AudioFrontendConfig, compute_dtype=None):
    """(N, L) -> (N, T, n_fft//2+1) power spectrogram |STFT|^2, float32
    (float64 for a float64 wave).

    Reflect pad, framing as ceil(n_fft/hop) strided views of the
    hop-chunked signal, then ONE GEMM against the windowed DFT basis.
    `compute_dtype` (e.g. torch.bfloat16) rounds frames and basis to that
    type; the products and their sum stay float32 in both cases."""
    n_fft, hop = cfg.n_fft, cfg.hop_size
    pad = n_fft // 2
    dtype = torch.promote_types(wave.dtype, torch.float32)
    x = F.pad(wave.to(dtype)[:, None], (pad, pad), mode="reflect")[:, 0]
    N, Lp = x.shape
    T = wave.shape[1] // hop + 1
    k = -(-n_fft // hop)
    need = (T + k - 1) * hop
    if Lp < need:
        x = F.pad(x, (0, need - Lp))
    chunks = x[:, :need].reshape(N, T + k - 1, hop)
    frames = torch.stack([chunks[:, j:j + T] for j in range(k)], dim=2)
    frames = frames.reshape(N, T, k * hop)[..., :n_fft]
    basis = constant(stft_basis, n_fft, device=wave.device, dtype=dtype)
    if compute_dtype is not None:
        frames = frames.to(compute_dtype).to(dtype)
        basis = basis.to(compute_dtype).to(dtype)
    y = frames @ basis
    Fb = n_fft // 2 + 1
    re, im = y[..., :Fb], y[..., Fb:]
    return re * re + im * im


def logmel(power, cfg: AudioFrontendConfig):
    """(N, T, F) power -> (N, T, mel) log-mel dB (ref 1, top_db None)."""
    bank = constant(mel_filterbank, cfg.sample_rate, cfg.n_fft, cfg.mel_bins, cfg.fmin,
                    cfg.fmax, device=power.device, dtype=power.dtype)
    return 10.0 * torch.log10(torch.clamp(power @ bank, min=cfg.amin))


def _stripes(gen, n, total, width, num, device):
    """(n, total) keep mask with `num` zero stripes a row: width w uniform in
    [0, width), start floor(u * (total - w)) with u uniform in [0, 1)."""
    w = draw(gen, lambda s, g: torch.randint(0, width, s, generator=g, device=device), (n, num))
    u = draw(gen, lambda s, g: torch.rand(s, generator=g, device=device), (n, num))
    bgn = (u * (total - w)).to(torch.int64)
    pos = torch.arange(total, device=device)[None, None]
    hit = (pos >= bgn[..., None]) & (pos < (bgn + w)[..., None])
    return ~hit.any(dim=1)


def spec_augment_masks(gen, n, T, Fm, cfg: AudioFrontendConfig, device):
    """SpecAugment's keep masks for n log-mel maps of (T, Fm): time (n, T)
    then frequency (n, Fm), drawn from `gen` in that order."""
    tmask = _stripes(gen, n, T, cfg.time_drop_width, cfg.time_stripes_num, device)
    fmask = _stripes(gen, n, Fm, cfg.freq_drop_width, cfg.freq_stripes_num, device)
    return tmask, fmask


def apply_spec_masks(x, tmask, fmask):
    """x (N, T, F) with the time and frequency stripes zeroed."""
    return x * tmask[:, :, None].to(x.dtype) * fmask[:, None, :].to(x.dtype)


def spec_augment(gen, x, cfg: AudioFrontendConfig):
    """torchlibrosa SpecAugmentation as the JAX package draws it: per
    example, random time and frequency stripes zeroed. x: (N, T, F)."""
    N, T, Fm = x.shape
    return apply_spec_masks(x, *spec_augment_masks(gen, N, T, Fm, cfg, x.device))


def do_mixup(x, lam, group=None):
    """Mixup of x (N, ...) against the batch-flipped x with (N,) weights.
    With `group` (data parallelism) x and lam are this rank's rows of the
    global batch, which is flipped as a whole: the rows come from the rank
    that holds their mirror."""
    lam = lam.reshape((x.shape[0],) + (1,) * (x.ndim - 1)).to(x.dtype)
    if group is None:
        flipped = torch.flip(x, dims=(0,))
    else:
        rank, _ = rank_and_size(group)
        n = x.shape[0]
        flipped = torch.flip(gather_rows(x, group), dims=(0,)).narrow(0, rank * n, n)
    return x * lam + flipped * (1.0 - lam)


def reshape_wav2img(x, cfg: AudioFrontendConfig):
    """(N, T, mel) -> (N, spec, spec, 1) mel image: bicubic-resize T to
    spec*freq_ratio, then fold `freq_ratio` time strips along the rows."""
    N, T, Fm = x.shape
    fr = cfg.freq_ratio
    target_t = cfg.target_t
    if T < target_t:
        M = constant(bicubic_resize_matrix, T, target_t, device=x.device, dtype=x.dtype)
        x = torch.einsum("ntf,st->nsf", x, M)
    x = x.transpose(1, 2).reshape(N, Fm, fr, target_t // fr)
    x = x.transpose(1, 2).reshape(N, fr * Fm, target_t // fr)
    return x[..., None]


def crop_mel(x, positions, crop_size: int):
    """Per-example time crop of mel features: x (N, T, F) and (N,) integer
    start frames -> (N, crop_size, F)."""
    idx = positions.to(x.device, torch.int64)[:, None] + torch.arange(crop_size, device=x.device)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def crop_positions(gen, n: int, T: int, crop_size: int, device):
    """The training crop's (n,) start frames, uniform in [0, T - crop_size),
    drawn from `gen`."""
    return draw(gen, lambda s, g: torch.randint(0, T - crop_size, s, generator=g, device=device),
                (n,))


def long_clip_eval_positions(T: int):
    """The eval long-clip branch's sliding crops of T mel frames: (start
    frames, crop size), crop (T - 1) // 2 at a (T - 1) // 4 stride."""
    crop = (T - 1) // 2
    overlap = (T - 1) // 4
    return list(range(0, T - crop - 1, overlap)), crop
