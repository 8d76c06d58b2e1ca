"""Kaldi-compatible log-mel filterbank in numpy, the port's copy of
`dg_sct_tpu/data/fbank.py`: the AVE loader's dormant `_wav2fbank` path
(`DG-SCT/AVE/dataloader.py:92-151`; the model consumes raw waves through the
HTS-AT frontend) and the AVS dataset's `total_audio` field
(`S4Dataset(with_log_mel=True)`).

`torchaudio.compliance.kaldi.fbank(htk_compat=True, use_energy=False,
window_type='hanning', num_mel_bins=192, dither=0.0, frame_shift=5.2)`
semantics, from the Kaldi algorithm:

  frame: 25 ms window / 5.2 ms shift, snip_edges, per-frame DC removal,
  preemphasis 0.97 (first sample against itself), symmetric Hann window,
  zero-pad to the next pow2, power spectrum;
  mel: Kaldi banks (low 20 Hz, high Nyquist, mel = 1127 ln(1+f/700)),
  log(max(e, eps)).
"""
from __future__ import annotations

import numpy as np

# AVE fbank normalization constants (dataloader.py:57-58)
AVE_NORM_MEAN = -4.984795570373535
AVE_NORM_STD = 3.7079780101776123


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def kaldi_mel_banks(num_bins, padded_window_size, sample_freq,
                    low_freq=20.0, high_freq=0.0):
    """(num_bins, padded_window_size // 2) triangular banks on the mel scale,
    Kaldi layout (torchaudio kaldi.get_mel_banks)."""
    if high_freq <= 0.0:
        high_freq = sample_freq / 2.0 + high_freq
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_freq / padded_window_size
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    delta = (mel_high - mel_low) / (num_bins + 1)
    left = mel_low + np.arange(num_bins)[:, None] * delta
    center = left + delta
    right = center + delta
    mel_of_bin = _mel(fft_bin_width * np.arange(num_fft_bins))[None, :]
    up = (mel_of_bin - left) / (center - left)
    down = (right - mel_of_bin) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def kaldi_fbank(waveform, *, sample_frequency=16000, num_mel_bins=192,
                frame_length=25.0, frame_shift=5.2, preemphasis=0.97,
                remove_dc_offset=True, eps=1.1920928955078125e-07):
    """waveform: (n,) float. Returns (num_frames, num_mel_bins) float32 —
    torchaudio kaldi.fbank(use_energy=False) with snip_edges."""
    wave = np.asarray(waveform, np.float64).reshape(-1)
    window_size = int(sample_frequency * frame_length * 0.001)
    window_shift = int(sample_frequency * frame_shift * 0.001)
    padded = 1
    while padded < window_size:
        padded *= 2
    if len(wave) < window_size:
        return np.zeros((0, num_mel_bins), np.float32)
    m = 1 + (len(wave) - window_size) // window_shift
    idx = (np.arange(m)[:, None] * window_shift + np.arange(window_size)[None, :])
    frames = wave[idx]
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis:
        shifted = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * shifted
    n = np.arange(window_size)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (window_size - 1))
    frames = frames * hann
    spec = np.abs(np.fft.rfft(frames, n=padded, axis=1)) ** 2  # (m, padded/2+1)
    banks = kaldi_mel_banks(num_mel_bins, padded, sample_frequency)
    banks = np.concatenate(
        [banks, np.zeros((num_mel_bins, 1), np.float32)], axis=1)
    mel_e = spec @ banks.T.astype(np.float64)
    return np.log(np.maximum(mel_e, eps)).astype(np.float32)


def wav2fbank(wave, idx=None, *, wave2=None, mix_lambda=None,
              audio_length=1.0, sample_rate=16000, num_mel_bins=192,
              target_length=192, norm_mean=AVE_NORM_MEAN,
              norm_std=AVE_NORM_STD):
    """The AVE `_wav2fbank` semantics (dataloader.py:92-151): mean-subtract
    (optionally mixup two waves, beta(10,10) lambda), linspace-sample segment
    `idx` of 10, Kaldi fbank, normalize (x - mean)/(2 std), pad/cut rows to
    `target_length`. Returns (target_length, num_mel_bins) float32."""
    w = np.asarray(wave, np.float32).reshape(-1)
    w = w - w.mean()
    if wave2 is not None:
        w2 = np.asarray(wave2, np.float32).reshape(-1)
        w2 = w2 - w2.mean()
        if len(w2) < len(w):
            w2 = np.pad(w2, (0, len(w) - len(w2)))
        else:
            w2 = w2[: len(w)]
        lam = np.random.beta(10, 10) if mix_lambda is None else mix_lambda
        w = lam * w + (1 - lam) * w2
        w = w - w.mean()
    seg = int(sample_rate * audio_length)
    if idx is not None and len(w) > sample_rate * (audio_length + 0.1):
        starts = np.linspace(0, len(w) - sample_rate * (audio_length + 0.1),
                             num=10, dtype=int)
        w = w[starts[idx]: starts[idx] + seg]
    fb = kaldi_fbank(w, sample_frequency=sample_rate,
                     num_mel_bins=num_mel_bins, frame_shift=5.2)
    fb = (fb - norm_mean) / (norm_std * 2.0)
    p = target_length - fb.shape[0]
    if p > 0:
        fb = np.pad(fb, ((0, p), (0, 0)))
    else:
        fb = fb[:target_length]
    return fb.astype(np.float32)
