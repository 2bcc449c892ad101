"""Numpy golden reference for the audio front-end.

The port's own copy of the JAX package's ``ops/frontend_ref.py``: the
float64 oracle that ``mlvae_tpu_torch.ops.fbank`` and its CUDA kernel K6
are held against (gate: <=1e-4 max rel-err, denominator floored at 1e-3).
It implements, in plain numpy, the semantics of the two feature paths the
reference uses:

1. The Kaldi pipeline invoked by subprocess in the reference
   (``compute-fbank-feats --window-type=hamming --htk-compat=true
   --dither=0.0 --energy-floor=1.0 --snip-edges=false`` + ``add-deltas`` +
   per-speaker ``compute-cmvn-stats``/``apply-cmvn --norm-vars=true``;
   reference ``utils/data_io_utils.py:156-206``).  Semantics implemented
   from the Kaldi feature documentation: snip-edges=false centered frames
   with edge reflection, DC-offset removal, 0.97 pre-emphasis, symmetric
   Hamming window, power-of-two padded FFT, mel triangles on the
   1127*ln(1+f/700) scale between 20 Hz and Nyquist, natural-log energies
   floored at float epsilon.  (``--htk-compat`` only reorders the energy
   coefficient, and ``--energy-floor`` only applies when ``--use-energy``;
   neither affects output with the reference's flags.)

2. The SpeechBrain in-graph ``Fbank`` (reference ``config/run.yaml:39-44``):
   torch.stft with center=True constant padding, periodic Hamming window,
   power spectrum, triangular-in-Hz mel filters on the 2595*log10(1+f/700)
   scale, 10*log10 dB scaling with amin=1e-10 and top_db=80, plus
   5-point delta/delta-delta appended (output dim = n_mels * 3).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

EPS_F32 = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def mel_kaldi(hz):
    return 1127.0 * np.log1p(np.asarray(hz, np.float64) / 700.0)


def mel_htk10(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def kaldi_mel_banks(n_mels: int, padded_n: int, sr: int,
                    low_freq: float = 20.0, high_freq: float = 0.0):
    """(n_mels, padded_n//2+1) triangular weights, mel-domain triangles."""
    if high_freq <= 0:
        high_freq = sr / 2.0 + high_freq
    n_bins = padded_n // 2 + 1
    fft_freqs = np.arange(n_bins) * (sr / padded_n)
    mel_low, mel_high = mel_kaldi(low_freq), mel_kaldi(high_freq)
    delta = (mel_high - mel_low) / (n_mels + 1)
    mels = mel_kaldi(fft_freqs)
    banks = np.zeros((n_mels, n_bins), np.float64)
    for m in range(n_mels):
        left = mel_low + m * delta
        center = left + delta
        right = center + delta
        up = (mels - left) / (center - left)
        down = (right - mels) / (right - center)
        banks[m] = np.clip(np.minimum(up, down), 0.0, None)
    return banks


# ---------------------------------------------------------------------------
# Kaldi-compatible fbank
# ---------------------------------------------------------------------------

def kaldi_num_frames(num_samples: int, shift: int) -> int:
    # snip_edges=false
    return (num_samples + shift // 2) // shift


def _reflect_index(j: np.ndarray, length: int) -> np.ndarray:
    # closed form of Kaldi's iterated reflection
    # (while s<0 or s>=L: s = s<0 ? -s-1 : 2L-1-s), period 2L — exact for
    # any index, including utterances shorter than half a window
    m = np.mod(j, max(2 * length, 1))
    return np.where(m >= length, 2 * length - 1 - m, m)


def kaldi_fbank(
    wave: np.ndarray,
    sr: int = 16000,
    frame_shift_ms: float = 20.0,
    frame_length_ms: float = 25.0,
    n_mels: int = 40,
    preemph: float = 0.97,
    remove_dc: bool = True,
) -> np.ndarray:
    """(L,) float waveform (int16-scale values) -> (T, n_mels) log-mel."""
    wave = np.asarray(wave, np.float64)
    shift = int(sr * frame_shift_ms / 1000)
    window = int(sr * frame_length_ms / 1000)
    padded = next_pow2(window)
    L = len(wave)
    T = kaldi_num_frames(L, shift)

    t = np.arange(T)[:, None]
    j = t * shift + shift // 2 - window // 2 + np.arange(window)[None, :]
    frames = wave[_reflect_index(j, L)]  # (T, W)

    if remove_dc:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemph > 0:
        shifted = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemph * shifted

    n = np.arange(window)
    ham = 0.54 - 0.46 * np.cos(2 * np.pi * n / (window - 1))  # symmetric
    frames = frames * ham

    spec = np.fft.rfft(frames, n=padded, axis=1)
    power = np.abs(spec) ** 2  # (T, padded//2+1)

    banks = kaldi_mel_banks(n_mels, padded, sr)
    mel = power @ banks.T
    return np.log(np.maximum(mel, EPS_F32)).astype(np.float32)


def kaldi_delta_scales(order: int = 2, window: int = 2):
    """Kaldi ``DeltaFeatures`` composite filters (feature-functions.cc):
    each order's filter is the previous order's filter CONVOLVED with the
    +-window regression kernel; the composite is then applied to the
    ORIGINAL features with one edge clamp.  (Iterating the regression with
    per-order clamping — the previous implementation here — deviates from
    Kaldi by up to ~0.15 on the first/last frames.)"""
    scales = [np.asarray([1.0])]
    norm = float(sum(j * j for j in range(-window, window + 1)))
    for _ in range(order):
        prev = scales[-1]
        prev_off = (len(prev) - 1) // 2
        cur_off = prev_off + window
        cur = np.zeros(len(prev) + 2 * window)
        for j in range(-window, window + 1):
            for k in range(-prev_off, prev_off + 1):
                cur[j + k + cur_off] += j * prev[k + prev_off]
        scales.append(cur / norm)
    return scales


def kaldi_deltas(feats: np.ndarray, order: int = 2, window: int = 2):
    """Kaldi ``add-deltas``: composite filters over the original features,
    indices clamped at utterance edges.  Returns (T, C*(order+1))."""
    T = feats.shape[0]
    x = np.asarray(feats, np.float64)
    outs = []
    for sc in kaldi_delta_scales(order, window):
        off = (len(sc) - 1) // 2
        acc = np.zeros_like(x)
        for j in range(-off, off + 1):
            if sc[j + off] == 0.0:
                continue
            idx = np.clip(np.arange(T) + j, 0, T - 1)
            acc += sc[j + off] * x[idx]
        outs.append(acc)
    return np.concatenate(outs, axis=1).astype(np.float32)


def cmvn_stats(utts: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, float]:
    """Accumulate per-speaker sufficient statistics (sum, sumsq, count)."""
    total = np.zeros(utts[0].shape[1], np.float64)
    sq = np.zeros(utts[0].shape[1], np.float64)
    count = 0.0
    for u in utts:
        total += u.sum(axis=0)
        sq += (np.asarray(u, np.float64) ** 2).sum(axis=0)
        count += u.shape[0]
    return total, sq, count


def apply_cmvn(feats: np.ndarray, total, sq, count, norm_vars=True):
    mean = total / count
    out = feats - mean
    if norm_vars:
        var = np.maximum(sq / count - mean ** 2, 1e-20)
        out = out / np.sqrt(var)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# SpeechBrain-compatible fbank
# ---------------------------------------------------------------------------

def sb_mel_banks(n_mels: int, n_fft: int, sr: int,
                 f_min: float = 0.0, f_max: float = 8000.0):
    """Triangular filters computed in the Hz domain on 2595*log10 mel points."""
    n_bins = n_fft // 2 + 1
    all_freqs = np.linspace(0, sr / 2, n_bins)
    mel_pts = np.linspace(mel_htk10(f_min), mel_htk10(f_max), n_mels + 2)
    hz_pts = 700.0 * (10.0 ** (mel_pts / 2595.0) - 1.0)
    f_left, f_center, f_right = hz_pts[:-2], hz_pts[1:-1], hz_pts[2:]
    banks = np.zeros((n_mels, n_bins), np.float64)
    for m in range(n_mels):
        up = (all_freqs - f_left[m]) / (f_center[m] - f_left[m])
        down = (f_right[m] - all_freqs) / (f_right[m] - f_center[m])
        banks[m] = np.clip(np.minimum(up, down), 0.0, None)
    return banks


def sb_fbank(
    wave: np.ndarray,
    sr: int = 16000,
    hop_ms: float = 20.0,
    n_fft: int = 400,
    n_mels: int = 40,
    top_db: float = 80.0,
    amin: float = 1e-10,
) -> np.ndarray:
    """(L,) waveform -> (T, n_mels) dB-scaled log-mel (no deltas)."""
    wave = np.asarray(wave, np.float64)
    hop = int(sr * hop_ms / 1000)
    win = n_fft
    pad = n_fft // 2
    padded_wave = np.concatenate([np.zeros(pad), wave, np.zeros(pad)])
    T = len(wave) // hop + 1

    t = np.arange(T)[:, None]
    j = t * hop + np.arange(win)[None, :]
    frames = padded_wave[np.minimum(j, len(padded_wave) - 1)]
    n = np.arange(win)
    ham = 0.54 - 0.46 * np.cos(2 * np.pi * n / win)  # periodic window
    frames = frames * ham

    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    power = np.abs(spec) ** 2

    mel = power @ sb_mel_banks(n_mels, n_fft, sr).T
    db = 10.0 * np.log10(np.maximum(mel, amin))
    db = np.maximum(db, db.max() - top_db)
    return db.astype(np.float32)


def sb_deltas(feats: np.ndarray, window: int = 2):
    """SpeechBrain Deltas: one +-2 regression pass, replicate padding."""
    T = feats.shape[0]
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    acc = np.zeros_like(np.asarray(feats, np.float64))
    for k in range(1, window + 1):
        plus = feats[np.minimum(np.arange(T) + k, T - 1)]
        minus = feats[np.maximum(np.arange(T) - k, 0)]
        acc += k * (plus - minus)
    return (acc / denom).astype(np.float32)


def sb_fbank_with_deltas(wave: np.ndarray, **kw) -> np.ndarray:
    f = sb_fbank(wave, **kw)
    d1 = sb_deltas(f)
    d2 = sb_deltas(d1)
    return np.concatenate([f, d1, d2], axis=1)
