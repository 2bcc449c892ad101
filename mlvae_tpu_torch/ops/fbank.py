"""Log-mel front end, Kaldi-compatible and SpeechBrain-compatible, and its
CUDA kernel K6.

Counterpart of ``mlvae_tpu/ops/fbank.py`` (the batched extractors) and
``ops/fbank_pallas.py`` (the TPU kernel ``_fbank_kernel``). The framing
gather, the masks, SpeechBrain's top_db clamp and the deltas are torch
ops; the chain from frames to log-mels (window, DFT, power, mel, log) is
one kernel, ``csrc/fbank.cu``, with a mode for each extractor:

* ``KALDI``: frames (rows, 512) whose first ``window`` = 400 columns hold
  the frame; DC removal, 0.97 pre-emphasis, symmetric Hamming, 257 bins,
  Kaldi's mel banks, ``log(max(mel, FLT_EPSILON))``; the port of
  ``_fbank_kernel``;
* ``SB``: frames (rows, 400) already zero outside the utterance; periodic
  Hamming, 201 bins, SpeechBrain's mel banks, ``10 log10(max(mel, 1e-10))``.

K6 has two builds, chosen by the frame width N before the launch
(``fbank_plan``): ``csrc/fbank_fft.cu`` (``FBANK_FFT``) takes an even N
whose N/2 factors into 2, 3, 4 and 5 (the recipes' N = 512 and 400) and
computes the transform as a real-input FFT; ``csrc/fbank.cu`` (``FBANK``)
takes any other N up to 512 and computes it as a DFT. Neither stands in
for the other when a build or a launch fails.

``fbank_frames`` launches the kernel for CUDA tensors and runs the plain
version, ``fbank_frames_ref``, for CPU tensors only. The plain version
follows the TPU kernel's association: the window, two f32 products with
the DFT matrices, the power, a mel product, the log. Parity gate: the
float64 oracle ``ops/frontend_ref.py`` at 1e-4 relative error.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.ops import frontend_ref as ref

KALDI = "kaldi"
SB = "sb"
PREEMPH = 0.97

_P = ctypes.c_void_p
_I = ctypes.c_int

FBANK = _build.register(_build.Kernel(
    "fbank", "fbank", "mlvae_fbank",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]))
FBANK_FFT = _build.register(_build.Kernel(
    "fbank_fft", "fbank_fft", "mlvae_fbank_fft",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]))
BUILDS = {"fft": FBANK_FFT, "dft": FBANK}
MAX_N = 512   # the widest frame either build takes


# ---------------------------------------------------------------------------
# the build a frame width takes, and the FFT build's plan
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def fft_radices(m: int):
    """The radices of the FFT build's passes over m complex points, in pass
    order: fours (a two left over makes the first of them an eight, or
    stays a two), then threes, then fives; None when m has a prime factor
    above 5. 256 -> (4, 4, 4, 4); 200 -> (8, 5, 5); 240 -> (4, 4, 3, 5)."""
    if m < 1:
        return None
    rest, count = m, {}
    for f in (2, 3, 5):
        count[f] = 0
        while rest % f == 0:
            rest //= f
            count[f] += 1
    if rest != 1:
        return None
    fours, two = divmod(count[2], 2)
    radices = [4] * fours
    if two:
        radices = [8] + radices[1:] if fours else [2]
    return tuple(radices + [3] * count[3] + [5] * count[5])


def fbank_plan(n: int) -> str:
    """The build of K6 that takes frames of ``n`` columns: "fft" for an
    even n whose n/2 factors into 2, 3, 4 and 5, else "dft". Refuses
    (``ValueError``) n outside [1, 512]."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"K6 takes frames of 1 to {MAX_N} columns, not {n}")
    return "fft" if n % 2 == 0 and fft_radices(n // 2) is not None \
        else "dft"


def _packed_radices(m: int) -> int:
    """The radices as the FFT build reads them: four bits a pass, the
    first pass in the lowest bits."""
    return sum(r << (4 * i) for i, r in enumerate(fft_radices(m)))


def fft_tables(n: int) -> Dict[str, np.ndarray]:
    """The FFT build's tables for frames of n columns (m = n/2 complex
    points), each entry exp(-2 pi i a) in float64 rounded to f32, as (re,
    im) pairs: ``fft_tw`` the passes' twiddles, pass after pass, a pass of
    radix R over sub-transforms of p points holding entry (r - 1) p + k
    = exp(-2 pi i r k / (p R)) for r in [1, R), k in [0, p) (m - 1 in
    all); ``fft_split`` the split step's exp(-2 pi i k / n), k in [0, m]."""
    m = n // 2
    tw, p = [], 1
    for radix in fft_radices(m):
        r = np.arange(1, radix)[:, None]
        k = np.arange(p)[None, :]
        tw.append(np.exp(-2j * np.pi * r * k / (p * radix)).reshape(-1))
        p *= radix
    tw = np.concatenate(tw) if tw else np.zeros((0,), complex)
    split = np.exp(-2j * np.pi * np.arange(m + 1) / n)

    def pairs(z):
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return {"fft_tw": pairs(tw), "fft_split": pairs(split)}


# ---------------------------------------------------------------------------
# constants (numpy on the host, cached; device copies cached per device)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dft_matrices(window: int, padded: int, n_bins: int):
    j = np.arange(window)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * j * k / padded
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


def _kaldi_consts(sr: int, window: int, n_mels: int):
    """Kaldi's (padded//2+1, n_mels) banks and symmetric Hamming window."""
    padded = ref.next_pow2(window)
    banks = ref.kaldi_mel_banks(n_mels, padded, sr).T.astype(np.float32)
    n = np.arange(window)
    ham = (0.54 - 0.46 * np.cos(2 * np.pi * n / (window - 1))).astype(
        np.float32)
    return banks, ham


def _sb_consts(sr: int, n_fft: int, n_mels: int):
    """SpeechBrain's (n_fft//2+1, n_mels) banks and periodic Hamming."""
    banks = ref.sb_mel_banks(n_mels, n_fft, sr).T.astype(np.float32)
    n = np.arange(n_fft)
    ham = (0.54 - 0.46 * np.cos(2 * np.pi * n / n_fft)).astype(np.float32)
    return banks, ham


@functools.lru_cache(maxsize=None)
def _frame_consts(mode: str, sr: int, n: int, window: int,
                  n_mels: int) -> Dict[str, np.ndarray]:
    """What K6 and its plain version take for frames of ``n`` columns: the
    window zero-extended to ``n``, the (n, n//2+1) DFT matrices and the
    (n//2+1, n_mels) banks (the plain version), the n-entry twiddle tables
    (the DFT build), the banks packed to each filter's nonzero bins (both
    builds) and, where the FFT build takes n, its ``fft_tables``."""
    if mode == KALDI:
        if n != ref.next_pow2(window):
            raise ValueError(f"Kaldi frames are {ref.next_pow2(window)} "
                             f"wide for a {window}-sample window, not {n}")
        banks, ham = _kaldi_consts(sr, window, n_mels)
    elif mode == SB:
        if n != window:
            raise ValueError(f"SpeechBrain frames are n_fft = {window} "
                             f"wide, not {n}")
        banks, ham = _sb_consts(sr, n, n_mels)
    else:
        raise ValueError(f"unknown fbank mode {mode!r}")
    win = np.zeros((n,), np.float32)
    win[:window] = ham
    cos_m, sin_m = _dft_matrices(n, n, n // 2 + 1)
    ang = 2.0 * np.pi * np.arange(n) / n
    nonzero = [np.nonzero(banks[:, m])[0] for m in range(n_mels)]
    lo = np.array([nz[0] if len(nz) else 0 for nz in nonzero], np.int32)
    span = np.array([nz[-1] - nz[0] + 1 if len(nz) else 0
                     for nz in nonzero], np.int32)
    width = max(int(span.max()), 1)
    packed = np.zeros((n_mels, width), np.float32)
    for m in range(n_mels):
        packed[m, :span[m]] = banks[lo[m]:lo[m] + span[m], m]
    consts = {"win": win, "cos_m": cos_m, "sin_m": sin_m, "banks": banks,
              "twiddle_cos": np.cos(ang).astype(np.float32),
              "twiddle_sin": (-np.sin(ang)).astype(np.float32),
              "mel_w": packed, "mel_lo": lo, "mel_len": span}
    if n <= MAX_N and fbank_plan(n) == "fft":
        consts.update(fft_tables(n))
    return consts


_DEVICE_CONSTS: Dict[Tuple, Dict[str, torch.Tensor]] = {}


def _consts_on(device: torch.device, mode: str, sr: int, n: int, window: int,
               n_mels: int) -> Dict[str, torch.Tensor]:
    key = (str(device), mode, sr, n, window, n_mels)
    if key not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[key] = {
            k: torch.from_numpy(v).to(device)
            for k, v in _frame_consts(mode, sr, n, window, n_mels).items()}
    return _DEVICE_CONSTS[key]


# ---------------------------------------------------------------------------
# K6: frames (rows, N) -> log-mels (rows, n_mels)
# ---------------------------------------------------------------------------

def _dft_power(f: torch.Tensor, c: Dict[str, torch.Tensor]) -> torch.Tensor:
    re = f @ c["cos_m"].to(f.dtype)
    im = f @ c["sin_m"].to(f.dtype)
    return re * re + im * im


def fbank_frames_ref(frames: torch.Tensor, mode: str, sr: int = 16000,
                     window: int = 400, n_mels: int = 40, *,
                     _power=_dft_power) -> torch.Tensor:
    """Plain version of K6, in the TPU kernel's association order, in the
    frames' dtype. ``_power(windowed frames, consts)`` gives the power
    spectrum; another transform may stand in for the DFT products to time
    a yardstick or to mirror the FFT build."""
    n = frames.shape[1]
    c = _consts_on(frames.device, mode, sr, n, window, n_mels)
    f = frames
    if mode == KALDI:
        valid = (torch.arange(n, device=f.device) < window).to(f.dtype)
        mean = f.sum(dim=1, keepdim=True) * (1.0 / float(window))
        f = f - mean * valid
        shifted = torch.cat([f[:, :1], f[:, :-1]], dim=1)
        f = f - PREEMPH * shifted
    mel = _power(f * c["win"].to(f.dtype), c) @ c["banks"].to(f.dtype)
    if mode == KALDI:
        return torch.log(torch.clamp(mel, min=ref.EPS_F32))
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def fbank_frames_cuda(frames: torch.Tensor, mode: str, sr: int = 16000,
                      window: int = 400, n_mels: int = 40) -> torch.Tensor:
    """K6 on the card, by the build ``fbank_plan`` picks for the frames'
    width; the contract of ``fbank_frames_ref``. Raises on frames wider
    than 512."""
    return _launch(fbank_plan(frames.shape[-1]), frames, mode, sr, window,
                   n_mels)


def _launch(build: str, frames: torch.Tensor, mode: str, sr: int = 16000,
            window: int = 400, n_mels: int = 40) -> torch.Tensor:
    """K6's ``build`` ("fft" or "dft") on the card. ``fbank_frames_cuda``
    launches the build its plan picks; ``chip_smoke.py`` and
    ``chip_ab.py`` also launch the DFT build at the FFT build's widths,
    to hold the two against each other."""
    n = frames.shape[-1]
    if build not in BUILDS or (build == "fft" and fbank_plan(n) != "fft"):
        raise ValueError(f"fbank_frames_cuda: no {build!r} build of K6 for "
                         f"frames of {n} columns")
    dev = frames.device
    if dev.type != "cuda" or frames.dtype != torch.float32 \
            or frames.dim() != 2 or not frames.is_contiguous():
        raise ValueError(f"fbank_frames_cuda: frames {tuple(frames.shape)} "
                         f"{frames.dtype} on {dev}; needs a contiguous f32 "
                         "(rows, N) tensor on a CUDA device")
    rows = frames.shape[0]
    c = _consts_on(dev, mode, sr, n, window, n_mels)
    out = torch.empty((rows, n_mels), dtype=torch.float32, device=dev)
    if not rows:
        return out
    args = (c["mel_w"].data_ptr(), c["mel_lo"].data_ptr(),
            c["mel_len"].data_ptr(), out.data_ptr(), rows, n, window,
            n_mels, c["mel_w"].shape[1])
    if build == "fft":
        FBANK_FFT(frames.data_ptr(), c["win"].data_ptr(),
                  c["fft_tw"].data_ptr(), c["fft_split"].data_ptr(), *args,
                  _packed_radices(n // 2), len(fft_radices(n // 2)),
                  int(mode == KALDI), _build.stream_handle(dev))
    else:
        FBANK(frames.data_ptr(), c["win"].data_ptr(),
              c["twiddle_cos"].data_ptr(), c["twiddle_sin"].data_ptr(),
              *args, int(mode == KALDI), _build.stream_handle(dev))
    return out


def fbank_fft_launch_plan(rows: int, n: int, mode: str, sr: int = 16000,
                          window: int = 400, n_mels: int = 40) -> dict:
    """What the FFT build computes for its launch on ``rows`` frames of
    ``n`` columns in ``mode`` (its ``mlvae_fbank_fft_plan`` entry point):
    blocks, warps a block, shared memory bytes, resident blocks an SM,
    registers and local memory bytes a thread, and whether the build it
    launches has its passes fixed when compiled (N = 512 and 400). Builds
    the library; needs the card. Not a launch: it counts nowhere."""
    width = _frame_consts(mode, sr, n, window, n_mels)["mel_w"].shape[1]
    fn = getattr(_build.library(FBANK_FFT.source), "mlvae_fbank_fft_plan")
    fn.argtypes = [_I] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    code = fn(rows, n, n_mels, width, _packed_radices(n // 2),
              len(fft_radices(n // 2)), int(mode == KALDI), out)
    if code:
        raise RuntimeError(f"fbank_fft plan: CUDA error {code}")
    keys = ("blocks", "warps", "smem_bytes", "blocks_per_sm", "registers",
            "local_bytes", "fixed_passes")
    return dict(zip(keys, list(out)))


def fbank_frames(frames: torch.Tensor, mode: str, sr: int = 16000,
                 window: int = 400, n_mels: int = 40) -> torch.Tensor:
    """K6 for CUDA tensors, the plain version for CPU tensors."""
    if frames.device.type == "cpu":
        return fbank_frames_ref(frames, mode, sr, window, n_mels)
    return fbank_frames_cuda(frames, mode, sr, window, n_mels)


# ---------------------------------------------------------------------------
# Kaldi-compatible path
# ---------------------------------------------------------------------------

def kaldi_frame_counts(lengths, shift: int):
    return (lengths + shift // 2) // shift


def kaldi_frame_gather(waves: torch.Tensor, lengths: torch.Tensor,
                       max_frames: int, shift: int,
                       window: int) -> torch.Tensor:
    """Snip-edges=false framing: centered frames with edge reflection.
    waves (B, Lmax), lengths (B,) -> frames (B, max_frames, window)."""
    B, Lmax = waves.shape
    dev = waves.device
    t = torch.arange(max_frames, device=dev)[:, None]
    j = t * shift + shift // 2 - window // 2 \
        + torch.arange(window, device=dev)[None, :]
    L = lengths.to(dev, torch.int64)[:, None, None]
    # Kaldi reflects iteratively (while s<0 or s>=L: s = s<0 ? -s-1 :
    # 2L-1-s), which is periodic with period 2L; this closed form matches it
    # for every index, including utterances shorter than half a window
    m = torch.remainder(j[None], torch.clamp(2 * L, min=1))
    j = torch.where(m >= L, 2 * L - 1 - m, m).clamp(0, Lmax - 1)
    return torch.gather(waves, 1, j.reshape(B, -1)).reshape(
        B, max_frames, window)


def kaldi_frames(waves: torch.Tensor, lengths: torch.Tensor, max_frames: int,
                 shift: int, window: int) -> torch.Tensor:
    """The frames K6 takes in its Kaldi mode: (B * max_frames, N), each
    frame's ``window`` samples zero-padded to N = next_pow2(window)."""
    frames = kaldi_frame_gather(waves, lengths, max_frames, shift, window)
    n = ref.next_pow2(window)
    return F.pad(frames, (0, n - window)).reshape(-1, n)


def kaldi_fbank_batch(waves: torch.Tensor, lengths, *, sr: int = 16000,
                      shift: int = 320, window: int = 400, n_mels: int = 40,
                      max_frames: int):
    """Batched Kaldi-semantics log-mel: ((B, max_frames, n_mels), (B,)
    frame counts); frames beyond a sample's count are zero."""
    B = waves.shape[0]
    dev = waves.device
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    n_frames = kaldi_frame_counts(lengths, shift)
    frames = kaldi_frames(waves, lengths, max_frames, shift, window)
    logmel = fbank_frames(frames, KALDI, sr, window, n_mels).reshape(
        B, max_frames, n_mels)
    valid = torch.arange(max_frames, device=dev)[None, :] < n_frames[:, None]
    return logmel * valid[..., None], n_frames


def deltas_batch(feats: torch.Tensor, n_frames, order: int = 2,
                 window: int = 2) -> torch.Tensor:
    """Kaldi ``add-deltas``: composite delta filters over the original
    features, indices clamped at each utterance's true frame count, padding
    frames zeroed. (B, T, C) -> (B, T, C*(order+1))."""
    B, T, C = feats.shape
    dev = feats.device
    n_frames = torch.as_tensor(n_frames, device=dev).to(torch.int64)
    idx = torch.arange(T, device=dev)[None, :]
    last = (n_frames - 1)[:, None]
    outs = []
    for sc in ref.kaldi_delta_scales(order, window):
        off = (len(sc) - 1) // 2
        acc = torch.zeros_like(feats)
        for j in range(-off, off + 1):
            if sc[j + off] == 0.0:
                continue
            tj = torch.clamp(torch.minimum(idx + j, last), min=0)
            acc = acc + float(sc[j + off]) * torch.gather(
                feats, 1, tj[..., None].expand(B, T, C))
        outs.append(acc)
    # re-mask: padding frames would otherwise carry clamped real-frame reads
    valid = (idx < n_frames[:, None])[..., None]
    return torch.cat(outs, dim=-1) * valid


def cmvn_apply(feats, mean, std):
    return (feats - mean) / std


# ---------------------------------------------------------------------------
# SpeechBrain-compatible path
# ---------------------------------------------------------------------------

def sb_frame_gather(waves: torch.Tensor, lengths: torch.Tensor,
                    max_frames: int, hop: int, n_fft: int) -> torch.Tensor:
    """torch.stft's center=True framing with constant padding: frames
    (B, max_frames, n_fft), zero outside each wave's length."""
    Lmax = waves.shape[1]
    dev = waves.device
    t = torch.arange(max_frames, device=dev)[:, None]
    j = t * hop - n_fft // 2 + torch.arange(n_fft, device=dev)[None, :]
    inside = (j[None] >= 0) & (j[None] < lengths.to(dev)[:, None, None])
    frames = waves[:, j.clamp(0, Lmax - 1)]
    return torch.where(inside, frames, torch.zeros((), device=dev))


def sb_fbank_batch(waves: torch.Tensor, lengths, *, sr: int = 16000,
                   hop: int = 320, n_fft: int = 400, n_mels: int = 40,
                   max_frames: int, deltas: bool = False):
    """Batched SpeechBrain-semantics dB log-mel (+ optional deltas):
    ((B, max_frames, n_mels * (3 if deltas else 1)), (B,) frame counts)."""
    B = waves.shape[0]
    dev = waves.device
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    n_frames = lengths // hop + 1
    frames = sb_frame_gather(waves, lengths, max_frames, hop, n_fft)
    db = fbank_frames(frames.reshape(B * max_frames, n_fft), SB, sr, n_fft,
                      n_mels).reshape(B, max_frames, n_mels)

    valid = torch.arange(max_frames, device=dev)[None, :] < n_frames[:, None]
    # top_db clamp relative to each utterance's max over its valid frames
    masked = torch.where(valid[..., None], db,
                         torch.full((), -torch.inf, device=dev))
    db = torch.maximum(db, masked.amax(dim=(1, 2), keepdim=True) - 80.0)
    if deltas:
        d1 = deltas_batch(db, n_frames, order=1)[..., n_mels:]
        d2 = deltas_batch(d1, n_frames, order=1)[..., n_mels:]
        db = torch.cat([db, d1, d2], dim=-1)
    return db * valid[..., None], n_frames


# ---------------------------------------------------------------------------
# the extractors a recipe names
# ---------------------------------------------------------------------------

def _waves_and_lengths(waves, lengths, device):
    """(B, L) f32 waves on the extractor's device (``device``, else the
    input tensor's, else CUDA), their lengths there, and the longest
    length. Lengths given on the host (a list, an array, a CPU tensor) go
    to the card without a wait; lengths on the card cost a device fetch,
    which stops the host from running ahead of the card."""
    if isinstance(waves, torch.Tensor):
        dev = resolve_device(device if device is not None else waves.device)
        waves = waves.to(dev, torch.float32)
    else:
        dev = resolve_device(device)
        waves = torch.as_tensor(np.asarray(waves, np.float32), device=dev)
    waves = torch.atleast_2d(waves)
    B, L = waves.shape
    if lengths is None:
        return waves, torch.full((B,), L, dtype=torch.int64, device=dev), L
    lengths = torch.as_tensor(lengths).to(torch.int64)
    longest = int(lengths.max())
    if lengths.device.type == "cpu" and dev.type == "cuda":
        lengths = lengths.pin_memory().to(dev, non_blocking=True)
    return waves, lengths.to(dev), longest


class Fbank:
    """The recipe's ``speechbrain.lobes.features.Fbank`` (counterpart of the
    JAX package's ``Fbank``): waves (B, L) in [-1, 1] -> dB log-mels (B, T,
    n_mels, or 3 n_mels with ``deltas``), T the frames of the longest
    length. Each wave is framed at its own length; rows past a shorter
    wave's frames are zero. No bucket padding: PyTorch keeps no compile
    cache to serve, and the features are the same without it."""

    def __init__(self, deltas: bool = False, sample_rate: int = 16000,
                 hop_length: float = 20.0, n_fft: int = 400, n_mels: int = 40,
                 device=None):
        self.deltas = bool(deltas)
        self.sample_rate = int(sample_rate)
        self.hop = int(sample_rate * hop_length / 1000)
        self.n_fft = int(n_fft)
        self.n_mels = int(n_mels)
        self.device = device

    def __call__(self, waves, lengths=None) -> torch.Tensor:
        waves, lengths, longest = _waves_and_lengths(waves, lengths,
                                                     self.device)
        feats, _ = sb_fbank_batch(
            waves, lengths, sr=self.sample_rate, hop=self.hop,
            n_fft=self.n_fft, n_mels=self.n_mels,
            max_frames=waves.shape[1] // self.hop + 1, deltas=self.deltas)
        return feats[:, :longest // self.hop + 1]


class KaldiFbank:
    """The Kaldi pipeline's ``compute-fbank-feats`` + ``add-deltas``
    (counterpart of the JAX package's ``KaldiFbank``): int16-scale waves
    (B, L) -> log-mels (B, T, n_mels, or 3 n_mels with ``deltas``).
    Speaker CMVN is the caller's (``data/data_io.compute_kaldi_features``)."""

    def __init__(self, sample_rate: int = 16000, hop_length: float = 20.0,
                 n_fft: int = 400, n_mels: int = 40, deltas: bool = True,
                 device=None):
        self.sample_rate = int(sample_rate)
        self.shift = int(sample_rate * hop_length / 1000)
        self.window = int(n_fft)  # the reference passes n_fft as the window
        self.n_mels = int(n_mels)
        self.deltas = bool(deltas)
        self.device = device

    def __call__(self, waves, lengths=None) -> torch.Tensor:
        waves, lengths, longest = _waves_and_lengths(waves, lengths,
                                                     self.device)
        feats, n_frames = kaldi_fbank_batch(
            waves, lengths, sr=self.sample_rate, shift=self.shift,
            window=self.window, n_mels=self.n_mels,
            max_frames=int(kaldi_frame_counts(waves.shape[1], self.shift)))
        if self.deltas:
            feats = deltas_batch(feats, n_frames)
        return feats[:, :int(kaldi_frame_counts(longest, self.shift))]
