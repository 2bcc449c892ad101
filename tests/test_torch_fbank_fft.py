"""K6's FFT build (``csrc/fbank_fft.cu``) on the CPU: the plan that picks
a build by frame width, the tables the wrapper hands the kernel, and a
torch mirror of the kernel's passes (Stockham, radices 2, 3, 4, 5 and 8,
the butterflies as the kernel writes them, then the split of the packed
real frame) fed those tables. The mirror is held in float64 against
numpy's rfft, and in f32 and float64 against the DFT plain version
``fbank_frames_ref`` (1e-3 absolute in natural-log mels, 5e-3 dB, as on
the card) and against the float64 golden ``ops/frontend_ref.py`` (1e-4
relative, the denominator floored at 1e-3). The kernel itself runs on the
card (``chip_smoke.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.bench_utils import synth_wave
from mlvae_tpu_torch.ops import fbank as pfb
from mlvae_tpu_torch.ops import frontend_ref as pref

torch.set_num_threads(2)

SRC = Path(_build.CSRC) / "fbank_fft.cu"
GATE = 1e-4             # the golden gate
FBANK_KALDI_ATOL = 1e-3  # against the DFT plain version, natural-log mels
FBANK_SB_ATOL = 5e-3     # the same in dB


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-3)))


# ---------------------------------------------------------------------------
# the torch mirror of the kernel's passes
# ---------------------------------------------------------------------------

def _f32(x):
    return float(np.float32(x))


HALF_SQRT2 = _f32(np.sqrt(0.5))
SIN_2PI_3 = _f32(np.sin(2 * np.pi / 3))
COS_2PI_5, COS_4PI_5 = _f32(np.cos(2 * np.pi / 5)), _f32(np.cos(4 * np.pi / 5))
SIN_2PI_5, SIN_4PI_5 = _f32(np.sin(2 * np.pi / 5)), _f32(np.sin(4 * np.pi / 5))


def _mi(z):
    """-i z"""
    return torch.complex(z.imag, -z.real)


def _butterfly(R, x):
    """The kernel's R-point DFTs (``butterfly<R>``), term for term."""
    if R == 2:
        return [x[0] + x[1], x[0] - x[1]]
    if R == 4:
        a, b = x[0] + x[2], x[0] - x[2]
        c, d = x[1] + x[3], _mi(x[1] - x[3])
        return [a + c, b + d, a - c, b - d]
    if R == 8:
        e, o = _butterfly(4, x[0::2]), _butterfly(4, x[1::2])
        o[1] = torch.complex(HALF_SQRT2 * (o[1].real + o[1].imag),
                             HALF_SQRT2 * (o[1].imag - o[1].real))
        o[2] = _mi(o[2])
        o[3] = torch.complex(HALF_SQRT2 * (o[3].imag - o[3].real),
                             -HALF_SQRT2 * (o[3].real + o[3].imag))
        return [e[s] + o[s] for s in range(4)] + [e[s] - o[s]
                                                  for s in range(4)]
    if R == 3:
        t, u = x[1] + x[2], x[1] - x[2]
        m = x[0] - 0.5 * t
        v = _mi(SIN_2PI_3 * u)
        return [x[0] + t, m + v, m - v]
    assert R == 5
    a1, b1 = x[1] + x[4], x[1] - x[4]
    a2, b2 = x[2] + x[3], x[2] - x[3]
    m1 = x[0] + (COS_2PI_5 * a1 + COS_4PI_5 * a2)
    m2 = x[0] + (COS_4PI_5 * a1 + COS_2PI_5 * a2)
    v1 = _mi(SIN_2PI_5 * b1 + SIN_4PI_5 * b2)
    v2 = _mi(SIN_4PI_5 * b1 - SIN_2PI_5 * b2)
    return [x[0] + (a1 + a2), m1 + v1, m2 + v2, m2 - v2, m1 - v1]


def _pairs(t, ctype):
    return torch.complex(t[:, 0], t[:, 1]).to(ctype)


def fft_power(f, c):
    """The FFT build's power spectrum of windowed frames ``f`` (rows, N),
    pass for pass as the kernel runs them, from the tables in ``c``; in
    f's dtype (complex64 for f32, complex128 for float64)."""
    n = f.shape[1]
    m = n // 2
    ctype = torch.complex128 if f.dtype == torch.float64 else torch.complex64
    tw, split = _pairs(c["fft_tw"], ctype), _pairs(c["fft_split"], ctype)
    z = torch.complex(f[:, 0::2], f[:, 1::2])
    p, off = 1, 0
    for R in pfb.fft_radices(m):
        S = m // R
        i = torch.arange(S)
        k = i % p
        x = [z[:, i + r * S] for r in range(R)]
        x = [x[0]] + [x[r] * tw[off + (r - 1) * p + k] for r in range(1, R)]
        y = _butterfly(R, x)
        out = torch.empty_like(z)
        j = (i - k) * R + k
        for r in range(R):
            out[:, j + r * p] = y[r]
        z, off, p = out, off + (R - 1) * p, p * R
    k = torch.arange(m + 1)
    a, b = z[:, k % m], torch.conj(z[:, (m - k) % m])
    x = 0.5 * ((a + b) + split[k] * _mi(a - b))
    return x.real * x.real + x.imag * x.imag


def _mirror(frames, mode, *args):
    return pfb.fbank_frames_ref(frames, mode, *args, _power=fft_power)


# ---------------------------------------------------------------------------
# the plan and the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,build,radices", [
    (512, "fft", (4, 4, 4, 4)), (400, "fft", (8, 5, 5)),
    (480, "fft", (4, 4, 3, 5)), (250, "fft", (5, 5, 5)), (2, "fft", ()),
    (448, "dft", None), (14, "dft", None), (401, "dft", None),
    (1, "dft", None)])
def test_plan_picks_the_build(n, build, radices):
    """An even N whose N/2 factors into 2, 3, 4 and 5 takes the FFT
    build (480: a radix-3 pass), any other N up to 512 the DFT build
    (448 = 2^6 * 7, 14 = 2 * 7, an odd N)."""
    assert pfb.fbank_plan(n) == build
    assert (pfb.fft_radices(n // 2) if n % 2 == 0 else None) == radices
    if radices:
        assert int(np.prod(radices)) == n // 2
        packed = pfb._packed_radices(n // 2)
        assert [(packed >> 4 * i) & 15 for i in range(len(radices))] \
            == list(radices) and packed >> 4 * len(radices) == 0


@pytest.mark.parametrize("n", [513, 1024, 0, -2])
def test_plan_refuses_frames_outside_the_contract(n):
    with pytest.raises(ValueError, match="frames of 1 to 512"):
        pfb.fbank_plan(n)


@pytest.mark.parametrize("mode,n,window", [(pfb.KALDI, 512, 400),
                                           (pfb.SB, 400, 400),
                                           (pfb.SB, 480, 480)])
def test_tables_are_float64_rounded_to_f32(mode, n, window):
    """The wrapper hands the kernel each pass's twiddles exp(-2 pi i r k /
    (p R)) at (r - 1) p + k, pass after pass (M - 1 in all), and the split
    factors exp(-2 pi i k / N), k = 0 .. M, each computed in float64 and
    rounded to f32; the DFT build's constants stay beside them."""
    c = pfb._frame_consts(mode, 16000, n, window, 40)
    m = n // 2
    want, p = [], 1
    for radix in pfb.fft_radices(m):
        for r in range(1, radix):
            for k in range(p):
                ang = -2 * np.pi * r * k / (p * radix)
                want.append((np.cos(ang), np.sin(ang)))
        p *= radix
    assert c["fft_tw"].dtype == c["fft_split"].dtype == np.float32
    np.testing.assert_array_equal(c["fft_tw"],
                                  np.asarray(want, np.float64).astype(
                                      np.float32))
    ang = -2 * np.pi * np.arange(m + 1) / n
    np.testing.assert_array_equal(
        c["fft_split"], np.stack([np.cos(ang), np.sin(ang)], 1).astype(
            np.float32))
    assert c["fft_tw"].shape == (m - 1, 2)
    assert {"twiddle_cos", "mel_w", "mel_lo", "mel_len"} <= set(c)
    assert "fft_tw" not in pfb._frame_consts(pfb.SB, 16000, 448, 448, 40)


def test_kernel_constants_are_the_mirrors():
    """The kernel's widest frame, its butterflies' constants and its entry
    points as the wrapper binds them."""
    src = SRC.read_text()

    def const(name):
        return float(re.search(rf"constexpr float {name} = ([-0-9.]+)f;",
                               src).group(1))
    assert int(re.search(r"constexpr int MAX_N = (\d+);", src).group(1)) \
        == pfb.MAX_N
    for name, want in (("HALF_SQRT2", HALF_SQRT2), ("SIN_2PI_3", SIN_2PI_3),
                       ("COS_2PI_5", COS_2PI_5), ("COS_4PI_5", COS_4PI_5),
                       ("SIN_2PI_5", SIN_2PI_5), ("SIN_4PI_5", SIN_4PI_5)):
        assert _f32(const(name)) == want, name
    sig = re.search(r"int mlvae_fbank_fft\(([^)]*)\)", src).group(1)
    assert len(sig.split(",")) == len(pfb.FBANK_FFT.argtypes)
    assert pfb.FBANK_FFT in _build.KERNELS and pfb.FBANK in _build.KERNELS
    assert "fbank_fft" in _build.SOURCES and pfb.BUILDS == {
        "fft": pfb.FBANK_FFT, "dft": pfb.FBANK}
    assert "mlvae_fbank_fft_plan(" in src
    assert "__sincosf(" not in src and "use_fast_math" not in " ".join(
        _build._flags("fbank_fft"))


def test_the_wrapper_refuses_cpu_frames():
    with pytest.raises(ValueError, match="CUDA device"):
        pfb.fbank_frames_cuda(torch.zeros((2, 512)), pfb.KALDI)


@pytest.mark.parametrize("n", [512, 400, 448, 480, 250])
def test_the_wrapper_launches_the_build_its_plan_picks(n, monkeypatch):
    seen = []
    monkeypatch.setattr(pfb, "_launch",
                        lambda build, *args: seen.append(build))
    pfb.fbank_frames_cuda(torch.zeros((2, n)), pfb.SB, window=n)
    assert seen == [pfb.fbank_plan(n)]


@pytest.mark.parametrize("build,n", [("fft", 448), ("fft", 254),
                                     ("rfft", 512)])
def test_the_launcher_refuses_a_build_that_does_not_take_the_width(build, n):
    with pytest.raises(ValueError, match="no .* build of K6"):
        pfb._launch(build, torch.zeros((2, n)), pfb.SB, window=n)


# ---------------------------------------------------------------------------
# the mirror against numpy, the plain version and the golden
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [512, 400, 480, 250, 64, 30, 2])
def test_mirror_power_is_the_rfft(n):
    """Every radix and pass order, odd M (250: 5^3) and M = 1 (N = 2):
    the power of bins 0 .. N/2 within 1e-6 of the largest (the f32 tables
    and constants), in f32 and float64."""
    c = {k: torch.from_numpy(v) for k, v in pfb.fft_tables(n).items()}
    f = np.random.RandomState(n).randn(6, n)
    want = np.abs(np.fft.rfft(f, axis=1)) ** 2
    for dtype in (np.float64, np.float32):
        got = fft_power(torch.from_numpy(f.astype(dtype)), c).double()
        assert np.abs(got.numpy() - want).max() / want.max() < 1e-6


def _frames(mode, lengths, T):
    waves = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = synth_wave(n, 20 + i, 8000.0 if mode == pfb.KALDI
                                  else 0.25, am_hz=3.0)
    w, lens = torch.from_numpy(waves), torch.tensor(lengths)
    if mode == pfb.KALDI:
        return pfb.kaldi_frames(w, lens, T, 320, 400)
    return pfb.sb_frame_gather(w, lens, T, 320, 400).reshape(-1, 400)


@pytest.mark.parametrize("mode", [pfb.KALDI, pfb.SB])
def test_mirror_log_mels_match_the_dft_plain_version(mode):
    frames = _frames(mode, [16000, 9000, 170], 50)
    tol = FBANK_KALDI_ATOL if mode == pfb.KALDI else FBANK_SB_ATOL
    want = pfb.fbank_frames_ref(frames, mode)
    for dtype in (torch.float32, torch.float64):
        got = _mirror(frames.to(dtype), mode)
        assert got.dtype == dtype
        assert float((got.double() - want.double()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", [pfb.KALDI, pfb.SB])
def test_mirror_extractors_match_the_golden(mode, dtype, monkeypatch):
    """Both extractors with the mirror in K6's place, against the float64
    golden on ``chip_smoke.py``'s two utterances."""
    monkeypatch.setattr(pfb, "fbank_frames", _mirror)
    lengths = [16000, 9000]
    waves = np.zeros((2, 16000), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = synth_wave(n, i)
    w = torch.from_numpy(waves).to(dtype)
    lens = torch.tensor(lengths)
    if mode == pfb.KALDI:
        got, _ = pfb.kaldi_fbank_batch(w, lens, max_frames=50)
        golden = pref.kaldi_fbank
    else:
        got, _ = pfb.sb_fbank_batch(w, lens, max_frames=51)
        golden = pref.sb_fbank
    assert got.dtype == dtype
    for i, n in enumerate(lengths):
        g = golden(waves[i, :n])
        assert _relerr(got[i, :g.shape[0]].double().numpy(), g) < GATE
