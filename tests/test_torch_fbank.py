"""The port's wav front end (``mlvae_tpu_torch/ops/fbank.py``, the plain
versions of K6's two modes, and ``ops/frontend_ref.py``) against the JAX
package: its XLA extractors, its Pallas kernel K6 in interpret mode and
its float64 golden. Inputs come from numpy seeds.

Tolerances: log-mels within 1e-4 relative error of the golden, the
denominator floored at 1e-3 (the JAX front end's gate,
``tests/test_frontend.py``); the port against the JAX f32 paths at the
same measure; whole feature vectors with their deltas (sums of up to
nine taps of log-mels, f32 in another order) within 2e-3 absolute, in dB
or natural-log units.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlvae_tpu.ops import fbank as jfb
from mlvae_tpu.ops import frontend_ref as jref
from mlvae_tpu.ops.fbank_pallas import kaldi_fbank_pallas

from mlvae_tpu_torch.bench_utils import synth_wave
from mlvae_tpu_torch.ops import fbank as pfb
from mlvae_tpu_torch.ops import frontend_ref as pref

torch.set_num_threads(2)

GATE = 1e-4      # the golden gate, relative, denominator floored at 1e-3
DELTA_ATOL = 2e-3  # dB (SpeechBrain) or natural-log (Kaldi) units


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-3))) \
        if b.size else 0.0


def _abs_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _batch(lengths, Lpad, scale=8000.0):
    waves = np.zeros((len(lengths), Lpad), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = synth_wave(n, i, scale)
    return waves


# ---------------------------------------------------------------------------
# the port's golden is the JAX package's
# ---------------------------------------------------------------------------

GOLDEN_CASES = {
    "kaldi_fbank": lambda m, w: m.kaldi_fbank(w),
    "kaldi_deltas": lambda m, w: m.kaldi_deltas(m.kaldi_fbank(w)),
    "sb_fbank": lambda m, w: m.sb_fbank(w),
    "sb_fbank_with_deltas": lambda m, w: m.sb_fbank_with_deltas(w),
    "kaldi_mel_banks": lambda m, w: m.kaldi_mel_banks(40, 512, 16000),
    "sb_mel_banks": lambda m, w: m.sb_mel_banks(40, 400, 16000),
    "kaldi_delta_scales": lambda m, w: np.concatenate(
        m.kaldi_delta_scales(2, 2)),
    "cmvn": lambda m, w: m.apply_cmvn(m.kaldi_fbank(w), *m.cmvn_stats(
        [m.kaldi_fbank(w), m.kaldi_fbank(w[::-1].copy())])),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_is_the_jax_packages(name):
    w = synth_wave(5000, 3)
    np.testing.assert_array_equal(GOLDEN_CASES[name](pref, w),
                                  GOLDEN_CASES[name](jref, w))


# ---------------------------------------------------------------------------
# what K6 takes: the twiddle table and the packed banks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,n,window", [(pfb.KALDI, 512, 400),
                                           (pfb.SB, 400, 400)])
def test_twiddles_and_packed_banks_are_the_plain_versions(mode, n, window):
    """K6 reads the DFT matrices as cos/sin((j k mod N) 2 pi / N) from an
    N-entry table and each filter's nonzero bins: both must give the
    plain version's f32 matrices, entry for entry, except at the zeros of
    cos and sin, where the float64 angle 2 pi j k / N rounds at large j k
    and both sides stay under 1e-12."""
    c = pfb._frame_consts(mode, 16000, n, window, 40)
    jk = np.arange(n)[:, None] * np.arange(n // 2 + 1)[None, :] % n
    for table, dense in ((c["twiddle_cos"][jk], c["cos_m"]),
                         (c["twiddle_sin"][jk], c["sin_m"])):
        zero = np.abs(dense) < 1e-12
        np.testing.assert_array_equal(table[~zero], dense[~zero])
        assert np.abs(table[zero]).max() < 1e-12
    dense = np.zeros_like(c["banks"])
    for m in range(40):
        lo, span = c["mel_lo"][m], c["mel_len"][m]
        dense[lo:lo + span, m] = c["mel_w"][m, :span]
    np.testing.assert_array_equal(dense, c["banks"])
    assert np.all(c["win"][window:] == 0.0)


# ---------------------------------------------------------------------------
# the Kaldi path: the plain version of K6's Kaldi mode
# ---------------------------------------------------------------------------

def test_reflection_matches_kaldi_iterated_for_short_utterances():
    """The closed-form 2L-periodic reflection of ``kaldi_frame_gather``
    equals Kaldi's while-loop for every index, sub-window lengths too."""
    def kaldi_loop(s, L):
        while s < 0 or s >= L:
            s = -s - 1 if s < 0 else 2 * L - 1 - s
        return s

    for L in [1, 3, 150, 170, 400]:
        j = np.arange(-3 * L - 2, 4 * L + 2)
        want = np.array([kaldi_loop(int(s), L) for s in j])
        np.testing.assert_array_equal(pref._reflect_index(j, L), want)
        Lpad = L + 7
        waves = torch.arange(Lpad, dtype=torch.float32)[None]
        T = max(int(pfb.kaldi_frame_counts(L, 320)), 1)
        got = pfb.kaldi_frame_gather(waves, torch.tensor([L]), T, 320, 400)
        t = np.arange(T)[:, None]
        idx = t * 320 + 160 - 200 + np.arange(400)[None, :]
        want = np.array([[kaldi_loop(int(s), L) for s in row] for row in idx])
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_kaldi_fbank_matches_jax_pallas_and_golden():
    """Mixed lengths in one batch, one of them shorter than half a window:
    the port's plain path within the gate of the golden, of JAX's XLA
    ``kaldi_fbank_batch`` and of its Pallas kernel in interpret mode; the
    same frame counts; frames past a count exactly zero."""
    lengths = [16000, 9000, 170, 7003]
    waves = _batch(lengths, 16000)
    mf = int(jfb.kaldi_frame_counts(16000, 320))
    got, n = pfb.kaldi_fbank_batch(torch.from_numpy(waves),
                                   torch.tensor(lengths), max_frames=mf)
    got, n = got.numpy(), n.numpy()
    j_xla, j_n = jfb.kaldi_fbank_batch(jnp.asarray(waves),
                                       jnp.asarray(lengths), max_frames=mf)
    j_pal, _ = kaldi_fbank_pallas(jnp.asarray(waves), jnp.asarray(lengths),
                                  max_frames=mf, interpret=True)
    np.testing.assert_array_equal(n, np.asarray(j_n))
    for i, L in enumerate(lengths):
        golden = pref.kaldi_fbank(waves[i, :L])
        T = golden.shape[0]
        assert n[i] == T
        assert _relerr(got[i, :T], golden) < GATE
        assert _relerr(got[i, :T], np.asarray(j_xla)[i, :T]) < GATE
        assert _relerr(got[i, :T], np.asarray(j_pal)[i, :T]) < GATE
        assert np.abs(got[i, T:]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("L", [150, 170, 199])
def test_kaldi_fbank_sub_window_utterance(L):
    """An utterance shorter than half the 400-sample window exercises the
    multi-reflection framing end to end (150 samples make no frame at a
    320-sample shift, as in Kaldi; 170 and 199 make one)."""
    wave = (np.random.RandomState(11).randn(L) * 1000).astype(np.float32)
    golden = pref.kaldi_fbank(wave)
    mf = int(pfb.kaldi_frame_counts(L, 320))
    got, n = pfb.kaldi_fbank_batch(torch.from_numpy(wave)[None],
                                   torch.tensor([L]), max_frames=mf)
    j_got, j_n = jfb.kaldi_fbank_batch(jnp.asarray(wave)[None],
                                       jnp.asarray([L], jnp.int32),
                                       max_frames=mf)
    T = golden.shape[0]
    assert int(n[0]) == int(j_n[0]) == T == mf
    assert _relerr(got[0, :T].numpy(), golden) < GATE
    assert _relerr(got[0, :T].numpy(), np.asarray(j_got)[0, :T]) < GATE


@pytest.mark.parametrize("order", [1, 2])
def test_deltas_batch_matches_jax(order):
    rs = np.random.RandomState(4 + order)
    n_frames = np.array([20, 13, 1, 7])
    feats = (rs.randn(4, 20, 6) * 10).astype(np.float32)
    feats *= (np.arange(20)[None, :, None] < n_frames[:, None, None])
    got = pfb.deltas_batch(torch.from_numpy(feats),
                           torch.from_numpy(n_frames), order=order)
    want = jfb.deltas_batch(jnp.asarray(feats), jnp.asarray(n_frames),
                            order=order)
    assert got.shape == (4, 20, 6 * (order + 1))
    assert _abs_err(got.numpy(), np.asarray(want)) < DELTA_ATOL


def test_deltas_batch_masks_padding():
    rs = np.random.RandomState(3)
    feats = torch.from_numpy(rs.randn(2, 10, 4).astype(np.float32))
    feats = feats * (torch.arange(10)[None, :, None]
                     < torch.tensor([6, 10])[:, None, None])
    out = pfb.deltas_batch(feats, torch.tensor([6, 10]))
    assert out[0, 6:].abs().max() == 0.0
    assert out[1].abs().max() > 0.0


def test_kaldi_deltas_match_golden():
    f = pref.kaldi_fbank(synth_wave(8000, 5))
    got = pfb.deltas_batch(torch.from_numpy(f)[None],
                           torch.tensor([f.shape[0]]))[0]
    np.testing.assert_allclose(got.numpy(), pref.kaldi_deltas(f),
                               rtol=1e-4, atol=1e-4)


def test_cmvn_apply():
    rs = np.random.RandomState(8)
    x, mean, std = rs.randn(5, 3), rs.randn(3), rs.rand(3) + 0.5
    got = pfb.cmvn_apply(torch.from_numpy(x), torch.from_numpy(mean),
                         torch.from_numpy(std))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jfb.cmvn_apply(x, mean, std)),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# the SpeechBrain path: the plain version of K6's SpeechBrain mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deltas", [False, True])
def test_sb_fbank_matches_jax_and_golden(deltas):
    lengths = [9600, 16000, 170, 5000]
    waves = _batch(lengths, 16000)
    mf = 16000 // 320 + 1
    got, n = pfb.sb_fbank_batch(torch.from_numpy(waves),
                                torch.tensor(lengths), max_frames=mf,
                                deltas=deltas)
    want, j_n = jfb.sb_fbank_batch(jnp.asarray(waves), jnp.asarray(lengths),
                                   max_frames=mf, deltas=deltas)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))
    assert got.shape == (4, mf, 120 if deltas else 40)
    for i, L in enumerate(lengths):
        golden = (pref.sb_fbank_with_deltas if deltas
                  else pref.sb_fbank)(waves[i, :L])
        T = golden.shape[0]
        assert int(n[i]) == T
        assert _relerr(got[i, :T, :40], golden[:, :40]) < GATE
        assert _relerr(got[i, :T, :40], want[i, :T, :40]) < GATE
        assert _abs_err(got[i, :T], golden) < DELTA_ATOL
        assert np.abs(got[i, T:]).max(initial=0.0) == 0.0
    assert _abs_err(got, want) < DELTA_ATOL


@pytest.mark.parametrize("ragged", [False, True])
def test_fbank_class_matches_jax(ragged):
    """``Fbank(deltas=True)``, the recipe's extractor, against the JAX
    class: the same (B, true_frames, 120) shape, though the port frames no
    0.5 s bucket padding, and the same values."""
    lengths = [12345, 8000] if ragged else [12345, 12345]
    waves = _batch(lengths, 12345, scale=8000.0 / 32768.0)
    lens = lengths if ragged else None
    got = pfb.Fbank(deltas=True, device="cpu")(waves, lens).numpy()
    want = np.asarray(jfb.Fbank(deltas=True)(waves, lens))
    assert got.shape == want.shape == (2, 12345 // 320 + 1, 120)
    assert _relerr(got[..., :40], want[..., :40]) < GATE
    assert _abs_err(got, want) < DELTA_ATOL


@pytest.mark.parametrize("ragged", [False, True])
def test_kaldi_fbank_class_matches_jax(ragged):
    lengths = [10000, 6001] if ragged else [10000, 10000]
    waves = _batch(lengths, 10000)
    lens = lengths if ragged else None
    got = pfb.KaldiFbank(device="cpu")(waves, lens).numpy()
    want = np.asarray(jfb.KaldiFbank()(waves, lens))
    assert got.shape == want.shape == (2, (10000 + 160) // 320, 120)
    assert _relerr(got[..., :40], want[..., :40]) < GATE
    assert _abs_err(got, want) < DELTA_ATOL
    golden = pref.kaldi_deltas(pref.kaldi_fbank(waves[1, :lengths[1]]))
    np.testing.assert_allclose(got[1, :golden.shape[0]], golden, rtol=1e-3,
                               atol=1e-3)


def test_extractors_follow_the_input_tensor():
    """No device given: a CPU tensor stays on the CPU, as the result."""
    waves = torch.from_numpy(_batch([4000], 4000, scale=0.2))
    assert pfb.Fbank(deltas=True)(waves).device.type == "cpu"
    assert pfb.KaldiFbank()(waves * 32768.0).device.type == "cpu"
