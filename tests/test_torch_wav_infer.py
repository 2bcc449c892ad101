"""The port's wav-in serving path against the JAX package: ``data/wav.py``
(read, write, resample), ``data/encoder.LabelEncoder``,
``data/data_io.compute_kaldi_features`` and ``cli/infer.infer``, at
narrow widths (H=32, 2 layers) with the JAX weights carried across and
the eval step's draws replayed. Inputs come from numpy seeds.

Tolerances: reads bit-equal; resampling within 1e-6 (numpy on both
sides, the same filter); Kaldi features after per-speaker CMVN within
1e-4 of the largest entry (the fbank within the 1e-4 gate, then a
division by each dimension's deviation); verdicts and start times equal.
"""
import wave as stdlib_wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.bench_utils import build_md_vae as jax_build_md_vae
from mlvae_tpu.cli.infer import _uniform_boundary as jax_uniform_boundary
from mlvae_tpu.data import data_io as jdio
from mlvae_tpu.data import wav as jwav
from mlvae_tpu.data.encoder import LabelEncoder as JaxLabelEncoder
from mlvae_tpu.models.MD_VAE.model import Target
from mlvae_tpu.ops import fbank as jfb
from mlvae_tpu.training.brain import Stage

from mlvae_tpu_torch.bench_utils import RECIPE, build_md_vae, synth_wave
from mlvae_tpu_torch.cli.infer import infer
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.data import wav as pwav
from mlvae_tpu_torch.data.data_io import compute_kaldi_features
from mlvae_tpu_torch.data.encoder import LabelEncoder
from mlvae_tpu_torch.ops.fbank import Fbank
from test_torch_md_vae import SMALL, _eval_draws

torch.set_num_threads(2)

PHONES = ["sil", "aa", "b", "d", "eh", "f", "g", "ih", "k", "l", "m", "n",
          "s"]
RESAMPLE_ATOL = 1e-6
CMVN_RTOL = 1e-4  # of the largest entry


# ---------------------------------------------------------------------------
# wav files
# ---------------------------------------------------------------------------

def _riff(path, raw: bytes, width: int, channels: int, sr: int):
    with stdlib_wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


def _sphere(path, fields, payload: bytes):
    head = "".join(f"{k} {v}\n" for k, v in fields.items()) + "end_head\n"
    head = b"NIST_1A\n   1024\n" + head.encode()
    path.write_bytes(head + b" " * (1024 - len(head)) + payload)


def _make_file(kind, path):
    rs = np.random.RandomState(len(kind))
    if kind == "pcm16":
        jwav.write_wav(path, synth_wave(3000, 1, 0.3), 16000)
    elif kind == "pcm8":
        _riff(path, rs.randint(0, 256, 3000).astype(np.uint8).tobytes(), 1,
              1, 8000)
    elif kind == "pcm32":
        _riff(path, rs.randint(-2 ** 31, 2 ** 31, 3000).astype(
            np.int32).tobytes(), 4, 1, 16000)
    elif kind == "stereo16":
        _riff(path, rs.randint(-32768, 32768, 6000).astype(
            np.int16).tobytes(), 2, 2, 22050)
    elif kind in ("sphere_le", "sphere_be", "sphere_stereo"):
        pcm = rs.randint(-32768, 32768, 4000).astype(np.int16)
        if kind == "sphere_be":
            pcm = pcm.astype(">i2")
        _sphere(path, {"sample_coding": "-s3 pcm",
                       "sample_rate": "-i 16000",
                       "channel_count": f"-i {2 if 'stereo' in kind else 1}",
                       "sample_n_bytes": "-i 2",
                       "sample_byte_format":
                       f"-s2 {'10' if kind == 'sphere_be' else '01'}"},
                pcm.tobytes())
    elif kind == "sphere_ulaw":
        _sphere(path, {"sample_coding": "-s4 ulaw", "sample_rate": "-i 8000",
                       "sample_n_bytes": "-i 1"},
                rs.randint(0, 256, 3000).astype(np.uint8).tobytes())


@pytest.mark.parametrize("kind", ["pcm16", "pcm8", "pcm32", "stereo16",
                                  "sphere_le", "sphere_be", "sphere_stereo",
                                  "sphere_ulaw"])
def test_read_wav_matches_jax(kind, tmp_path):
    path = tmp_path / f"{kind}.wav"
    _make_file(kind, path)
    got, sr = pwav.read_wav(path)
    want, want_sr = jwav.read_wav(path)
    assert sr == want_sr and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_shorten_sphere_names_the_roadmap(tmp_path):
    """A shorten-compressed SPHERE is read, not refused: equal to the JAX
    reader's, cut to the header's sample count."""
    from test_shorten import FN_DIFF1, FN_DIFF2, TYPE_S16LH, _Encoder, _wave
    y = _wave(4 * 64, seed=11)
    enc = _Encoder(TYPE_S16LH, nchan=1, blocksize=64)
    for i, fn in enumerate((FN_DIFF2, FN_DIFF1, FN_DIFF2, FN_DIFF1)):
        enc.block(0, fn, y[i * 64:(i + 1) * 64])
    path = tmp_path / "shorten.sph"
    _sphere(path, {"sample_coding": "-s26 pcm,embedded-shorten-v2.00",
                   "sample_rate": "-i 16000", "sample_count": "-i 250"},
            enc.finish())
    got, sr = pwav.read_wav(path)
    want, want_sr = jwav.read_wav(path)
    assert sr == want_sr == 16000 and got.dtype == np.float32
    assert len(got) == 250
    np.testing.assert_array_equal(got, want)


def test_write_wav_bytes_match_jax(tmp_path):
    data = synth_wave(5000, 2, 1.3)  # past full scale: the clip too
    pwav.write_wav(tmp_path / "port" / "a.wav", data, 22050)
    jwav.write_wav(tmp_path / "jax" / "a.wav", data, 22050)
    assert (tmp_path / "port" / "a.wav").read_bytes() == \
        (tmp_path / "jax" / "a.wav").read_bytes()


@pytest.mark.parametrize("sr_in", [8000, 16000, 24000, 48000])
def test_resample_matches_jax(sr_in):
    """Up, none, up and down, down. (22,050 Hz, 441 down, takes a 14,113-tap
    filter whose numpy convolution crawls when test workers share cores.)"""
    data = synth_wave(1000, 3, 0.25)
    got = pwav.resample(data, sr_in, 16000)
    want = jwav.resample(data, sr_in, 16000)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_ATOL)


# ---------------------------------------------------------------------------
# the label encoder
# ---------------------------------------------------------------------------

def _jax_encoder():
    enc = JaxLabelEncoder()
    enc.update_from_iterable(PHONES)
    enc.insert_blank(index=0)
    return enc


def test_label_encoder_loads_a_jax_file(tmp_path):
    jenc = _jax_encoder()
    jenc.save(tmp_path / "jax" / "label_encoder.txt")
    enc = LabelEncoder.load(tmp_path / "jax" / "label_encoder.txt")
    assert enc.lab2ind == jenc.lab2ind and enc.ind2lab == jenc.ind2lab
    assert len(enc) == RECIPE["n_phonemes"] + 2
    seq = ["aa", "b", "sil", "s"]
    np.testing.assert_array_equal(enc.encode_sequence(seq),
                                  jenc.encode_sequence(seq))
    ragged = [np.array([1, 2]), [3, [4, 0]]]
    assert enc.decode_ndim(ragged) == jenc.decode_ndim(ragged)
    enc.save(tmp_path / "port" / "label_encoder.txt")
    assert (tmp_path / "port" / "label_encoder.txt").read_bytes() == \
        (tmp_path / "jax" / "label_encoder.txt").read_bytes()


# ---------------------------------------------------------------------------
# the Kaldi feature pass
# ---------------------------------------------------------------------------

def _kaldi_set(tmp_path, utts):
    """A ``kaldi_data`` train set of ``utts`` (id -> (speaker, samples,
    rate)) of amplitude-modulated audio, and the hparams that name it."""
    kaldi = tmp_path / "corpus" / "kaldi_data"
    kaldi.mkdir(parents=True)
    scp, u2s = [], []
    for i, (utt, (spk, n, sr)) in enumerate(utts.items()):
        path = tmp_path / "wav" / f"{utt}.wav"
        jwav.write_wav(path, synth_wave(n, 30 + i, 0.25, am_hz=3.0), sr)
        scp.append(f"{utt} {path}\n")
        u2s.append(f"{utt} {spk}\n")
    (kaldi / "train.wav.scp").write_text("".join(scp))
    (kaldi / "train.utt2spk").write_text("".join(u2s))
    return {"prepare": {"dataset_dir": str(tmp_path / "corpus" / "x")},
            "kaldi_feature_params": {"sample_rate": 16000, "hop_length": 20,
                                     "n_fft": 400, "n_mels": 40}}


def test_compute_kaldi_features_matches_jax(tmp_path, monkeypatch):
    """Two speakers, two utterances each (one at 8 kHz, resampled), of
    amplitude-modulated audio (CMVN divides by each band's deviation); the
    JAX side takes its XLA extractor (no native library)."""
    monkeypatch.setattr(jdio, "_native_lib", lambda: None)
    utts = {"s1_a": ("s1", 12000, 16000), "s1_b": ("s1", 9000, 16000),
            "s2_a": ("s2", 15000, 16000), "s2_b": ("s2", 4000, 8000)}
    hparams = _kaldi_set(tmp_path, utts)
    got = compute_kaldi_features(hparams, "train", device="cpu")
    want = jdio.compute_kaldi_features(hparams, "train")
    assert list(got) == list(want)
    for utt in utts:
        assert got[utt].dtype == np.float32
        assert got[utt].shape == want[utt].shape
        assert got[utt].shape[1] == 120
        err = np.abs(got[utt] - want[utt]).max() / np.abs(want[utt]).max()
        assert err < CMVN_RTOL, (utt, err)


@pytest.mark.parametrize("batch_size", [2, 256])
def test_compute_kaldi_features_batches_as_one_call_each(tmp_path,
                                                         batch_size):
    """Batches padded to their longest utterance (of 2: the last batch
    holds one; of 256: all five in one) give each utterance the features
    of a batch of one, to CMVN_RTOL of the largest entry: rows past a
    shorter utterance's frames never reach its deltas or statistics, and
    the plain version's products may only sum in another order. The
    lengths run from 170 samples (under half a window) to 1.2 s."""
    utts = {"s1_a": ("s1", 19200, 16000), "s1_b": ("s1", 170, 16000),
            "s2_a": ("s2", 8000, 16000), "s2_b": ("s2", 12345, 16000),
            "s1_c": ("s1", 640, 16000)}
    hparams = _kaldi_set(tmp_path, utts)
    got = compute_kaldi_features(hparams, "train", device="cpu",
                                 batch_size=batch_size)
    want = compute_kaldi_features(hparams, "train", device="cpu",
                                  batch_size=1)
    assert list(got) == list(want) == list(utts)
    for utt in utts:
        assert got[utt].shape == want[utt].shape
        assert got[utt].shape[0] == (utts[utt][1] + 160) // 320
        err = np.abs(got[utt] - want[utt]).max() / np.abs(want[utt]).max()
        assert err < CMVN_RTOL, (utt, err)


# ---------------------------------------------------------------------------
# wav-in infer against the JAX TEST eval step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_build_md_vae(batch_size=1, overrides=dict(SMALL))
    jm.init_params()
    jm.ensure_states(RECIPE["input_size"])
    rs = np.random.RandomState(12)
    C = RECIPE["input_size"]
    jm.states["normalizer"] = {
        "count": jnp.float32(12.0),
        "glob_mean": jnp.asarray(rs.randn(C).astype(np.float32) * 5.0),
        "glob_std": jnp.asarray((5.0 + 10 * rs.rand(C)).astype(np.float32))}
    jm.target = Target.TEST
    pm = build_md_vae(batch_size=1, overrides=SMALL, device="cpu")
    pm.load_state_dict(from_jax(jax.device_get(jm.params),
                                jax.device_get(jm.states)))
    return jm, pm


@pytest.mark.parametrize("sr", [16000, 32000])
def test_infer_matches_jax_eval_step(models, sr, tmp_path):
    """The port's ``infer`` on a written wav against the JAX TEST eval step
    on JAX ``Fbank(deltas=True)`` features of the same file (read and
    resampled by the JAX package), the draws replayed: the same phoneme
    strings, start times and verdicts."""
    jm, pm = models
    path = tmp_path / "utt.wav"
    pwav.write_wav(path, synth_wave(int(0.6 * sr), 40, 0.25), sr)
    jenc = _jax_encoder()
    jenc.save(tmp_path / "label_encoder.txt")
    enc = LabelEncoder.load(tmp_path / "label_encoder.txt")
    canon = ["sil", "b", "aa", "d", "eh", "k", "sil"]
    prior = np.random.RandomState(7).dirichlet(np.ones(len(jenc))).astype(
        np.float32)

    jwave, jsr = jwav.read_wav(path)
    jwave = jwav.resample(jwave, jsr, 16000)
    jfeats = np.asarray(jfb.Fbank(deltas=True)(jwave[None]))[0]
    T = jfeats.shape[0]
    ids = jenc.encode_sequence(canon)
    one = jnp.ones((1,), jnp.float32)
    bnd = jnp.asarray(jax_uniform_boundary(T, len(ids)))[None]
    jbatch = {
        "feat": (jnp.asarray(jfeats)[None], one),
        "gt_cnncl_seq": (jnp.asarray(ids, jnp.int32)[None], one),
        "fa_boundary_seq": (bnd, one), "gt_boundary_seq": (bnd, one),
        "plvl_gt_md_lbl_seq": (jnp.zeros((1, len(ids)), jnp.int32), one),
        "prior": (jnp.asarray(prior)[None], one),
    }
    rng = jax.random.PRNGKey(0)
    j_preds, _ = jm.compute_forward(jm.params, jm.states, jbatch, Stage.TEST,
                                    rng, 1)
    starts = np.where(np.asarray(j_preds["decoded_boundary_seq"])[0] == 1)[0]
    plvl = np.asarray(j_preds["decoded_plvl_md_lbl_seq"])[0]

    hparams = {"sample_rate": 16000, "hop_length": 20,
               "compute_features": Fbank(deltas=True, device="cpu")}
    verdicts = infer(pm, hparams, enc, path, canon, prior, device="cpu",
                     noise=_eval_draws(rng, 1, T, pm.hparams))
    assert [set(v) for v in verdicts] == \
        [{"phoneme", "start_sec", "mispronounced"}] * len(canon)
    assert [v["phoneme"] for v in verdicts] == canon
    assert len(starts) == len(canon)
    assert [v["start_sec"] for v in verdicts] == \
        [round(float(s) * 20 / 1000.0, 3) for s in starts]
    assert [v["mispronounced"] for v in verdicts] == \
        plvl.astype(bool).tolist()
