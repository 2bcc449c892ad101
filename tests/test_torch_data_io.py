"""The port's data path against the JAX package's, on the synthesized
SynAudioMNIST corpus at the recipe's front end (``config/run.yaml``: 16
kHz, 20 ms hop, n_fft 400, 40 mels with deltas): the generator's files
byte for byte, the prepared annotation JSON, ``prepare_datasets``'s sets
(utterance order, keys, every integer and boundary key exact, the prior
exact, ``feat`` within 2e-3 dB and ``kaldi_feat`` within 1e-4 of its
largest entry, the absolute gate of ``tests/test_torch_fbank.py`` and the
CMVN gate of ``tests/test_torch_wav_infer.py``),
``PaddedBatch`` and ``DataLoader`` (arrays and relative lengths equal), and
the saved-MD-results cleaning with a crafted dump as ``tests/test_md_vae.py``
crafts it. The JAX side takes its XLA extractor (no native library)."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mlvae_tpu.data import data_io as jdio
from mlvae_tpu.data.batch import DataLoader as JaxDataLoader
from mlvae_tpu.data.batch import PaddedBatch as JaxPaddedBatch
from mlvae_tpu.data.datasets.SynAudioMNIST import prepare as jprep
from mlvae_tpu.data.synth import generate_corpus as jax_generate_corpus
from mlvae_tpu.hyperyaml import load_hyperyaml as jax_load
from mlvae_tpu.hyperyaml.loader import _parse_tagged as jax_parse_tagged

from mlvae_tpu_torch.data import data_io as pdio
from mlvae_tpu_torch.data.batch import DataLoader, PaddedBatch
from mlvae_tpu_torch.data.datasets.SynAudioMNIST import prepare as pprep
from mlvae_tpu_torch.data.synth import generate_corpus
from mlvae_tpu_torch.hyperyaml import load_hyperyaml
from mlvae_tpu_torch.hyperyaml.loader import _parse_tagged

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# SpeechBrain features (dB), static and deltas alike. The relative golden
# gate of tests/test_torch_fbank.py (1e-4, denominator floored at 1e-3)
# does not hold here: this corpus's quiet bands sit near 0 dB, where the
# plain version's f32 DFT rounding reaches 1.8e-4 of the value against the
# JAX package (1.5e-4 against the float64 golden, where the JAX package is
# at 5e-5), about 2e-5 dB
DB_ATOL = 2e-3
CMVN_RTOL = 1e-4   # Kaldi features after speaker CMVN, of the largest entry
OVERRIDES = ("dataset: SynAudioMNIST\nlanguage: digits\nn_phonemes: 12\n"
             "model_class: MD_VAE\nmodel_name: data_io\n"
             "model: !new:builtins.dict")
# every key whose values are labels, boundaries or durations: exact
EXACT_KEYS = ("duration", "gt_phn_seq", "gt_cnncl_seq", "flvl_gt_phn_seq",
              "flvl_gt_cnncl_seq", "aug_flvl_gt_phn_seq",
              "aug_flvl_gt_cnncl_seq", "plvl_gt_md_lbl_seq",
              "flvl_gt_md_lbl_seq", "aug_flvl_gt_md_lbl_seq", "gt_seg_seq",
              "gt_boundary_seq", "gt_phn_end_seq", "fa_seg_seq",
              "fa_boundary_seq", "fa_phn_end_seq", "prior", "wav",
              "aug_wav")


def _hparams(jax: bool, extra: str = ""):
    load, parse = (jax_load, jax_parse_tagged) if jax else \
        (load_hyperyaml, _parse_tagged)
    kw = {} if jax else {"device": "cpu"}
    with open(REPO / "config/run.yaml") as f:
        return load(f, [parse(OVERRIDES + extra)], **kw)


def _prepare(workdir: Path, jax: bool, extra: str = ""):
    os.chdir(workdir)
    h = _hparams(jax, extra)
    (jprep if jax else pprep).prepare(**h["prepare"])
    if jax:
        return jdio.prepare_datasets(h)
    return pdio.prepare_datasets(h, device="cpu")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both packages' datasets, each prepared in a working directory of its
    own (corpus synthesized, both feature passes, pickled cache)."""
    cwd = os.getcwd()
    root = tmp_path_factory.mktemp("data_io")
    mp = pytest.MonkeyPatch()
    mp.setattr(jdio, "_native_lib", lambda: None)
    try:
        out = {}
        for name in ("jax", "port"):
            (root / name).mkdir()
            out[name] = _prepare(root / name, name == "jax")
        out["root"] = root
        yield out
    finally:
        mp.undo()
        os.chdir(cwd)


def test_synthesized_corpus_is_byte_equal(tmp_path):
    generate_corpus(tmp_path / "port", n_speakers=2, utts_per_speaker=3)
    jax_generate_corpus(tmp_path / "jax", n_speakers=2, utts_per_speaker=3)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert sorted(p.relative_to(tmp_path / "port")
                  for p in (tmp_path / "port").rglob("*")
                  if p.is_file()) == files
    assert len(files) == 2 * 4 + 1   # wavs, metas, the forced alignment
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel


def test_synthesized_corpus_with_a_digit_range(tmp_path):
    """``digits_per_utt=(lo, hi)``: each utterance's digit count in the
    range, several counts, segments and durations that follow them."""
    generate_corpus(tmp_path, n_speakers=2, utts_per_speaker=8,
                    digits_per_utt=(2, 5))
    counts = set()
    for meta in (tmp_path / "original_dataset").glob("*/*_meta.json"):
        for utt in json.loads(meta.read_text()).values():
            n = len(utt["canonical_digit_seq"])
            assert 2 <= n <= 5
            assert len(utt["pronounced_digit_seq"]) == \
                len(utt["segment_seq"]) == n
            assert utt["segment_seq"][-1][1] < utt["duration"]
            counts.add(n)
    assert len(counts) > 1


def test_prepared_annotations_are_equal(prepared):
    root = prepared["root"]
    rel = Path("datasets/SynAudioMNIST")
    for name in ("annotation/train.json", "annotation/valid.json",
                 "annotation/test.json", "kaldi_data/train.wav.scp",
                 "kaldi_data/test.utt2spk"):
        assert (root / "port" / rel / name).read_text() == \
            (root / "jax" / rel / name).read_text(), name


@pytest.mark.parametrize("split", [0, 1, 2])
def test_prepare_datasets_matches_jax(prepared, split):
    (jsets, jenc), (psets, penc) = prepared["jax"], prepared["port"]
    assert penc.lab2ind == jenc.lab2ind
    jds, pds = jsets[split], psets[split]
    assert pds.ids == jds.ids and len(pds.ids) > 0
    for utt in jds.ids:
        want, got = jds.data[utt], pds.data[utt]
        assert list(got) == list(want)
        for key in EXACT_KEYS:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]),
                                          err_msg=f"{utt} {key}")
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
        for key in ("feat", "aug_feat"):
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.shape == w.shape and g.dtype == np.float32
            assert np.abs(g - w).max() < DB_ATOL, (utt, key)
        for key in ("kaldi_feat", "aug_kaldi_feat"):
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.shape == w.shape and g.dtype == np.float32
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err < CMVN_RTOL, (utt, key, err)


@pytest.mark.parametrize("batch_size", [3, 8])
def test_padded_batches_match_jax(prepared, batch_size):
    """The same samples batch to the same padded arrays and relative
    lengths; the loaders yield the same batches in the same order."""
    jds = prepared["jax"][0][0]
    loaders = [JaxDataLoader(jds, batch_size=batch_size),
               DataLoader(jds, batch_size=batch_size)]
    pairs = list(zip(*loaders))
    assert len(pairs) == len(loaders[0]) == len(loaders[1])
    for want, got in pairs:
        assert isinstance(got, PaddedBatch)
        assert got.ids == want.ids and got.keys() == want.keys()
        for key in want.keys():
            if key == "id":
                continue
            for g, w in zip(got[key], want[key]):
                np.testing.assert_array_equal(g, w, err_msg=key)
                assert g.dtype == w.dtype
    samples = [jds[i] for i in range(3)]
    got, want = PaddedBatch(samples), JaxPaddedBatch(samples)
    assert got["feat"][0].shape[1] % 32 == 0
    assert got["wav"][0].shape[1] % 8000 == 0
    assert got["gt_cnncl_seq"][0].shape[1] % 8 == 0
    np.testing.assert_array_equal(got["feat"][1], want["feat"][1])


def test_saved_md_results_cleaning_matches_jax(prepared):
    """A crafted dump (phoneme 1 of one TEST utterance flagged, as
    ``tests/test_md_vae.py`` crafts it) cleans both packages' sets alike:
    same utterances and keys, every exact key equal, the frame keys cut by
    the flagged phoneme's forced-alignment span; the zero-coverage warning
    for the train and valid splits."""
    root = prepared["root"]
    test_ids = prepared["jax"][0][2].ids
    crafted = {u: [] for u in test_ids}
    crafted[test_ids[0]] = [[1, 0.25, 0.5]]
    extra = "\nsaved_md_results_model_name: crafted"
    mp = pytest.MonkeyPatch()
    mp.setattr(jdio, "_native_lib", lambda: None)
    cwd = os.getcwd()
    try:
        cleaned = {}
        for name in ("jax", "port"):
            path = root / name / "datasets/SynAudioMNIST/saved_md_results"
            path.mkdir(parents=True, exist_ok=True)
            (path / "crafted.json").write_text(json.dumps(crafted))
            with pytest.warns(UserWarning, match=r"cover 0/\d+ utterances"):
                cleaned[name] = _prepare(root / name, name == "jax", extra)
    finally:
        mp.undo()
        os.chdir(cwd)
    utt = test_ids[0]
    for split in range(3):
        jds, pds = cleaned["jax"][0][split], cleaned["port"][0][split]
        assert pds.ids == jds.ids
        for u in jds.ids:
            for key in EXACT_KEYS:
                np.testing.assert_array_equal(
                    np.asarray(pds.data[u][key]),
                    np.asarray(jds.data[u][key]), err_msg=f"{u} {key}")
            assert np.asarray(pds.data[u]["feat"]).shape == \
                np.asarray(jds.data[u]["feat"]).shape
    base = prepared["jax"][0][2].data[utt]
    clean = cleaned["port"][0][2].data[utt]
    fa = np.asarray(base["fa_boundary_seq"])
    starts = np.flatnonzero(fa == 1).tolist() + [len(fa)]
    span = starts[2] - starts[1]
    assert len(clean["gt_phn_seq"]) == len(base["gt_phn_seq"]) - 1
    assert len(clean["feat"]) == len(base["feat"]) - span
    assert len(clean["fa_boundary_seq"]) == len(clean["feat"]) == \
        len(clean["flvl_gt_phn_seq"]) == len(clean["gt_boundary_seq"])
    assert int((np.asarray(clean["fa_boundary_seq"]) == 1).sum()) == \
        len(clean["gt_phn_seq"])


def test_sb_features_one_call_per_chunk(prepared):
    """The SpeechBrain pass gives each utterance the features of a call on
    it alone, whatever the chunk it shares (chunk 2 and 256)."""
    from mlvae_tpu_torch.ops.fbank import Fbank
    jds = prepared["jax"][0][1]
    wavs = {u: np.asarray(jds.data[u]["wav"]) for u in jds.ids}
    fb = Fbank(deltas=True, n_fft=400, n_mels=40, hop_length=20,
               device="cpu")
    calls = []
    counted = lambda w, l: calls.append(len(l)) or fb(w, l)  # noqa: E731
    counted.hop = fb.hop
    alone = {u: fb(w[None]).numpy()[0] for u, w in wavs.items()}
    for chunk in (2, 256):
        calls.clear()
        got = pdio.sb_features(counted, wavs, chunk_size=chunk)
        assert calls == [min(chunk, len(wavs) - i)
                         for i in range(0, len(wavs), chunk)]
        for u in wavs:
            np.testing.assert_allclose(got[u], alone[u], rtol=1e-5,
                                       atol=1e-4, err_msg=u)


def test_unported_datasets_name_the_roadmap(prepared, monkeypatch):
    """No dataset is refused any longer: each of the three real corpora
    passes ``_unported`` and has its port ``prepare``, and ``data_io_prep``
    takes an ``augmentation`` (its waves and features differ from the
    clean ones, frame for frame as long)."""
    import importlib
    from mlvae_tpu_torch.cli.experiment import UNPORTED_DATASETS, _unported
    assert UNPORTED_DATASETS == {}
    for name in ("TIMIT", "L2_ARCTIC", "ChineseDPA"):
        _unported("dataset", name, UNPORTED_DATASETS)
        mod = importlib.import_module(
            f"mlvae_tpu_torch.data.datasets.{name}.prepare")
        assert callable(mod.prepare)
    monkeypatch.chdir(prepared["root"] / "port")
    # a run YAML that names the augmenter, by the JAX package's name
    text = (REPO / "config/run.yaml").read_text() + (
        "augmentation: !new:mlvae_tpu.ops.augment.WaveAugment\n"
        "  speeds: [0.9, 1.1]\n")
    h = load_hyperyaml(text, [_parse_tagged(OVERRIDES)], device="cpu")
    train = pdio.data_io_prep(h, device="cpu")[0]
    for utt in train.ids[:3]:
        s = train.compute_sample(utt, ["wav", "aug_wav", "feat", "aug_feat"])
        assert s["aug_wav"].shape == s["wav"].shape
        assert not np.allclose(s["aug_wav"], s["wav"])
        assert s["aug_feat"].shape == s["feat"].shape
        assert not np.allclose(s["aug_feat"], s["feat"])
