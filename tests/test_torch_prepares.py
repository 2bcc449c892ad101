"""The port's real-corpus preparation against the JAX package's: the
L2-ARCTIC, TIMIT and ChineseDPA ``prepare`` scripts on small corpora
written in each corpus's layout (the fixtures of
``tests/test_dataset_prepares.py``, and larger ones from
``mlvae_tpu_torch.data.corpus_layout`` with a numpy seed), run from a
working directory of their own with the relative paths of
``config/run.yaml``: every annotation JSON and ``kaldi_data`` file
byte-equal. Then the TextGrid reader and writer, L2-ARCTIC's
``parse_textgrid``, ChineseDPA's ``read_tg_file`` and ``parse_filt_prf``
(including the insertion and continuation cases) against the JAX
package's."""
import dataclasses
import importlib
import json
import os
from pathlib import Path

import numpy as np
import pytest

from mlvae_tpu.data import parsers as jparsers
from mlvae_tpu.data import textgrid as jtg
from mlvae_tpu.data.datasets.ChineseDPA import prepare as jdpa
from mlvae_tpu.data.datasets.L2_ARCTIC import parse_textgrid as jl2tg
from mlvae_tpu.data.wav import write_wav as jax_write_wav
from mlvae_tpu.utils.phonemes import PhonemeSetHandler as JaxHandler

from mlvae_tpu_torch.data import corpus_layout
from mlvae_tpu_torch.data import parsers as pparsers
from mlvae_tpu_torch.data import textgrid as ptg
from mlvae_tpu_torch.data.datasets.ChineseDPA import prepare as pdpa
from mlvae_tpu_torch.data.datasets.L2_ARCTIC import parse_textgrid as pl2tg
from mlvae_tpu_torch.utils.phonemes import PhonemeSetHandler

SETS = ("train", "valid", "test")


def _tests_l2_arctic(root: Path):
    """``tests/test_dataset_prepares.py``'s L2-ARCTIC fixture."""
    from mlvae_tpu.data.datasets.L2_ARCTIC import prepare as l2
    ds_dir = root / "original_dataset"
    fa = {}
    for spk in l2.TRAIN_SPKS[:2] + l2.VALID_SPKS[:1] + l2.TEST_SPKS[:1]:
        (ds_dir / spk / "annotation").mkdir(parents=True)
        (ds_dir / spk / "wav").mkdir(parents=True)
        utt = "arctic_a0001"
        jtg.write_textgrid(ds_dir / spk / "annotation" / f"{utt}.TextGrid", {
            "words": [(0.0, 0.5, "hi")],
            "phones": [(0.0, 0.25, "ao"), (0.25, 0.5, "ih,iy1")],
        })
        jax_write_wav(ds_dir / spk / "wav" / f"{utt}.wav",
                      np.zeros(8000, np.float32))
        fa[f"{spk}_a0001"] = [[0.0, 0.26], [0.26, 0.5]]
    (root / "fa_segmentation.json").write_text(json.dumps(fa))


def _tests_timit(root: Path):
    """``tests/test_dataset_prepares.py``'s TIMIT fixture."""
    ds_dir = root / "original_dataset"
    for split, spk in [("train", "mabc0"), ("test", "mdab0"),
                       ("test", "faks0")]:
        d = ds_dir / split / "dr1" / spk
        d.mkdir(parents=True)
        jax_write_wav(d / "si1.wav", np.zeros(8000, np.float32))
        (d / "si1.phn").write_text(
            "0 800 h#\n800 2400 ao\n2400 3200 kcl\n3200 4000 bcl\n"
            "4000 7200 iy\n7200 8000 h#\n")
        jax_write_wav(d / "sa1.wav", np.zeros(8000, np.float32))
        (d / "sa1.phn").write_text("0 8000 h#\n")


def _tests_chinese_dpa(root: Path):
    """``tests/test_dataset_prepares.py``'s ChineseDPA fixture."""
    ds_dir = root / "original_dataset"
    (ds_dir / "formatted_chinese_dpa").mkdir(parents=True)
    for set_name in SETS:
        meta = {"spk1": {f"{set_name}_u1": {
            "wav_path": f"{set_name}_u1.wav", "duration": 0.5}}}
        (ds_dir / f"metadata_{set_name}_spk_level.json").write_text(
            json.dumps(meta))
        jax_write_wav(ds_dir / "formatted_chinese_dpa" / f"{set_name}_u1.wav",
                      np.zeros(8000, np.float32))
        jtg.write_textgrid(
            ds_dir / "formatted_chinese_dpa" / f"{set_name}_u1.TextGrid", {
                "initial/final": [(0.0, 0.25, "zh1"), (0.25, 0.5, "ang4")],
                "mispronunciation": [(0.0, 0.25, ""), (0.25, 0.5, "+")]})


FIXTURES = {
    ("L2_ARCTIC", "tests"): _tests_l2_arctic,
    ("TIMIT", "tests"): _tests_timit,
    ("ChineseDPA", "tests"): _tests_chinese_dpa,
    ("L2_ARCTIC", "layout"): lambda r: corpus_layout.write_l2_arctic(
        r, {s: 1 + i % 2 for i, s in enumerate(corpus_layout.L2_SPEAKERS)},
        seconds=(0.8, 1.6), seed=3),
    ("TIMIT", "layout"): lambda r: corpus_layout.write_timit(
        r, {"train": ["mabc0", "fxyz1", "mjkl2"],
            "test": ["faks0", "fdac1", "mdab0", "mwbt0", "xxxx0"]},
        seed=4),
    ("TIMIT", "layout_upper"): lambda r: corpus_layout.write_timit(
        r, upper=True, seed=5),
    ("ChineseDPA", "layout"): lambda r: corpus_layout.write_chinese_dpa(
        r, seed=6),
}


def _run_prepare(workdir: Path, package: str, name: str, fixture):
    """The fixture under ``workdir/datasets/<name>``, then the package's
    prepare from ``workdir`` with run.yaml's relative paths."""
    os.chdir(workdir)
    root = Path("datasets") / name
    fixture(root)
    handler = (JaxHandler if package == "mlvae_tpu" else
               PhonemeSetHandler)("english", 39)
    mod = importlib.import_module(
        f"{package}.data.datasets.{name}.prepare")
    mod.prepare(root / "original_dataset",
                *[root / "annotation" / f"{s}.json" for s in SETS],
                phoneme_set_handler=handler)
    return root


@pytest.mark.parametrize("name,kind", sorted(FIXTURES))
def test_prepare_outputs_are_byte_equal(tmp_path, monkeypatch, name, kind):
    monkeypatch.chdir(tmp_path)
    outputs = {}
    for package in ("mlvae_tpu", "mlvae_tpu_torch"):
        (tmp_path / package).mkdir()
        root = _run_prepare(tmp_path / package, package, name,
                            FIXTURES[(name, kind)])
        files = [root / "annotation" / f"{s}.json" for s in SETS] + [
            root / "kaldi_data" / f"{s}.{ext}" for s in SETS
            for ext in ("wav.scp", "utt2spk")]
        outputs[package] = {str(p): p.read_bytes() for p in files}
    assert list(outputs["mlvae_tpu_torch"]) == list(outputs["mlvae_tpu"])
    for path, want in outputs["mlvae_tpu"].items():
        assert outputs["mlvae_tpu_torch"][path] == want, path
    train = json.loads(outputs["mlvae_tpu"][
        str(Path("datasets") / name / "annotation/train.json")])
    assert len(train) > 0


def test_layout_prepares_as_its_writer_says(tmp_path, monkeypatch):
    """The layout writers' utterances are the prepared sets', split by
    speaker as each corpus's prepare splits them."""
    monkeypatch.chdir(tmp_path)
    written = {}
    for name, kind in (("L2_ARCTIC", "layout"), ("TIMIT", "layout_upper"),
                       ("ChineseDPA", "layout")):
        os.chdir(tmp_path)
        root = Path("datasets") / name
        written[name] = FIXTURES[(name, kind)](root)
        _run_prepare(tmp_path, "mlvae_tpu_torch", name, lambda r: None)
        got = set()
        for s in SETS:
            got |= set(json.loads((root / "annotation" / f"{s}.json"
                                   ).read_text()))
        assert got == {u for utts in written[name].values() for u in utts}
    from mlvae_tpu_torch.data.datasets.L2_ARCTIC import prepare as l2
    valid = json.loads(Path("datasets/L2_ARCTIC/annotation/valid.json")
                       .read_text())
    assert {u.split("_")[0] for u in valid} == set(l2.VALID_SPKS)


def test_prepare_skips_when_the_jsons_exist(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = _run_prepare(tmp_path, "mlvae_tpu_torch", "TIMIT", _tests_timit)
    before = (root / "annotation/train.json").read_bytes()
    (root / "kaldi_data/train.wav.scp").unlink()
    _run_prepare(tmp_path, "mlvae_tpu_torch", "TIMIT", lambda r: None)
    assert (root / "annotation/train.json").read_bytes() == before
    assert not (root / "kaldi_data/train.wav.scp").exists()


def test_chinese_dpa_refuses_a_human_annotation_of_another_length(tmp_path):
    for package, mod, tg in (("mlvae_tpu", jdpa, jtg),
                             ("mlvae_tpu_torch", pdpa, ptg)):
        root = tmp_path / package / "ChineseDPA"
        _tests_chinese_dpa(root)
        (root / "original_dataset/human_annotation/spk1").mkdir(parents=True)
        tg.write_textgrid(
            root / "original_dataset/human_annotation/spk1/valid_u1.TextGrid",
            {"initial/final": [(0.0, 0.5, "zhang4")],
             "mispronunciation": [(0.0, 0.5, "")]})
        with pytest.raises(ValueError, match="human annotation has 1"):
            mod.prepare(root / "original_dataset",
                        *[root / "annotation" / f"{s}.json" for s in SETS])


TIERS = {
    "words": [(0.0, 0.5, "hello"), (0.5, 1.0, "world")],
    "phones": [(0.0, 0.25, "HH"), (0.25, 0.5, "AH0,AA1,s"),
               (0.5, 0.75, ""), (0.75, 0.8, ",L,a"), (0.8, 1.0, "OW1")],
    "initial/final": [(0.0, 0.3, "zh1"), (0.3, 1.0, "ang4")],
}


def _tg(tg):
    return dataclasses.asdict(tg)


@pytest.mark.parametrize("xmax", [None, 1.25])
def test_write_textgrid_bytes_equal(tmp_path, xmax):
    ptg.write_textgrid(tmp_path / "p.TextGrid", TIERS, xmax=xmax)
    jtg.write_textgrid(tmp_path / "j.TextGrid", TIERS, xmax=xmax)
    assert (tmp_path / "p.TextGrid").read_bytes() == \
        (tmp_path / "j.TextGrid").read_bytes()


@pytest.mark.parametrize("include_empty", [True, False])
def test_read_textgrid_matches_jax(tmp_path, include_empty):
    path = tmp_path / "x.TextGrid"
    jtg.write_textgrid(path, TIERS)
    # a quoted quote and a non-interval tier, which the reader skips
    text = path.read_text().replace('"world"', '"say ""hi"""') + (
        '    item [4]:\n        class = "TextTier"\n'
        '        name = "points"\n')
    path.write_text(text)
    got = ptg.read_textgrid(path, include_empty_intervals=include_empty)
    want = jtg.read_textgrid(path, include_empty_intervals=include_empty)
    assert _tg(got) == _tg(want)
    assert got.get_tier_by_name("words").intervals[1].text == 'say "hi"'
    assert len(got.get_tier_by_name("phones").intervals) == \
        5 - (not include_empty)
    with pytest.raises(KeyError):
        got.get_tier_by_name("absent")


@pytest.mark.parametrize("level", ["all", "word", "phoneme",
                                   "canonical_phoneme"])
def test_l2_parse_textgrid_matches_jax(tmp_path, level):
    path = tmp_path / "x.TextGrid"
    ptg.write_textgrid(path, TIERS)
    got = pl2tg.parse_textgrid(path, level)
    assert got == jl2tg.parse_textgrid(path, level)
    if level == "phoneme":   # ',L,a' has an empty slot: skipped
        assert got == ["hh", "aa", "ow"]


def test_chinese_dpa_read_tg_file_matches_jax(tmp_path):
    path = tmp_path / "x.TextGrid"
    ptg.write_textgrid(path, {
        "initial/final": [(0.0, 0.2, "sil"), (0.2, 0.4, "zh"),
                          (0.4, 0.7, "ang4"), (0.7, 1.0, "")],
        "mispronunciation": [(0.0, 0.2, "sil"), (0.2, 0.4, "+"),
                             (0.4, 0.7, "sub"), (0.7, 1.0, "")]})
    got = pdpa.read_tg_file(path)
    assert got == jdpa.read_tg_file(path)
    assert got[0] == ["sil", "zh", "ang", ""] and got[2] == ["", "+", "s", ""]


FILT_PRF = {
    "basic": ('File: utt1\nREF:  one two *** three\n'
              'HYP:  one six two three\nH_T1: 0.0 0.5 0.9 1.0\n'
              'H_T2: 0.5 0.9 1.0 1.5\n'),
    "continuation": ('File: utt1\nREF:  one two\nHYP:  one two\n'
                     'H_T1: 0.0 0.5\nH_T2: 0.5 0.9\nREF:  three\n'
                     'HYP:  three\nH_T1: 0.9\nH_T2: 1.3\nFile: utt2\n'
                     'REF:  four\nHYP:  four\nH_T1: 0.0\nH_T2: 0.4\n'),
    "deletions": ('File: utt3\nREF:  AA BB CC\nHYP:  *** BB ***\n'
                  'H_T1: 0.2\nH_T2: 0.6\nnot a row\n'),
}


@pytest.mark.parametrize("case", sorted(FILT_PRF))
def test_parse_filt_prf_matches_jax(tmp_path, case):
    path = tmp_path / "x.filt.prf"
    path.write_text("header\n" * 25 + FILT_PRF[case])
    got = pparsers.parse_filt_prf(path, tmp_path / "p" / "out.json")
    want = jparsers.parse_filt_prf(path, tmp_path / "j" / "out.json")
    assert got == want
    assert (tmp_path / "p/out.json").read_bytes() == \
        (tmp_path / "j/out.json").read_bytes()
    if case == "basic":   # the insertion consumed its time slot
        assert got["utt1"][2] == [1.0, 1.5, "three"]


def test_parse_filt_prf_refuses_as_jax(tmp_path):
    for mod in (pparsers, jparsers):
        with pytest.raises(FileNotFoundError):
            mod.parse_filt_prf(tmp_path / "absent.prf")
    path = tmp_path / "bad.filt.prf"
    path.write_text("\n" * 25 + "File: u\nREF:  a b\nHYP:  a\n")
    for mod in (pparsers, jparsers):
        with pytest.raises(ValueError, match="length mismatch"):
            mod.parse_filt_prf(path)
