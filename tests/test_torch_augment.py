"""The port's wave augmentation (``mlvae_tpu_torch/ops/augment.py``)
against the JAX package's: ``WaveAugment`` bit-equal from the same seed
over a run of calls (absolute and relative lengths, one wave and a padded
batch, speeds that keep or change the length), and ``prepare_datasets``
with ``augmentation`` in the run YAML on a small L2-ARCTIC-layout corpus
(``data/corpus_layout.py``): the same utterances, ``aug_wav`` equal, and
``aug_feat`` (the SpeechBrain pass over the augmented waves, cut to the
Kaldi frame count as the clean pass is) within rtol 1e-5, atol 1e-4 of the
JAX package's, as are the augmented labels."""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mlvae_tpu.data import data_io as jdio
from mlvae_tpu.data.datasets.L2_ARCTIC import prepare as jprep
from mlvae_tpu.hyperyaml import load_hyperyaml as jax_load
from mlvae_tpu.hyperyaml.loader import _parse_tagged as jax_parse_tagged
from mlvae_tpu.ops.augment import WaveAugment as JaxWaveAugment

from mlvae_tpu_torch.data import corpus_layout
from mlvae_tpu_torch.data import data_io as pdio
from mlvae_tpu_torch.data.datasets.L2_ARCTIC import prepare as pprep
from mlvae_tpu_torch.hyperyaml import load_hyperyaml
from mlvae_tpu_torch.hyperyaml.loader import _parse_tagged
from mlvae_tpu_torch.ops.augment import WaveAugment

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-4
# every train, valid and test speaker of the split with one utterance or
# two: 9 utterances
SPEAKERS = {"ABA": 2, "ASI": 1, "BWC": 1, "HJK": 2, "PNV": 1, "NJS": 1,
            "TLV": 1}
OVERRIDES = ("dataset: L2_ARCTIC\nmodel_class: MD_VAE\nmodel_name: aug\n"
             "model: !new:builtins.dict")


def _waves(seed, n=3, length=4000):
    rs = np.random.RandomState(seed)
    return (0.3 * np.sin(np.arange(length) / (7.0 + np.arange(n)[:, None]))
            + 0.05 * rs.randn(n, length)).astype(np.float32)


@pytest.mark.parametrize("lens", [None, "absolute", "relative"])
@pytest.mark.parametrize("speeds", [(0.95, 1.0, 1.05), (0.9, 1.1)])
def test_wave_augment_bit_equal(lens, speeds):
    waves = _waves(1)
    n = np.array([4000, 3100, 1777])
    arg = {None: None, "absolute": n, "relative": n / 4000.0}[lens]
    port, jax = WaveAugment(speeds, 25.0, seed=5), \
        JaxWaveAugment(speeds, 25.0, seed=5)
    for _ in range(3):   # the RandomState streams advance alike
        got, want = port(waves, arg), jax(waves, arg)
        assert got.shape == want.shape == waves.shape
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if lens is not None:   # noise over the true samples only
        for row, k in enumerate(n):
            assert not got[row, k:].any()
    one, one_j = port(waves[0]), jax(waves[0])
    np.testing.assert_array_equal(one, one_j)
    assert one.shape == (1, 4000)


def _hparams(jax: bool):
    load, parse = (jax_load, jax_parse_tagged) if jax else \
        (load_hyperyaml, _parse_tagged)
    text = (REPO / "config/run.yaml").read_text() + (
        "augmentation: !new:mlvae_tpu.ops.augment.WaveAugment\n"
        "  speeds: [0.9, 1.0, 1.1]\n  noise_snr_db: 20\n")
    return load(text, [parse(OVERRIDES)], **({} if jax else
                                              {"device": "cpu"}))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    cwd = os.getcwd()
    root = tmp_path_factory.mktemp("augment")
    mp = pytest.MonkeyPatch()
    mp.setattr(jdio, "_native_lib", lambda: None)
    try:
        out = {}
        for name in ("jax", "port"):
            (root / name).mkdir()
            os.chdir(root / name)
            corpus_layout.write_l2_arctic("datasets/L2_ARCTIC", SPEAKERS,
                                          seconds=(1.0, 2.0), seed=7)
            h = _hparams(name == "jax")
            (jprep if name == "jax" else pprep).prepare(**h["prepare"])
            out[name] = (jdio.prepare_datasets(h) if name == "jax" else
                         pdio.prepare_datasets(h, device="cpu"))
        yield out
    finally:
        mp.undo()
        os.chdir(cwd)


@pytest.mark.parametrize("split", [0, 1, 2])
def test_augmented_sets_match_jax(prepared, split):
    jds, pds = prepared["jax"][0][split], prepared["port"][0][split]
    assert pds.ids == jds.ids and len(pds.ids) > 0
    for utt in jds.ids:
        want, got = jds.data[utt], pds.data[utt]
        np.testing.assert_array_equal(np.asarray(got["aug_wav"]),
                                      np.asarray(want["aug_wav"]),
                                      err_msg=utt)
        assert not np.array_equal(np.asarray(got["aug_wav"]),
                                  np.asarray(got["wav"]))
        g, w = np.asarray(got["aug_feat"]), np.asarray(want["aug_feat"])
        assert g.shape == w.shape == np.asarray(got["feat"]).shape
        assert g.shape[0] == np.asarray(got["kaldi_feat"]).shape[0]
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=utt)
        for key in ("aug_flvl_gt_phn_seq", "aug_flvl_gt_cnncl_seq",
                    "aug_flvl_gt_md_lbl_seq"):
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]),
                                          err_msg=f"{utt} {key}")
