"""The port's last two CLI commands against the JAX package's, on the CPU
(``--device cpu``), on the synthesized SynAudioMNIST corpus:

* ``cli.test_on_three_sets`` of w2v_CRDNN_CTC_cnncl (its trunk shrunk as
  ``tests/test_w2v_recipes.py`` shrinks it) from one JAX training run's
  checkpoint: the dump of every utterance's posteriors
  (``saved_phn_recog_outs.pkl``, the three sets' TEST passes) within atol
  1e-5 of the JAX CLI's, and ``test_metrics.txt`` equal; then the loop
  closes: ``cli.train`` of MD_VAE_sfl_saved_phn_recog reads the port's
  dump (two epochs, B_DETECTOR -> VAE, finite losses);
* ``cli.test_external`` over an external DNN-HMM JSON (the ground-truth
  segments, phones mixed from the canonical ones, ``sil`` and a starred
  one): the ``fa.*`` and ``asr.*`` metrics equal to the JAX CLI's (rel
  1e-12), and a JSON missing a test utterance refused."""
import json
import math
import pickle
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mlvae_tpu.cli import test_external as jax_test_external
from mlvae_tpu.cli import test_on_three_sets as jax_three_sets
from mlvae_tpu.cli import train as jax_train
from mlvae_tpu.cli.experiment import prepare_experiment as jax_prepare

from mlvae_tpu_torch.cli import test_external, test_on_three_sets
from mlvae_tpu_torch.cli import train as port_train
from test_torch_w2v_recipes import CNNCL_TRUNK, w2v_args, workdir  # noqa

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SFL_NARROW = ("phn_rnn_hidden_size: 32, boundary_rnn_hidden_size: 32, "
              "rnn_hidden_size: 32, dec_rnn_hidden_size: 32, "
              "pi_mcmc_num: 2")


def _metrics(workdir, name):
    text = (workdir / f"results/{name}/test_output/test_metrics.txt"
            ).read_text().splitlines()
    return dict(ln.split(": ") for ln in text[1:-1])


def _dump(workdir, name):
    path = workdir / f"results/{name}/saved_phn_recog_outs.pkl"
    with open(path, "rb") as f:
        out = pickle.load(f)
    path.unlink()
    return out


def test_three_sets_dumps_match_jax_and_feed_saved_phn_recog(workdir):
    recipe = "w2v_CRDNN_CTC_cnncl"
    jax_args = w2v_args(recipe, "x", "mlvae_tpu", False, 1, CNNCL_TRUNK)
    port_args = w2v_args(recipe, "x", "mlvae_tpu_torch", True, 1,
                         CNNCL_TRUNK)
    jax_train.main(jax_args)
    jax_three_sets.main(jax_args)
    want, want_metrics = _dump(workdir, "x"), _metrics(workdir, "x")
    model = test_on_three_sets.main(port_args)
    got, got_metrics = _dump(workdir, "x"), _metrics(workdir, "x")
    ids = [u for ds in jax_prepare(jax_args, prepare_exp_dir=False)[
        "datasets"] for u in ds.ids]
    assert sorted(got) == sorted(want) == sorted(ids)   # all three sets
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert got_metrics == want_metrics
    assert int(model.current_epoch()) == 1

    # the loop: the saved-posterior recipe reads the port's dump
    with open(workdir / "results/x/saved_phn_recog_outs.pkl", "wb") as f:
        pickle.dump(got, f)
    yaml = REPO / "mlvae_tpu_torch/models/MD_VAE_sfl_saved_phn_recog/" \
        "model.yaml"
    args = [str(REPO / "config/run.yaml"), "--batch_size", "6",
            "--dataset", "SynAudioMNIST", "--language", "digits",
            "--n_phonemes", "12", "--model_class",
            "MD_VAE_sfl_saved_phn_recog", "--model_name", "spr",
            "--model", f"!include:{yaml}", "--extra_overrides",
            "{model: {n_epochs: 2, %s, phn_recog_outs_path: "
            "x/saved_phn_recog_outs.pkl}}" % SFL_NARROW,
            "--debug", "--debug_batches", "1", "--device", "cpu"]
    spr = port_train.main(args)
    assert len(spr.saved_phn_recog_outs) == len(ids)
    log = (workdir / "results/spr/train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"train: loss: ([-0-9.e]+)",
                                           log)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)


def _external(workdir, test_ids, labels, drop=None):
    """External results for the test set: the ground-truth segments, each
    phone the canonical one, ``sil`` or a starred one in turn."""
    with open(workdir / "datasets/SynAudioMNIST/computed_dataset/test.pkl",
              "rb") as f:
        computed = pickle.load(f)
    ext = {}
    for n, utt in enumerate(test_ids):
        s = computed[utt]
        rows = []
        for i, (a, b) in enumerate(np.asarray(s["gt_seg_seq"], np.float64)):
            phn = "sil"
            if (i + n) % 3 == 0:
                phn = labels.decode_ndim(int(s["gt_cnncl_seq"][i]))
            elif (i + n) % 3 == 1:
                phn = "sil*"
            rows.append([float(a), float(b), phn])
        ext[utt] = rows
    if drop is not None:
        ext.pop(drop)
    ext_dir = workdir / "datasets/SynAudioMNIST/external_data"
    ext_dir.mkdir(parents=True, exist_ok=True)
    (ext_dir / "dnn_hmm_test.json").write_text(json.dumps(ext))


def test_external_metrics_match_jax(workdir, capsys):
    yaml = REPO / "mlvae_tpu/models/test_vanilla_vae/model.yaml"
    args = [str(REPO / "config/run.yaml"), "--dataset", "SynAudioMNIST",
            "--language", "digits", "--n_phonemes", "12", "--model_class",
            "test_vanilla_vae", "--model_name", "ext", "--model",
            f"!include:{yaml}"]
    prepared = jax_prepare(args, prepare_exp_dir=False)
    test_ids, labels = prepared["datasets"][2].ids, prepared["label_encoder"]
    _external(workdir, test_ids, labels)
    want = jax_test_external.main(args)
    port_yaml = str(yaml).replace("/mlvae_tpu/", "/mlvae_tpu_torch/")
    port_args = [a.replace(str(yaml), port_yaml) for a in args] + [
        "--device", "cpu"]
    capsys.readouterr()
    got = test_external.main(port_args)
    printed = capsys.readouterr().out
    assert set(got) == set(want) == {"fa", "asr"}
    for part in ("fa", "asr"):
        assert list(got[part]) == list(want[part])
        for k, v in want[part].items():
            assert math.isclose(got[part][k], v, rel_tol=1e-12,
                                abs_tol=1e-12), (part, k)
            assert f"{part}.{k}: {round(got[part][k], 2)}" in printed
    assert 0 < want["asr"]["MD.ACC"] < 100
    _external(workdir, test_ids, labels, drop=test_ids[0])
    with pytest.raises(ValueError, match="missing 1 test"):
        test_external.main(port_args)
