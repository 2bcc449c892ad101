"""The port's entry points on the CPU (``--device cpu``), on the
synthesized SynAudioMNIST corpus with ``config/run.yaml``:

* ``cli.train`` (3 debug epochs of 2 batches: one PHN_RECOG -> B_DETECTOR
  -> VAE cycle), ``cli.test`` and ``cli.infer.main`` at the recipe's full
  width, with the assertions of ``tests/test_md_vae.py``: the target
  cycle, a checkpoint whose meta has ``plvl_md.F1``, ``train_log.txt``,
  ``test_metrics.txt`` and the saved-MD-results JSON;
* ``fit`` and ``evaluate`` against the JAX package's at narrow widths
  (every LSTM at H=32), from the JAX model's weights, with every draw of
  every train and eval step replayed (``Brain.noise_source``, as
  ``tests/test_torch_train_step.py`` replays them): each epoch's train and
  valid loss within rel 1e-4; then ``evaluate`` from the JAX run's best
  checkpoint: the decoded sequences equal, the MD and boundary statistics
  and ``test_metrics.txt`` equal, and the saved MD results equal;
* every run option of the JAX CLI reaches the Brain.

Both packages prepare their data in one working directory, so the port
reads the JAX package's computed datasets: the same batches."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from mlvae_tpu.cli.experiment import prepare_experiment as jax_prepare
from mlvae_tpu.data import data_io as jdio

from mlvae_tpu_torch.cli import infer as infer_cli
from mlvae_tpu_torch.cli import test as test_cli
from mlvae_tpu_torch.cli import train as train_cli
from mlvae_tpu_torch.cli.experiment import prepare_experiment
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.models.MD_VAE.model import Target
from mlvae_tpu_torch.training.checkpointer import Checkpointer
from test_torch_train_step import _replay

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "mlvae_tpu_torch/models/MD_VAE/model.yaml"
JAX_RECIPE = REPO / "mlvae_tpu/models/MD_VAE/model.yaml"
RTOL = 1e-4
# the loss weights the recipe leaves to the default 1.0, pinned
WEIGHTS = "recon_weight: 1.0, phn_recog_bce_weight: 1.0, " \
    "boundary_bce_weight: 1.0"
# batches of 6: the train set's 12 utterances in two, the valid and test
# sets' 6 in one each, so that the JAX side compiles one step per target
BATCH = 6
NARROW = "phn_rnn_hidden_size: 32, boundary_rnn_hidden_size: 32, " \
    "rnn_hidden_size: 32, dec_rnn_hidden_size: 32"


def _args(name, recipe=RECIPE, extra="", device=True, batch_size=8):
    args = [str(REPO / "config/run.yaml"), "--batch_size", str(batch_size),
            "--dataset", "SynAudioMNIST", "--language", "digits",
            "--n_phonemes", "12", "--model_class", "MD_VAE",
            "--model_name", name, "--model", f"!include:{recipe}",
            "--extra_overrides",
            "{model: {n_epochs: 3, %s%s}}" % (WEIGHTS, extra),
            "--debug", "--debug_batches", "2"]
    return args + (["--device", "cpu"] if device else [])


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_cli_train_test_infer_round_trip(workdir):
    """Full width, the assertions of tests/test_md_vae.py."""
    model = train_cli.main(_args("mdvae_smoke"))
    assert model.target == Target.VAE
    assert [e["epoch"] for e in model.epoch_log] == [1, 2, 3]
    assert all(e["batches"] == 2 and np.isfinite(e["loss"])
               and e["utt_sec_per_sec"] > 0 for e in model.epoch_log)
    assert model.rnn.hidden_size == 512 and model.device.type == "cpu"
    out_dir = workdir / "results/mdvae_smoke"
    ckpts = list((out_dir / "checkpoints").iterdir())
    assert len(ckpts) >= 1
    meta = json.loads((ckpts[0] / "meta.json").read_text())
    assert "plvl_md.F1" in meta and meta["epoch"] == 3
    assert {p.name for p in ckpts[0].iterdir()} == {
        "meta.json", "params.npz", "states.npz", "opt__optimizer.npz"}
    log_text = (out_dir / "train_log.txt").read_text()
    assert "pi_nll_loss" in log_text and "plvl_md.F1" in log_text
    assert (out_dir / "hyperparams.yaml").exists()

    model = test_cli.main(_args("mdvae_smoke"))
    assert set(model.evaluate_timing) == {"restore", "eval", "write",
                                          "batches"}
    metrics_text = (out_dir / "test_output/test_metrics.txt").read_text()
    assert "Epoch: 3" in metrics_text and "plvl_md.F1" in metrics_text
    saved = workdir / \
        "datasets/SynAudioMNIST/saved_md_results/mdvae_smoke.json"
    md_results = json.loads(saved.read_text())
    assert len(md_results) > 0
    for utt_results in md_results.values():
        for idx, start_pct, end_pct in utt_results:
            assert 0 <= start_pct < end_pct <= 1

    wav = sorted((workdir / "datasets/SynAudioMNIST/original_dataset"
                  ).rglob("*.wav"))[0]
    results = infer_cli.main(_args("mdvae_smoke") + [
        "--wav", str(wav), "--canonical", "one , two three four"])
    assert [r["phoneme"] for r in results] == ["one", "two", "three", "four"]
    assert all(isinstance(r["mispronounced"], bool) for r in results)


class _Recorder:
    """Wraps a model's ``on_stage_end`` and ``evaluate_predictions`` to
    keep each stage's loss and each evaluated batch's decode."""

    def __init__(self, model, to_host):
        self.stages, self.decodes = [], []
        end, ev = model.on_stage_end, model.evaluate_predictions

        def on_stage_end(stage, stage_loss, epoch=None):
            self.stages.append((stage.name, epoch, float(stage_loss)))
            return end(stage, stage_loss, epoch)

        def evaluate_predictions(preds, batch, stage):
            if "decoded_boundary_seq" in preds:
                self.decodes.append((stage.name, list(batch["id"]), {
                    k: to_host(v) for k, v in preds.items()}))
            return ev(preds, batch, stage)
        model.on_stage_end = on_stage_end
        model.evaluate_predictions = evaluate_predictions


class _JaxDraws:
    """The JAX Brain's step keys (one split of its rng a step, train and
    eval alike), each step's draws made from its key as the JAX step
    makes them."""

    def __init__(self, rng):
        self.rng = rng

    def __call__(self, draws):
        self.rng, key = jax.random.split(self.rng)
        return _replay(draws, key)


def test_fit_and_evaluate_match_jax(workdir, monkeypatch):
    monkeypatch.setattr(jdio, "_native_lib", lambda: None)
    jp = jax_prepare(_args("jx", JAX_RECIPE, ", " + NARROW, device=False,
                           batch_size=BATCH), prepare_exp_dir=True)
    pp = prepare_experiment(_args("px", extra=", " + NARROW,
                                  batch_size=BATCH))
    jm, pm = jp["model"], pp["model"]
    # the same batches: the port read the JAX package's computed sets
    for jds, pds in zip(jp["datasets"], pp["datasets"]):
        assert pds.ids == jds.ids
    jm.init_params()
    missing, unexpected = pm.load_state_dict(
        from_jax(jax.device_get(jm.params)), strict=False)
    assert not unexpected and all(k.startswith("normalizer.")
                                  for k in missing)
    pm.noise_source = _JaxDraws(jm.rng)
    jrec, prec = _Recorder(jm, np.asarray), \
        _Recorder(pm, lambda t: t.cpu().numpy())

    for prep, model in ((jp, jm), (pp, pm)):
        h = prep["hparams"]
        model.fit(h["model"]["epoch_counter"], prep["datasets"][0],
                  prep["datasets"][1],
                  train_loader_kwargs=h["train_dataloader_opts"],
                  valid_loader_kwargs=h["valid_dataloader_opts"])
    assert [s[:2] for s in prec.stages] == [s[:2] for s in jrec.stages] == \
        [(st, e) for e in (1, 2, 3) for st in ("TRAIN", "VALID")]
    for (name, epoch, got), (_, _, want) in zip(prec.stages, jrec.stages):
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   err_msg=f"{name} epoch {epoch}")
    # the normalizer's statistics after the two epochs that update them
    j_norm = jax.device_get(jm.states["normalizer"])
    assert float(pm.normalizer.count) == float(j_norm["count"]) == 24.0
    np.testing.assert_allclose(pm.normalizer.glob_mean.numpy(),
                               j_norm["glob_mean"], rtol=1e-5, atol=1e-6)

    # evaluate from the JAX run's best checkpoint, the draws replayed
    jck = jm.checkpointer.find_checkpoint(max_key="plvl_md.F1")
    pm.checkpointer = Checkpointer(jck.path.parent)
    jrec.decodes.clear()
    prec.decodes.clear()
    pm.noise_source = _JaxDraws(jm.rng)
    for prep, model in ((jp, jm), (pp, pm)):
        model.evaluate(prep["datasets"][2], max_key="plvl_md.F1",
                       test_loader_kwargs=prep["hparams"][
                           "test_dataloader_opts"])
    assert len(prec.decodes) == len(jrec.decodes) == 1   # 6 utterances
    for (_, pids, got), (_, jids, want) in zip(prec.decodes, jrec.decodes):
        assert pids == jids
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert pm.stats_loggers["plvl_md_stats"].scores_list == \
        jm.stats_loggers["plvl_md_stats"].scores_list
    assert pm.stats_loggers["boundary_stats"].scores_list == \
        jm.stats_loggers["boundary_stats"].scores_list
    md = "datasets/SynAudioMNIST/saved_md_results"
    assert json.loads((workdir / md / "px.json").read_text()) == \
        json.loads((workdir / md / "jx.json").read_text())

    def metrics(name):
        text = (workdir / f"results/{name}/test_output/test_metrics.txt"
                ).read_text().splitlines()
        return dict(ln.split(": ") for ln in text[1:-1])
    got, want = metrics("px"), metrics("jx")
    assert list(got) == list(want)
    for key in want:
        if "loss" in key:   # the losses, rounded to 2 or 3 decimals
            assert abs(float(got[key]) - float(want[key])) <= 0.01, key
        else:               # the MD and boundary scores: from the decode
            assert got[key] == want[key], key


@pytest.mark.parametrize("option,value", [
    ("scan_epoch", None), ("data_parallel", None), ("num_devices", "2"),
    ("tensor_parallel", "2"), ("zero1", None), ("async_ckpt", None),
    ("cache_device_batches", None), ("profile", None),
    ("ckpt_opt_state", "False")])
def test_unported_run_options_raise(workdir, option, value):
    """Every run option of the JAX CLI is taken and reaches the Brain
    (none raises as unported any more); the two that need ranks raise
    where a caller builds the experiment outside them (``cli.train`` /
    ``cli.test`` start them through ``run_ranked``;
    ``tests/test_torch_parallel.py``)."""
    args = _args("opts") + [f"--{option}"] + ([value] if value else [])
    if option in ("data_parallel", "tensor_parallel"):
        with pytest.raises(RuntimeError, match="run_ranked"):
            prepare_experiment(args)
        return
    model = prepare_experiment(args)["model"]
    reached = {
        "scan_epoch": lambda: model.scan_epoch,
        "num_devices": lambda: model.run_opts["num_devices"] == 2,
        "zero1": lambda: model.zero1,
        "async_ckpt": lambda: model.checkpointer.async_save,
        "cache_device_batches": lambda: (
            model.run_opts["cache_device_batches"]
            and model.cache_device_batches),
        "profile": lambda: model.profile,
        "ckpt_opt_state": lambda: not model.ckpt_opt_state}[option]
    assert reached()


def test_device_defaults_to_cuda(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prepare_experiment(_args("nodev", device=False))
    assert not os.path.exists(workdir / "results")
