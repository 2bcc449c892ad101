"""The wav2vec2 recipes through the port's ``fit`` and ``evaluate``
against the JAX package's, on the synthesized SynAudioMNIST corpus with
``config/run.yaml`` (the pattern of ``tests/test_torch_md_vae_family.py``):
the encoder shrunk as ``tests/test_w2v_recipes.py`` shrinks it
(``wav2vec2_size: 64``: two layers, hidden 64), narrow heads, the JAX
model's weights (its stacked encoder layers unstacked by ``from_jax``),
and every draw of every train and eval step replayed
(``Brain.noise_source``: a fine-tuned trunk's dropout first, then the
recipe's):

* each epoch's train loss within rel 1e-4 and valid loss within rel 1e-3
  (f32): the first updates of Adam (the trunk) and Adadelta are near lr *
  sign(g), so an entry whose gradient is rounding noise moves a whole step
  either way (w2v_CRDNN_CTC_cnncl's VALID loss, after two steps on its
  128-channel CNN, lies 2.7e-4 from the JAX run's, the others' within
  4e-5);
* then ``evaluate`` from the JAX run's best checkpoint (read by the
  port's checkpointer, the encoder's layers stacked as the JAX package
  stacks them): ``test_metrics.txt`` equal, and for w2v_CRDNN_CTC_cnncl
  the saved posteriors (``saved_phn_recog_outs.pkl``) within atol 1e-5.

This file: w2v_CRDNN_CTC (fine-tuned trunk, its LSTM at H=32 on K1),
w2v_CRDNN_CTC_cnncl (its recipe trunk shrunk as the JAX smoke test does)
and w2v_LSTM_FC; also w2v_CRDNN_CTC under ``--bf16``, where its H=32 LSTM
takes ``nn.rnn.lstm_scan`` in the port and the bf16-carry scan in the JAX
package: the first step's loss rel 1e-2 (the AMP tests' bound; it lies
5.2e-3 off, the bf16 trunk's outputs a few bf16 steps from XLA's fused
ones), the VALID loss after that step rel 5e-2 (3.8e-2 off: one bf16
step's gradients differ by several per cent, the AMP tests' 5e-2). The MD_VAE family is in
``tests/test_torch_w2v_md_vae.py``."""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from mlvae_tpu.cli.experiment import prepare_experiment as jax_prepare
from mlvae_tpu.data import data_io as jdio

from mlvae_tpu_torch.bench_utils import unset_loss_weights
from mlvae_tpu_torch.cli.experiment import prepare_experiment
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.training.checkpointer import Checkpointer
from test_torch_cli import _Recorder
from test_torch_wav2vec2 import replay

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RTOL, VALID_RTOL = 1e-4, 1e-3
AMP_RTOL, AMP_VALID_RTOL = 1e-2, 5e-2
BATCH = 6
CNNCL_TRUNK = ("min_key: loss, cnn_blocks: 1, rnn_layers: 1, "
               "rnn_neurons: 32, rnn_bidirectional: False, dnn_blocks: 1, "
               "dnn_neurons: 64")
# recipe -> (epochs, extra model overrides)
RECIPES = {
    "w2v_CRDNN_CTC": (1, ""),
    "w2v_CRDNN_CTC_cnncl": (1, CNNCL_TRUNK),
    "w2v_LSTM_FC": (1, ""),
}


def w2v_args(recipe, name, package, device, epochs, extra="", batches=2):
    yaml = REPO / package / "models" / recipe / "model.yaml"
    pinned = ", ".join(f"{k}: 1.0" for k in unset_loss_weights(yaml))
    extra = ", ".join(x for x in ("wav2vec2_size: 64", extra, pinned) if x)
    args = [str(REPO / "config/run.yaml"), "--batch_size", str(BATCH),
            "--dataset", "SynAudioMNIST", "--language", "digits",
            "--n_phonemes", "12", "--model_class", recipe,
            "--model_name", name, "--model", f"!include:{yaml}",
            "--extra_overrides",
            "{model: {n_epochs: %d, %s}}" % (epochs, extra),
            "--debug", "--debug_batches", str(batches)]
    return args + (["--device", "cpu"] if device else [])


class JaxDraws:
    """The JAX Brain's step keys (one split of its rng a step, train and
    eval alike), each step's draws made from its key as the JAX step
    makes them."""

    def __init__(self, rng):
        self.rng = rng

    def __call__(self, draws):
        self.rng, key = jax.random.split(self.rng)
        return replay(draws, key)


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jdio, "_native_lib", lambda: None)
    return tmp_path


def fit_both(recipe, epochs, extra="", bf16=False, batches=2):
    """Both packages' prepared runs, the port on the JAX weights and draws,
    each fitted; returns (jax prepared, port prepared, JAX recorder, port
    recorder)."""
    more = ["--bf16", "True"] if bf16 else []
    jp = jax_prepare(w2v_args(recipe, "jx", "mlvae_tpu", False, epochs,
                              extra, batches) + more, prepare_exp_dir=True)
    pp = prepare_experiment(w2v_args(recipe, "px", "mlvae_tpu_torch", True,
                                     epochs, extra, batches) + more)
    jm, pm = jp["model"], pp["model"]
    for jds, pds in zip(jp["datasets"], pp["datasets"]):
        assert pds.ids == jds.ids
    assert sorted(n for n, _ in pm.named_children()
                  if n != "normalizer") == sorted(
        n for n in jp["hparams"]["model"]["modules"] if n != "normalizer")
    jm.init_params()
    missing, unexpected = pm.load_state_dict(
        from_jax(jax.device_get(jm.params)), strict=False)
    assert not unexpected and all(k.startswith("normalizer.")
                                  for k in missing)
    pm.noise_source = JaxDraws(jm.rng)
    jrec, prec = _Recorder(jm, np.asarray), \
        _Recorder(pm, lambda t: t.cpu().numpy())
    for prep, model in ((jp, jm), (pp, pm)):
        h = prep["hparams"]
        model.fit(h["model"]["epoch_counter"], prep["datasets"][0],
                  prep["datasets"][1],
                  train_loader_kwargs=h["train_dataloader_opts"],
                  valid_loader_kwargs=h["valid_dataloader_opts"])
    assert [s[:2] for s in prec.stages] == [s[:2] for s in jrec.stages]
    return jp, pp, jrec, prec


def check_stage_losses(jrec, prec):
    """TRAIN losses rel 1e-4; VALID, after the epoch's updates, rel 1e-3."""
    assert prec.stages
    for (name, epoch, got), (_, _, want) in zip(prec.stages, jrec.stages):
        np.testing.assert_allclose(
            got, want, rtol=RTOL if name == "TRAIN" else VALID_RTOL,
            err_msg=f"{name} epoch {epoch}")


def evaluate_both(jp, pp, workdir):
    """``evaluate`` of both from the JAX run's best checkpoint; returns
    both ``test_metrics.txt`` as dicts."""
    jm, pm = jp["model"], pp["model"]
    h = jp["hparams"]["model"]
    key = dict(max_key=h.get("max_key"), min_key=h.get("min_key"))
    jck = jm.checkpointer.find_checkpoint(**key)
    assert jck is not None
    pm.checkpointer = Checkpointer(jck.path.parent)
    pm.noise_source = JaxDraws(jm.rng)
    for prep, model in ((jp, jm), (pp, pm)):
        model.evaluate(prep["datasets"][2], **key,
                       test_loader_kwargs=prep["hparams"][
                           "test_dataloader_opts"])

    def metrics(name):
        text = (workdir / f"results/{name}/test_output/test_metrics.txt"
                ).read_text().splitlines()
        return dict(ln.split(": ") for ln in text[1:-1])
    return metrics("jx"), metrics("px")


def check_metrics(want, got):
    assert list(got) == list(want)
    for key in want:
        if "loss" in key:   # rounded to 2 or 3 decimals
            assert abs(float(got[key]) - float(want[key])) <= 0.01, key
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_fit_and_evaluate_match_jax(recipe, workdir):
    epochs, extra = RECIPES[recipe]
    jp, pp, jrec, prec = fit_both(recipe, epochs, extra)
    check_stage_losses(jrec, prec)
    pm = pp["model"]
    # the fine-tuned trunk trained: its Adam state advanced
    assert int(pm.opt_states["wav2vec_opt"]["wav2vec2"]["count"]) > 0
    want, got = evaluate_both(jp, pp, workdir)
    check_metrics(want, got)
    if recipe == "w2v_CRDNN_CTC_cnncl":
        def saved(name):
            with open(workdir / f"results/{name}/saved_phn_recog_outs.pkl",
                      "rb") as f:
                return pickle.load(f)
        j, p = saved("jx"), saved("px")
        assert sorted(j) == sorted(p) == sorted(pp["datasets"][2].ids)
        for k in j:
            assert p[k].shape == j[k].shape and p[k].shape[1] == 14
            np.testing.assert_allclose(p[k], j[k], atol=1e-5, err_msg=k)


def test_crdnn_bf16_fit_matches_jax(workdir):
    """``--bf16``: the H=32 LSTM takes the scan in both packages."""
    jp, pp, jrec, prec = fit_both("w2v_CRDNN_CTC", 1, bf16=True, batches=1)
    assert pp["model"].auto_mix_prec
    (_, _, got), (_, _, want) = prec.stages[0], jrec.stages[0]
    np.testing.assert_allclose(got, want, rtol=AMP_RTOL)   # the first step
    (_, _, got), (_, _, want) = prec.stages[1], jrec.stages[1]
    np.testing.assert_allclose(got, want, rtol=AMP_VALID_RTOL)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_copies_are_byte_equal(recipe):
    assert (REPO / "mlvae_tpu_torch/models" / recipe / "model.yaml"
            ).read_bytes() == \
        (REPO / "mlvae_tpu/models" / recipe / "model.yaml").read_bytes()
