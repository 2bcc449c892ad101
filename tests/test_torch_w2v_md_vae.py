"""The wav2vec2 MD_VAE recipes through the port's ``fit`` and
``evaluate`` against the JAX package's (the harness and tolerances of
``tests/test_torch_w2v_recipes.py``): w2v_MD_VAE and w2v_MD_VAE_sfl
(frozen trunk: the JAX package's feature cache on, as by default, the
port's trunk in the step; in f32 both compute the same features) and
w2v_MD_VAE_sfl_resi (fine-tuned trunk: its dropout replayed), three
epochs each (one PHN_RECOG -> B_DETECTOR -> VAE cycle), every LSTM at
H=32, two π samples for the sfl recipes. Then ``evaluate`` from the JAX
run's best checkpoint: ``test_metrics.txt`` equal.

The frozen trunk runs inside every step in the port (the JAX package's
frozen-trunk feature cache is not ported: it pays off only through the
JAX Brain's device-batch cache, which the port's Brain does not have),
so ``test_frozen_trunk_in_step`` holds w2v_MD_VAE's first epoch, f32 and
``--bf16``, against the JAX package with ``MLVAE_W2V_FROZEN_CACHE=0``:
the losses (f32 as above; ``--bf16`` the first step and VALID after it
rel 1e-3: they lie 6.7e-6 and 4.4e-5 off, the bf16 trunk's outputs a
few bf16 steps from XLA's fused ones),
no trunk draws, and the trunk's parameters after the fit equal to the
JAX run's bit for bit (neither moved)."""
import jax
import numpy as np
import pytest
import torch

from mlvae_tpu_torch.convert import from_jax
from test_torch_w2v_recipes import (BATCH, check_metrics, check_stage_losses,
                                    evaluate_both, fit_both,
                                    workdir)  # noqa: F401

torch.set_num_threads(2)

BF16_RTOL = 1e-3

NARROW = ("phn_rnn_hidden_size: 32, boundary_rnn_hidden_size: 32, "
          "rnn_hidden_size: 32, dec_rnn_hidden_size: 32")
RECIPES = {
    "w2v_MD_VAE": NARROW,
    "w2v_MD_VAE_sfl": NARROW + ", pi_mcmc_num: 2",
    "w2v_MD_VAE_sfl_resi": NARROW + ", pi_mcmc_num: 2",
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_fit_and_evaluate_match_jax(recipe, workdir):
    jp, pp, jrec, prec = fit_both(recipe, 3, RECIPES[recipe])
    assert [s[:2] for s in prec.stages] == [
        (st, e) for e in (1, 2, 3) for st in ("TRAIN", "VALID")]
    check_stage_losses(jrec, prec)
    pm = pp["model"]
    count = int(pm.opt_states["wav2vec_opt"]["wav2vec2"]["count"])
    assert (count > 0) == (recipe == "w2v_MD_VAE_sfl_resi")
    want, got = evaluate_both(jp, pp, workdir)
    check_metrics(want, got)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_frozen_trunk_in_step(workdir, monkeypatch, bf16):
    monkeypatch.setenv("MLVAE_W2V_FROZEN_CACHE", "0")
    jp, pp, jrec, prec = fit_both("w2v_MD_VAE", 1, RECIPES["w2v_MD_VAE"],
                                  bf16=bf16, batches=1)
    pm = pp["model"]
    assert pm.auto_mix_prec == bf16 and pm.wav2vec2.freeze
    assert pm.wav2vec2.draws(BATCH, 50, train=True) == []
    if bf16:
        assert len(prec.stages) == 2
        for (name, _, got), (_, _, want) in zip(prec.stages, jrec.stages):
            np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                       err_msg=name)
    else:
        check_stage_losses(jrec, prec)
    want = from_jax(jax.device_get(jp["model"].params))
    got = pm.state_dict()
    trunk = [k for k in want if k.startswith("wav2vec2.")]
    assert trunk and all(torch.equal(got[k], want[k]) for k in trunk)
