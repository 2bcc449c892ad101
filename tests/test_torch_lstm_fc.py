"""The LSTM_FC slice: the port's ``LSTMFC`` against the JAX ``SBModel`` of
``mlvae_tpu/models/LSTM_FC``, built from its ``model.yaml`` through
``load_hyperyaml`` with the keys the JAX bench injects and narrow widths
(H=128, 2 layers, FC 128-16-16-2), B=4, T=12, weights and normalizer
statistics carried across with ``from_jax``.

Checked: the TEST eval step (logits atol 1e-5, loss rtol 1e-5: f32 sums
in another order); two training steps with the JAX dropout draws replayed
from the same parameters (each step's loss rtol 1e-4, every parameter
after it and the Adam moments relative to their norms 1e-4); the TRAIN
stage reading ``aug_feat`` and the augmented labels, every other stage the
clean ones; the weighted BCE at
logits of +-30 (finite, rtol 1e-6); the frame-level MD scores against the
JAX ``MDMetricStats`` (equal); the draw order against the JAX RngStream."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.hyperyaml import load_hyperyaml
from mlvae_tpu.metrics.md import MDMetricStats as JaxMDMetricStats
from mlvae_tpu.models.LSTM_FC.model import SBModel
from mlvae_tpu.models.LSTM_FC.model import \
    _weighted_bce_with_logits as jax_bce
from mlvae_tpu.nn.core import RngStream
from mlvae_tpu.training.brain import Stage as JaxStage

from mlvae_tpu_torch.bench_utils import (INPUT_SIZE, LSTM_FC_RECIPE,
                                         build_lstm_fc, synth_flvl_batch)
from mlvae_tpu_torch.convert import from_jax, to_jax
from mlvae_tpu_torch.metrics.md import MDMetricStats
from mlvae_tpu_torch.models.LSTM_FC.model import weighted_bce_with_logits
from mlvae_tpu_torch.training.brain import Stage

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
B, T = 4, 12
NARROW = {"lstm_hidden_size": 128, "lstm_num_layers": 2, "fc_size": 16}
PORT_NARROW = {"lstm_hidden_size": 128, "lstm_num_layers": 2,
               "fc_sizes": [128, 16, 16, 2]}
OUT_ATOL, RTOL = 1e-5, 1e-5
STEP_RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_model():
    injected = {"n_epochs": 1, "dataset_name": "SynAudioMNIST",
                "model_name": "bench", "output_dir": "/tmp/mlvae_bench",
                "input_size": INPUT_SIZE, "n_phonemes": 12,
                "batch_size": B, **NARROW}
    with open(REPO / "mlvae_tpu/models/LSTM_FC/model.yaml") as f:
        hparams = load_hyperyaml(f, overrides=injected,
                                 overrides_must_match=False)
    hparams.update({k: v for k, v in injected.items() if k not in hparams})
    model = SBModel(modules=hparams["modules"], hparams=hparams, run_opts={},
                    checkpointer=None)
    model.init_params()
    model.ensure_states(INPUT_SIZE)
    rs = np.random.RandomState(1)
    # statistics with history: LSTM_FC carries them and never applies them
    model.states["normalizer"] = {
        "count": jnp.float32(12.0),
        "glob_mean": jnp.asarray(rs.randn(INPUT_SIZE).astype(np.float32)),
        "glob_std": jnp.asarray((0.5 + rs.rand(INPUT_SIZE)).astype(
            np.float32))}
    model.init_optimizers()
    return model


def _port(jax_model):
    model = build_lstm_fc(B, overrides=PORT_NARROW, device="cpu")
    model.load_state_dict(from_jax(jax.device_get(jax_model.params),
                                   jax.device_get(jax_model.states)),
                          strict=True)
    return model


def _jax_batch(batch):
    return {k: tuple(jnp.asarray(x.numpy()) for x in v)
            for k, v in batch.items()}


def _replay(draws, rng):
    """Draw i from ``fold_in(rng, i)``, as the JAX step's RngStream."""
    noise = {}
    for i, (name, kind, shape, keep, _) in enumerate(draws):
        assert kind == "bernoulli"
        noise.setdefault(name, []).append(torch.from_numpy(np.array(
            jax.random.bernoulli(jax.random.fold_in(rng, i), keep, shape))))
    return noise


def test_recipe_widths_are_the_yaml():
    with open(REPO / "mlvae_tpu/models/LSTM_FC/model.yaml") as f:
        text = f.read()
    for key in ("lstm_hidden_size", "lstm_num_layers", "lstm_dropout",
                "misp_weight", "lr"):
        value = LSTM_FC_RECIPE[key]
        assert f"{key}: {value}" in text, key
    assert LSTM_FC_RECIPE["fc_sizes"] == [1024, 64, 64, 2]


def test_from_jax_carries_the_tree_and_the_normalizer(jax_model):
    port = _port(jax_model)
    sd = port.state_dict()
    params = jax.device_get(jax_model.params)
    assert {k.split(".")[0] for k in sd} == {"normalizer", "lstm", "fc"}
    np.testing.assert_array_equal(sd["lstm.weight_hh_l1"].numpy(),
                                  params["lstm"]["weight_hh_l1"])
    np.testing.assert_array_equal(sd["fc.lin2.weight"].numpy(),
                                  params["fc"]["lin2"]["weight"])
    states = jax.device_get(jax_model.states)["normalizer"]
    for key in ("count", "glob_mean", "glob_std"):
        np.testing.assert_array_equal(sd[f"normalizer.{key}"].numpy(),
                                      states[key])
    back_p, back_s = to_jax(sd)
    assert set(back_p) == {"lstm", "fc"} and set(back_s) == {"normalizer"}


def test_eval_step_matches_jax(jax_model):
    port = _port(jax_model)
    batch = synth_flvl_batch(B, T, seed=2, device="cpu")
    step = jax_model._get_compiled("eval", JaxStage.TEST)
    j_preds, j_loss, _ = step(jax_model.params, jax_model.states,
                              jax.random.PRNGKey(0), _jax_batch(batch),
                              jnp.int32(1))
    preds, loss, losses = port.eval_step(batch)
    assert set(preds) == {"out"} and losses == {}
    assert preds["out"].shape == (B, T, 2)
    np.testing.assert_allclose(preds["out"].numpy(),
                               np.asarray(j_preds["out"]), atol=OUT_ATOL)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)


def test_train_steps_match_jax(jax_model):
    """Two fit_batch steps. Each step starts from the JAX parameters (the
    port's own Adam states carry over and are held against optax's): at
    the recipe's lr 1.0 the first step saturates the LSTM, and the one
    weight whose gradient lies at rounding noise, whose Adam step
    g / (|g| + eps) then differs by 2e-3, moves the second step's LSTM
    gradients by about 1e-3 in norm through the saturated gates."""
    port = _port(jax_model)
    batch = synth_flvl_batch(B, T, seed=3, device="cpu")
    jbatch = _jax_batch(batch)
    step = jax_model._get_compiled("train", JaxStage.TRAIN)
    p, o, s = jax.tree_util.tree_map(
        jnp.array, (jax_model.params, jax_model.opt_states,
                    jax_model.states))
    for i in range(2):
        rng = jax.random.PRNGKey(40 + i)
        if i:
            port.load_state_dict(from_jax(jax.device_get(p),
                                          jax.device_get(s)))
        p, o, s, j_loss, _ = step(p, o, s, rng, jbatch, jnp.int32(1))
        noise = _replay(port.draws(B, T, train=True), rng)
        assert len(noise["lstm_dropout"]) == 1   # one gap, two layers
        loss, losses = port.fit_batch(batch, 1, noise=noise)
        assert losses == {}
        np.testing.assert_allclose(float(loss), float(j_loss),
                                   rtol=STEP_RTOL, err_msg=f"step {i + 1}")
        want = from_jax(jax.device_get(p))
        for name, value in port.state_dict().items():
            if name.startswith("normalizer."):
                continue
            ref = want[name]
            err = float((value - ref).norm() / ref.norm())
            assert err <= STEP_RTOL, (i + 1, name, err)
        j_opt = jax.device_get(o["optimizer"])
        for mk, mod in port.param_modules().items():
            inner = j_opt[mk].inner_state[0]
            st = port.opt_states["optimizer"][mk]
            assert int(st["count"]) == int(inner.count) == i + 1
            for key in ("mu", "nu"):
                sd = from_jax(getattr(inner, key))
                ref = torch.cat([sd[f"{mk}.{n}"].reshape(-1)
                                 for n, _ in mod.named_parameters()])
                err = float((st[key] - ref).norm() / ref.norm())
                assert err <= STEP_RTOL, (i + 1, mk, key, err)
    assert set(port.param_modules()) == {"lstm", "fc"}
    # the normalizer is carried, never updated or applied
    j_norm = jax.device_get(s["normalizer"])
    assert float(port.normalizer.count) == float(j_norm["count"]) == 12.0


def test_train_stage_reads_the_augmented_features(jax_model):
    port = _port(jax_model)
    batch = synth_flvl_batch(B, T, seed=4, device="cpu")
    nan = torch.full_like(batch["feat"][0], float("nan"))
    clean_only = dict(batch, aug_feat=(nan, batch["feat"][1]))
    aug_only = dict(batch, feat=(nan, batch["feat"][1]))
    assert torch.isfinite(port.eval_step(clean_only)[1])
    assert not torch.isfinite(port.eval_step(aug_only)[1])
    loss, _ = port.fit_batch(aug_only, 1, noise={})
    assert torch.isfinite(loss)
    # and the labels of the stage: the augmented ones while training
    port = _port(jax_model)
    flipped = dict(batch, aug_flvl_gt_md_lbl_seq=(
        1 - batch["aug_flvl_gt_md_lbl_seq"][0],
        batch["aug_flvl_gt_md_lbl_seq"][1]))
    port.on_stage_start(Stage.TRAIN, 1)
    with torch.no_grad():
        preds = port.compute_forward(batch, train=True, noise={})
        a, _ = port.compute_objectives(preds, batch)
        b, _ = port.compute_objectives(preds, flipped)
    assert float(a) != float(b)
    port.on_stage_start(Stage.TEST)
    preds = port.compute_forward(batch)
    a, _ = port.compute_objectives(preds, batch)
    b, _ = port.compute_objectives(preds, flipped)
    assert float(a) == float(b)


def test_weighted_bce_matches_jax_at_large_logits():
    logits = np.array([-30.0, -5.0, -0.5, 0.0, 0.5, 5.0, 30.0], np.float32)
    x = np.stack([logits, -logits], -1)[None]          # (1, 7, 2)
    for y in (0.0, 1.0):
        targets = np.stack([np.full(7, 1 - y), np.full(7, y)], -1)[None]
        targets = targets.astype(np.float32)
        pw = np.array([1.0, 10.0], np.float32)
        want = np.asarray(jax_bce(jnp.asarray(x), jnp.asarray(targets),
                                  jnp.asarray(pw)))
        got = weighted_bce_with_logits(torch.from_numpy(x),
                                       torch.from_numpy(targets),
                                       torch.from_numpy(pw)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # at +-30 the wrong class costs about 30 (times the weight), the right
    # one about exp(-30)
    assert got[0, 6, 1] == pytest.approx(10 * 30.0, rel=1e-6)
    assert 0 < got[0, 0, 1] < 1e-12


def test_frame_md_scores_match_jax(jax_model):
    port = _port(jax_model)
    batch = synth_flvl_batch(B, T, seed=5, device="cpu")
    rs = np.random.RandomState(6)
    out = rs.randn(B, T, 2).astype(np.float32)   # both classes predicted
    ids = [f"utt{i}" for i in range(B)]
    port.on_stage_start(Stage.TEST)
    port.evaluate_predictions({"out": torch.from_numpy(out)}, batch, ids)
    jax_model.on_stage_start(JaxStage.TEST)
    jax_model._batch_ids = ids
    host = {k: tuple(x.numpy() for x in v) for k, v in batch.items()}
    jax_model.evaluate_predictions({"out": out}, host, JaxStage.TEST)
    mine = port.stats_loggers["flvl_md_stats"]
    theirs = jax_model.stats_loggers["flvl_md_stats"]
    assert isinstance(theirs, JaxMDMetricStats)
    assert isinstance(mine, MDMetricStats)
    assert mine.scores_list == theirs.scores_list
    assert mine.summarize() == theirs.summarize()
    assert 0 < mine.summarize("PRE") < 100
    # and on the eval step's own logits
    port = _port(jax_model)
    preds, _, _ = port.eval_step(batch)
    port.evaluate_predictions(preds, batch, ids)
    jax_model.on_stage_start(JaxStage.TEST)
    jax_model.evaluate_predictions({"out": preds["out"].numpy()}, host,
                                   JaxStage.TEST)
    assert port.stats_loggers["flvl_md_stats"].summarize() == \
        jax_model.stats_loggers["flvl_md_stats"].summarize()


def test_draws_follow_the_rngstream(jax_model, monkeypatch):
    """The JAX training forward's draws: one bernoulli keep-mask a gap, of
    (T, B, H), from folds 0, 1, ... of the step's stream, as ``draws``
    lists them; the eval forward draws nothing."""
    record = []
    bern = jax.random.bernoulli
    nxt = RngStream.next

    def recording_next(self):
        record.append(("fold", self._count))
        return nxt(self)

    def recording_bernoulli(key, p, shape):
        record.append(("bernoulli", float(p), tuple(shape)))
        return bern(key, p, shape)

    monkeypatch.setattr(RngStream, "next", recording_next)
    monkeypatch.setattr(jax.random, "bernoulli", recording_bernoulli)
    batch = _jax_batch(synth_flvl_batch(B, T, seed=7, device="cpu"))
    jax.eval_shape(lambda pp, ss, rr: jax_model.compute_forward(
        pp, ss, batch, JaxStage.TRAIN, rr, 1), jax_model.params,
        jax_model.states, jax.random.PRNGKey(0))
    port = build_lstm_fc(B, overrides=PORT_NARROW, device="cpu")
    want = []
    for i, (_, kind, shape, keep, _) in enumerate(port.draws(B, T, True)):
        want += [("fold", i), (kind, pytest.approx(keep), shape)]
    assert record == want
    assert port.draws(B, T, train=False) == []
