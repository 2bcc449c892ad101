"""MD_VAE_sfl in the port against the JAX package's:

* ``nn/dist.categorical_entropy`` and ``categorical_ll_onehot``: values
  and logit gradients within rel 1e-6;
* the REINFORCE VAE step at narrow widths (every LSTM at H=32, 2 layers,
  B=4, T=24, L=4) with ``pi_mcmc_num`` = 3, the JAX weights carried
  across and every draw replayed (the per-sample draws as lists): the
  decode inside step 1, each loss and each module's applied grads at
  ``tests/test_torch_train_step.py``'s tolerances (rel 1e-4), the modules
  that moved, and step 2's losses; the draw order against the JAX
  package's RngStream;
* one AMP VAE step (H=128, ``pi_mcmc_num`` = 2) against the JAX AMP step
  at ``tests/test_torch_amp_step.py``'s tolerances;
* ``cli.train`` / ``cli.test`` / ``cli.infer`` at full width with
  ``--device cpu`` for MD_VAE_sfl, and ``cli.train`` for
  MD_VAE_sfl_saved_phn_recog over a synthetic pickle of posteriors;
* a batch without ``feat`` (``kaldi_feat`` only) steps as one with it."""
import importlib
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.lstm_pallas as lp
from mlvae_tpu.bench_utils import INPUT_SIZE
from mlvae_tpu.bench_utils import synth_batch as jax_synth_batch
from mlvae_tpu.hyperyaml import load_hyperyaml as jax_load_hyperyaml
from mlvae_tpu.nn import dist as JD
from mlvae_tpu.nn.core import RngStream
from mlvae_tpu.training.brain import Stage as JaxStage

import mlvae_tpu_torch.ops.lstm as pl
from mlvae_tpu_torch.bench_utils import build_md_vae, synth_batch
from mlvae_tpu_torch.cli import infer as infer_cli
from mlvae_tpu_torch.cli import test as test_cli
from mlvae_tpu_torch.cli import train as train_cli
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.models.MD_VAE.model import Target
from mlvae_tpu_torch.models.MD_VAE_sfl_saved_phn_recog.model import \
    load_saved_outputs
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.training.brain import Stage

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
B, T, L = 4, 24, 4
SMALL = {"phn_rnn_hidden_size": 32, "boundary_rnn_hidden_size": 32,
         "rnn_hidden_size": 32, "dec_rnn_hidden_size": 32}
N_SAMPLES = 3
RTOL = 1e-4
DECODED = ("decoded_boundary_seq", "decoded_flvl_md_lbl_seq",
           "decoded_plvl_md_lbl_seq", "decoded_t_lens", "decoded_l_lens")
VAE_ACTIVE = {"feat_fc", "phn_recog_out_fc", "concat_fc", "rnn", "pi_fc",
              "encoder", "decoder", "baseline_fc"}
SFL_LOSSES = ("pi_nll_loss", "vae_kld_loss", "recon_loss", "rif_loss",
              "entropy_loss", "baseline_loss")


def jax_recipe_model(recipe, batch_size, overrides):
    """A JAX recipe's SBModel from its YAML, as the JAX package's
    ``bench_utils.build_md_vae`` builds MD_VAE's (the keys ``run.yaml``
    injects, and ``overrides``)."""
    cls = importlib.import_module(f"mlvae_tpu.models.{recipe}.model").SBModel
    injected = {"n_epochs": 3, "dataset_name": "SynAudioMNIST",
                "model_name": "bench", "output_dir": "/nonexistent/x",
                "input_size": INPUT_SIZE, "n_phonemes": 12,
                "batch_size": batch_size, "kld_n_samples": 2249}
    injected.update(overrides)
    with open(REPO / f"mlvae_tpu/models/{recipe}/model.yaml") as f:
        hparams = jax_load_hyperyaml(f, overrides=injected,
                                     overrides_must_match=False)
    hparams.update({k: v for k, v in injected.items() if k not in hparams})
    return cls(modules=hparams["modules"], hparams=hparams, run_opts={},
               checkpointer=None)


def replay(draws, rng):
    """The port's named draws made as the JAX step makes them: draw i from
    ``fold_in(rng, i)`` in the draw's dtype; a dropout mask, or a name
    that repeats (one a π sample), goes into a list."""
    names = [d[0] for d in draws]
    noise = {}
    for i, (name, kind, shape, keep, dtype) in enumerate(draws):
        k = jax.random.fold_in(rng, i)
        if kind == "bernoulli":
            v = torch.from_numpy(np.array(jax.random.bernoulli(k, keep,
                                                               shape)))
        else:
            fn = {"uniform": jax.random.uniform,
                  "normal": jax.random.normal,
                  "gumbel": jax.random.gumbel}[kind]
            jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
            v = torch.from_numpy(np.array(
                fn(k, shape, jd).astype(jnp.float32))).to(dtype)
        if kind == "bernoulli" or names.count(name) > 1:
            noise.setdefault(name, []).append(v)
        else:
            noise[name] = v
    return noise


def _jax_model(overrides, bf16=False):
    model = jax_recipe_model("MD_VAE_sfl", B, overrides)
    if bf16:
        model.run_opts["bf16"] = True
        model.auto_mix_prec = True
    model.init_params()
    model.ensure_states(INPUT_SIZE)
    model.init_optimizers()
    return model


def _jax_batch():
    batch = jax_synth_batch(B, T, L, seed=0)
    batch["kaldi_feat"] = batch["feat"]
    return batch


def _port_batch():
    batch = synth_batch(B, T, L, seed=0, device="cpu")
    batch["kaldi_feat"] = batch["feat"]
    return batch


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def _grads_from_mu(j_opt, mk, mod):
    """The applied grads of a module: optax's first mu is (1 - b1) * g."""
    inner = j_opt[mk].inner_state[0]
    leaves = []
    for name, _ in mod.named_parameters():
        leaf = inner.mu[mk]
        for part in name.split("."):
            leaf = leaf[part]
        leaves.append(np.asarray(leaf).reshape(-1))
    return np.concatenate(leaves) / np.float32(0.1)


@pytest.mark.parametrize("fn", ["categorical_entropy",
                                "categorical_ll_onehot"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_categorical_functions_match_jax(fn, dtype):
    rs = np.random.RandomState(3)
    logits = (rs.randn(5, 7, 2) * 3).astype(np.float32)
    onehot = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (5, 7))]
    w = rs.randn(5, 7).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    logits = np.array(jnp.asarray(logits).astype(jdt).astype(jnp.float32))
    args_j = (jnp.asarray(onehot).astype(jdt),) if fn.endswith("onehot") \
        else ()
    args_t = (torch.from_numpy(onehot).to(tdt),) if fn.endswith("onehot") \
        else ()

    def jax_total(x):
        return jnp.sum(getattr(JD, fn)(x.astype(jdt), *args_j) * w)
    want, want_g = jax.value_and_grad(jax_total)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got_v = getattr(D, fn)(x.to(tdt), *args_t)
    assert got_v.dtype == torch.float32
    np.testing.assert_allclose(
        got_v.detach().numpy(),
        np.asarray(getattr(JD, fn)(jnp.asarray(logits).astype(jdt),
                                   *args_j)), rtol=1e-6, atol=1e-7)
    (got_v * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("train", [True, False])
def test_sfl_draw_order_matches_rngstream(train, monkeypatch):
    """The JAX VAE forward traced abstractly, recording which fold of the
    RngStream each jax.random draw consumes and its shape, against the
    port's ``draws`` (train: ``pi_mcmc_num`` samples; else one)."""
    overrides = dict(SMALL, pi_mcmc_num=N_SAMPLES)
    jm = _jax_model(overrides)
    keys, record = [], []
    next_ = RngStream.next

    def recording_next(self):
        k = next_(self)
        keys.append((k, self._count - 1))
        return k

    def recorder(kind, fn, shape_of):
        def draw(key, *args, **kwargs):
            fold = next(i for k, i in keys if k is key)
            record.append((fold, kind, tuple(shape_of(*args, **kwargs))))
            return fn(key, *args, **kwargs)
        return draw

    monkeypatch.setattr(RngStream, "next", recording_next)
    for kind, name, shape_of in (
            ("uniform", "uniform", lambda shape, *a, **k: shape),
            ("normal", "normal", lambda shape, *a, **k: shape),
            ("gumbel", "gumbel", lambda shape, *a, **k: shape),
            ("bernoulli", "bernoulli", lambda p, shape, *a, **k: shape),
            ("gumbel", "categorical", lambda logits, *a, **k: logits.shape)):
        monkeypatch.setattr(jax.random, name,
                            recorder(kind, getattr(jax.random, name),
                                     shape_of))
    stage = JaxStage.TRAIN if train else JaxStage.VALID
    jm.on_stage_start(stage, 3)
    jax.eval_shape(lambda pp, ss, bb, rr: jm.compute_forward(
        pp, ss, bb, stage, rr, 3)[0], jm.params, jm.states, _jax_batch(),
        jax.random.PRNGKey(0))

    port = build_md_vae(batch_size=B, overrides=overrides, device="cpu",
                        recipe="MD_VAE_sfl")
    port.on_stage_start(Stage.TRAIN if train else Stage.VALID, 3)
    draws = port.draws(B, T, train=train)
    assert record == [(i, kind, tuple(shape))
                      for i, (_, kind, shape, _, _) in enumerate(draws)]
    names = [d[0] for d in draws]
    assert names.count("pi_gumbel") == (N_SAMPLES if train else 0)
    assert names.count("gmm_eps") == (N_SAMPLES if train else 1)


def test_sfl_vae_step_matches_jax():
    overrides = dict(SMALL, pi_mcmc_num=N_SAMPLES)
    jm = _jax_model(overrides)
    jm.on_stage_start(JaxStage.TRAIN, 3)
    step = jm._get_compiled("train", JaxStage.TRAIN)
    jbatch = _jax_batch()
    rngs = [jax.random.PRNGKey(300 + i) for i in range(2)]
    params0 = jax.device_get(jm.params)
    p, o, s = _copy(jm.params), _copy(jm.opt_states), _copy(jm.states)

    port = build_md_vae(batch_size=B, overrides=overrides, device="cpu",
                        recipe="MD_VAE_sfl")
    # the JAX module names, baseline_fc and phn_recog_out_fc among them
    port.load_state_dict(from_jax(params0, jax.device_get(jm.states)))
    port.on_stage_start(Stage.TRAIN, 3)
    assert port.target == Target.VAE
    batch = _port_batch()
    mods = port.param_modules()
    norm0 = {k: v.clone() for k, v in port.normalizer.state_dict().items()}

    fwd = jax.jit(lambda pp, ss, bb, rr: jm.compute_forward(
        pp, ss, bb, JaxStage.TRAIN, rr, 3)[0])
    j_preds = fwd(p, s, jbatch, rngs[0])
    preds = port.compute_forward(
        port.prepare_batch(batch), noise=replay(port.draws(B, T, True),
                                                rngs[0]),
        train=True, epoch=3)
    for key in DECODED:
        np.testing.assert_array_equal(preds[key].numpy(),
                                      np.asarray(j_preds[key]), err_msg=key)

    for i, rng in enumerate(rngs):
        p, o, s, j_loss, j_losses = step(p, o, s, rng, jbatch, jnp.int32(3))
        loss, losses = port.fit_batch(
            batch, 3, noise=replay(port.draws(B, T, train=True), rng))
        assert set(losses) == set(j_losses) and set(SFL_LOSSES) <= \
            set(losses)
        for key in j_losses:
            np.testing.assert_allclose(float(losses[key]),
                                       float(j_losses[key]), rtol=RTOL,
                                       err_msg=f"step {i + 1} {key}")
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
        j_opt = jax.device_get(o["optimizer"])
        counts = {mk: int(st["count"])
                  for mk, st in port.opt_states["optimizer"].items()}
        assert counts == {mk: int(j_opt[mk].inner_state[0].count)
                          for mk in j_opt}
        assert {mk for mk, c in counts.items() if c} == VAE_ACTIVE
        if i == 0:
            for mk, mod in mods.items():
                g_j = _grads_from_mu(j_opt, mk, mod)
                if mk not in VAE_ACTIVE:
                    assert not g_j.any(), mk
                    assert all(q.grad is None or not q.grad.any()
                               for q in mod.parameters()), mk
                    continue
                g = torch.cat([q.grad.reshape(-1)
                               for q in mod.parameters()]).numpy()
                np.testing.assert_allclose(
                    g, g_j, rtol=RTOL, atol=RTOL * np.abs(g_j).max(),
                    err_msg=mk)
        # the Kaldi features go in unnormalized; no statistic moves
        for k, v in port.normalizer.state_dict().items():
            assert torch.equal(v, norm0[k]), k
        assert float(jax.device_get(s["normalizer"])["count"]) == \
            float(norm0["count"])


def test_sfl_eval_forward_matches_jax():
    """The TEST target's forward (one π, the argmax) with its draws
    replayed: every loss and the decode."""
    overrides = dict(SMALL, pi_mcmc_num=N_SAMPLES)
    jm = _jax_model(overrides)
    jm.on_stage_start(JaxStage.TEST)
    rng = jax.random.PRNGKey(7)
    j_preds, _ = jm.compute_forward(jm.params, jm.states, _jax_batch(),
                                    JaxStage.TEST, rng, 1)
    j_loss, j_losses = jm.compute_objectives(j_preds, _jax_batch(),
                                             JaxStage.TEST)
    port = build_md_vae(batch_size=B, overrides=overrides, device="cpu",
                        recipe="MD_VAE_sfl")
    port.load_state_dict(from_jax(jax.device_get(jm.params),
                                  jax.device_get(jm.states)))
    port.on_stage_start(Stage.TEST)
    batch = _port_batch()
    preds = port.compute_forward(
        port.prepare_batch(batch), noise=replay(port.draws(B, T, False), rng))
    loss, losses = port.compute_objectives(preds, batch)
    for key in DECODED:
        np.testing.assert_array_equal(preds[key].numpy(),
                                      np.asarray(j_preds[key]), err_msg=key)
    assert set(losses) == set(j_losses)
    for key in j_losses:
        np.testing.assert_allclose(float(losses[key]), float(j_losses[key]),
                                   rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX LSTM's Pallas dispatch forced on, its fused kernels in
    interpret mode (``tests/test_torch_amp_step.py``'s ``patched``), both
    packages' budgets lowered alike so that the decoder's In=2H layers
    take the semi-fused tier, as at H=512."""
    real = {"fused": lp.lstm_layer_fused, "semi": lp.lstm_layer_semifused}
    calls = []

    def spy(name):
        def f(x, w_ih, bias, w_hh, reverse=False, interpret=False):
            calls.append(name)
            return real[name](x, w_ih, bias, w_hh, reverse, True)
        return f

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer_fused", spy("fused"))
    monkeypatch.setattr(lp, "lstm_layer_semifused", spy("semi"))
    monkeypatch.setattr(lp, "FUSED_RESIDENT_BUDGET", 1_000_000)
    monkeypatch.setattr(pl, "FUSED_RESIDENT_BUDGET", 1_000_000)
    return calls


def test_sfl_amp_vae_step_matches_jax(jax_fused):
    """One AMP VAE step: losses within 1e-2, each module's applied grads
    within 5e-2 in norm (``tests/test_torch_amp_step.py``'s reasons), the
    same tiers as the JAX step traced, f32 master state."""
    H = 128
    overrides = {"phn_rnn_hidden_size": H, "boundary_rnn_hidden_size": H,
                 "rnn_hidden_size": H, "dec_rnn_hidden_size": H,
                 "pi_mcmc_num": 2}
    jm = _jax_model(overrides, bf16=True)
    jm.on_stage_start(JaxStage.TRAIN, 3)
    step = jm._get_compiled("train", JaxStage.TRAIN)
    rng = jax.random.PRNGKey(400)
    params0 = jax.device_get(jm.params)
    _, o, _, j_loss, j_losses = step(_copy(jm.params), _copy(jm.opt_states),
                                     _copy(jm.states), rng, _jax_batch(),
                                     jnp.int32(3))
    # the rnn's 2 layers and the decoder's 4 twice take K3, but the
    # decoder's In=2H pair twice takes K4; the detector's and the
    # recognizer's 4 layers K3
    assert jax_fused.count("fused") == 2 + 2 + 2 + 2 * 2
    assert jax_fused.count("semi") == 2 * 2

    port = build_md_vae(batch_size=B, overrides=overrides, device="cpu",
                        bf16=True, recipe="MD_VAE_sfl")
    port.load_state_dict(from_jax(params0, jax.device_get(jm.states)))
    port.on_stage_start(Stage.TRAIN, 3)
    noise = replay(port.draws(B, T, True), rng)
    assert all(g.dtype == torch.bfloat16 for g in noise["pi_gumbel"])
    loss, losses = port.fit_batch(
        _port_batch(), 3,
        noise=noise)
    assert set(losses) == set(j_losses)
    for key in j_losses:
        assert losses[key].dtype == torch.float32
        np.testing.assert_allclose(float(losses[key]), float(j_losses[key]),
                                   rtol=1e-2, err_msg=key)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-2)
    assert all(q.dtype == torch.float32 for q in port.parameters())
    j_opt = jax.device_get(o["optimizer"])
    for mk, mod in port.param_modules().items():
        g_j = _grads_from_mu(j_opt, mk, mod)
        if mk not in VAE_ACTIVE:
            assert not g_j.any(), mk
            continue
        g = torch.cat([q.grad.reshape(-1) for q in mod.parameters()])
        err = np.linalg.norm(g.numpy() - g_j) / np.linalg.norm(g_j)
        assert err < 5e-2, (mk, err)


def test_batch_without_feat_steps_as_with_it():
    """A batch of ``kaldi_feat`` alone (the JAX Brain's fallback): the
    draws' shapes come from it and the step's losses are the same."""
    port = build_md_vae(batch_size=B, overrides=dict(SMALL, pi_mcmc_num=2),
                        device="cpu", recipe="MD_VAE_sfl")
    state = {k: v.clone() for k, v in port.state_dict().items()}
    port.on_stage_start(Stage.TRAIN, 3)
    full = _port_batch()
    lone = {k: v for k, v in full.items() if k != "feat"}
    seen = []

    def source(draws):
        seen.append(draws)
        return replay(draws, jax.random.PRNGKey(9))
    port.noise_source = source
    noise = port._next_noise(lone, True)
    assert seen[0] == port.draws(B, T, True)
    got = port.fit_batch(lone, 3, noise=noise)
    port.load_state_dict(state)
    want = port.fit_batch(full, 3, noise=noise)
    assert {k: float(v) for k, v in got[1].items()} == \
        {k: float(v) for k, v in want[1].items()}


def _cli_args(recipe, name, epochs, extra=""):
    # the loss weights MD_VAE's recipe leaves to the default 1.0, pinned;
    # the sfl recipes set every one
    weights = "" if "sfl" in recipe else ", recon_weight: 1.0, " \
        "phn_recog_bce_weight: 1.0, boundary_bce_weight: 1.0"
    return [str(REPO / "config/run.yaml"), "--batch_size", "8",
            "--dataset", "SynAudioMNIST", "--language", "digits",
            "--n_phonemes", "12", "--model_class", recipe,
            "--model_name", name, "--model",
            f"!include:{REPO / 'mlvae_tpu_torch/models' / recipe}/model.yaml",
            "--extra_overrides",
            "{model: {n_epochs: %d%s%s}}" % (epochs, weights, extra),
            "--debug", "--debug_batches", "2", "--device", "cpu"]


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_sfl_cli_train_test_infer_round_trip(workdir):
    """Full width on the CPU: three debug epochs (PHN_RECOG, B_DETECTOR,
    VAE with its five π samples), a checkpoint selected on
    ``plvl_md.soft_F1``, the TEST pass and its saved MD results, and a
    served utterance."""
    args = _cli_args("MD_VAE_sfl", "sfl_smoke", 3)
    model = train_cli.main(args)
    assert model.target == Target.VAE
    assert model.rnn.hidden_size == 512 and model.device.type == "cpu"
    assert int(model.hparams["pi_mcmc_num"]) == 5
    assert [e["batches"] for e in model.epoch_log] == [2, 2, 2]
    assert all(np.isfinite(e["loss"]) for e in model.epoch_log)
    assert "kaldi_feat" in model.used_batch_keys()
    out_dir = workdir / "results/sfl_smoke"
    log = (out_dir / "train_log.txt").read_text()
    for key in ("rif_loss", "entropy_loss", "baseline_loss",
                "plvl_md.soft_F1"):
        assert key in log, key
    ckpts = list((out_dir / "checkpoints").iterdir())
    meta = json.loads((ckpts[0] / "meta.json").read_text())
    assert "plvl_md.soft_F1" in meta and meta["epoch"] == 3

    model = test_cli.main(args)
    text = (out_dir / "test_output/test_metrics.txt").read_text()
    assert "Epoch: 3" in text and "plvl_md.soft_F1" in text
    saved = json.loads((workdir / "datasets/SynAudioMNIST/saved_md_results/"
                        "sfl_smoke.json").read_text())
    assert len(saved) > 0

    wav = sorted((workdir / "datasets/SynAudioMNIST/original_dataset"
                  ).rglob("*.wav"))[0]
    results = infer_cli.main(args + ["--wav", str(wav), "--canonical",
                                     "one , two three"])
    assert [r["phoneme"] for r in results] == ["one", "two", "three"]
    assert all(isinstance(r["mispronounced"], bool) for r in results)


def test_saved_phn_recog_cli_train(workdir):
    """Full width on the CPU from a synthetic pickle of posteriors (as
    ``tests/test_md_vae_variants.py`` writes one): the two-way cycle, no
    recognizer module, and a KeyError for an utterance without
    posteriors."""
    from mlvae_tpu_torch.cli.experiment import prepare_experiment
    prepared = prepare_experiment(_cli_args("MD_VAE", "prep", 1),
                                  prepare_exp_dir=False)
    rs = np.random.RandomState(0)
    outs = {u: rs.randn(len(ds.data[u]["feat"]) - 3, 14).astype(np.float32)
            for ds in prepared["datasets"] for u in ds.ids}
    (workdir / "results").mkdir(exist_ok=True)
    with open(workdir / "results/saved_phn_recog_outs.pkl", "wb") as f:
        pickle.dump(outs, f)
    model = train_cli.main(_cli_args("MD_VAE_sfl_saved_phn_recog",
                                     "saved_smoke", 2))
    assert [model.epoch_log[i]["batches"] for i in (0, 1)] == [2, 2]
    assert model.target == Target.VAE
    assert "phoneme_recognizer" not in dict(model.named_children())
    assert "saved_phn_recog_out" in model.used_batch_keys()
    log = (workdir / "results/saved_smoke/train_log.txt").read_text()
    assert "rif_loss" in log and "phn_recog_bce_loss" not in log

    batch = next(iter(model.make_dataloader(prepared["datasets"][2],
                                            Stage.TEST, batch_size=2)))
    got = model.prepare_batch(batch)["saved_phn_recog_out"][0]
    T_b = batch["feat"][0].shape[1]
    assert got.shape == (2, T_b, 14)
    n = len(outs[batch["id"][0]])
    np.testing.assert_array_equal(got[0, :n], outs[batch["id"][0]])
    assert not got[0, n:].any()
    model.saved_phn_recog_outs.pop(batch["id"][1])
    with pytest.raises(KeyError, match="no saved recognizer outputs"):
        model.prepare_batch(batch)


def test_saved_outputs_load_from_torch_save(tmp_path):
    """The ``.pt`` fallback: a ``torch.save`` file of tensors."""
    rs = np.random.RandomState(1)
    data = {"a": rs.randn(5, 14).astype(np.float32),
            "b": rs.randn(3, 14).astype(np.float64)}
    torch.save({k: torch.from_numpy(v) for k, v in data.items()},
               tmp_path / "outs.pt")
    got = load_saved_outputs(tmp_path / "outs.pt")
    assert set(got) == set(data)
    for k, v in data.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v.astype(np.float32))
