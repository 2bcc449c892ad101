"""HMM_DNN_ALI and its modules against the JAX package, on the CPU:

* (a) ``ops.losses.nll_loss`` against the JAX ``nll_loss``: every
  reduction, with and without lengths, the truncation of a time mismatch
  within ``allowed_len_diff`` and the ``ValueError`` beyond it, rel 1e-6;
* (b) ``HMMAligner.forward_score`` (B=4, T=20, L=5) with
  ``states_per_phoneme`` 1 and 3, each batch reduction and length norm:
  the value rel 1e-5 and the gradient through it rel 1e-5 in norm
  (``jax.grad`` against autograd);
* (c) ``viterbi``'s alignments and scores, ``get_prev_alignments``
  (stored and uniform) and ``calc_accuracy``, equal;
* (d) the recipe built from its ``model.yaml`` at a narrow width
  (``dnn_neurons`` 32), the JAX weights carried across by ``from_jax``,
  in each of its three training types: the eval forward (log-posteriors
  atol 1e-5, loss rel 1e-4) and three ``fit_batch`` steps (loss rel
  1e-4, each module's applied gradient rel 1e-3 in norm, every parameter
  rel 1e-4 in norm but the output bias: the time-mean subtraction cancels
  it, so its gradient is zero but for f32 noise, and Adam moves each of
  its entries by a step of up to lr whose sign is the noise's; it is held
  to a gradient below 1e-6 and entries within 2 lr a step); under
  ``viterbi`` the step's targets from the store and its realignment (the
  stored alignments equal the JAX run's);
* (e) ``fit`` and ``evaluate`` through the CLI's ``prepare_experiment``
  against the JAX package's, with ``forward`` and with ``viterbi``
  (realignment on), two epochs: each stage's loss rel 1e-4, the stored
  alignments and ``accuracy.average`` equal;
* (f) the keyless-checkpoint repair: ``cli.test`` of HMM_DNN_ALI outside
  ``--debug`` evaluates the newest checkpoint (its YAML selects on
  ``flvl_md.F1``, which it never emits), while the guard still refuses
  such a selection for a recipe without ``ALLOW_KEYLESS_CKPT``;
* (g) the recipe copy byte-equal to the JAX package's.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.cli.experiment import prepare_experiment as jax_prepare
from mlvae_tpu.data import data_io as jdio
from mlvae_tpu.hyperyaml import load_hyperyaml as jax_load_hyperyaml
from mlvae_tpu.metrics.metric_stats import MetricStats as JaxMetricStats
from mlvae_tpu.models.HMM_DNN_ALI.model import SBModel as JaxHMM
from mlvae_tpu.modules.hmm_aligner import HMMAligner as JaxAligner
from mlvae_tpu.ops.losses import nll_loss as jax_nll_loss
from mlvae_tpu.training.brain import Stage as JaxStage

from mlvae_tpu_torch.bench_utils import INPUT_SIZE
from mlvae_tpu_torch.cli import test as test_cli
from mlvae_tpu_torch.cli import train as train_cli
from mlvae_tpu_torch.cli.experiment import prepare_experiment
from mlvae_tpu_torch.convert import from_jax, read_npz_tree
from mlvae_tpu_torch.hyperyaml import load_hyperyaml
from mlvae_tpu_torch.models.HMM_DNN_ALI.model import SBModel
from mlvae_tpu_torch.modules.hmm_aligner import HMMAligner
from mlvae_tpu_torch.ops.losses import nll_loss
from mlvae_tpu_torch.training.brain import Stage
from test_torch_harness import (JaxDraws, StageLosses, init_params_seeded,
                                jax_step_grads, norm_err)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "mlvae_tpu_torch/models/HMM_DNN_ALI/model.yaml"
B, T, L = 4, 20, 5
N_CLS = 14
HOP = 320
OUT_ATOL, RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-3
SCORE_RTOL = 1e-5
NLL_RTOL = 1e-6
STEPS = 3
LR = 0.0003   # the recipe's Adam lr
TYPES = ("forward", "ctc", "viterbi")


def make_batch(seed, T=T):
    """A numpy-seeded batch of what HMM_DNN_ALI reads: features, the
    canonical phonemes and their end samples (one phoneme every few
    frames), as (tensor, relative lengths), and the utterance ids."""
    rs = np.random.RandomState(seed)
    t_lens = np.array([T, T - 2, T - 5, T - 7])
    l_lens = np.array([L, L - 1, L - 2, 3])
    feats = rs.randn(B, T, INPUT_SIZE).astype(np.float32)
    phns = np.zeros((B, L), np.int64)
    ends = np.zeros((B, L), np.int64)
    for b in range(B):
        phns[b, :l_lens[b]] = rs.randint(0, N_CLS, l_lens[b])
        cuts = np.sort(rs.choice(np.arange(1, t_lens[b]), l_lens[b] - 1,
                                 replace=False))
        ends[b, :l_lens[b]] = np.append(cuts, t_lens[b]) * HOP + \
            rs.randint(0, HOP, l_lens[b])
    t_rel = (t_lens / T).astype(np.float32)
    l_rel = (l_lens / L).astype(np.float32)

    def pair(a, rel):
        return (torch.from_numpy(a), torch.from_numpy(rel))
    return {"id": [f"utt{b}" for b in range(B)],
            "feat": pair(feats, t_rel), "gt_cnncl_seq": pair(phns, l_rel),
            "gt_phn_end_seq": pair(ends, l_rel)}


def jax_batch(batch):
    return {k: tuple(jnp.asarray(x.numpy()) for x in v)
            for k, v in batch.items() if k != "id"}


def host_batch(batch):
    return {k: (v if k == "id" else tuple(x.numpy() for x in v))
            for k, v in batch.items()}


def log_posteriors(seed, K=3 * N_CLS, T=T):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, K).astype(np.float32) * 2
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


# ---------------------------------------------------------------------------
# (a) nll_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Tt", [T, T - 2, T + 3])
@pytest.mark.parametrize("lengths, reduction", [
    (False, "mean"), (False, "batch"), (True, "mean"), (True, "batchmean"),
    (True, "batch")])
def test_nll_loss_matches_jax(Tt, lengths, reduction):
    lp = log_posteriors(0, K=N_CLS)
    tg = np.random.RandomState(1).randint(0, N_CLS, (B, Tt))
    rel = np.array([1.0, 0.9, 0.75, 0.6], np.float32) if lengths else None
    got = nll_loss(torch.from_numpy(lp), torch.from_numpy(tg),
                   None if rel is None else torch.from_numpy(rel),
                   reduction=reduction)
    want = jax_nll_loss(jnp.asarray(lp), jnp.asarray(tg),
                        None if rel is None else jnp.asarray(rel),
                        reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=NLL_RTOL)


@pytest.mark.parametrize("Tt", [T - 4, T + 4])
def test_nll_loss_refuses_a_larger_mismatch(Tt):
    lp = log_posteriors(0, K=N_CLS)
    tg = np.zeros((B, Tt), np.int64)
    with pytest.raises(ValueError, match="allowed_len_diff"):
        nll_loss(torch.from_numpy(lp), torch.from_numpy(tg))
    with pytest.raises(ValueError, match="allowed_len_diff"):
        jax_nll_loss(jnp.asarray(lp), jnp.asarray(tg))
    # a wider allowance takes it
    nll_loss(torch.from_numpy(lp), torch.from_numpy(tg), allowed_len_diff=4)


# ---------------------------------------------------------------------------
# (b) the forward score
# ---------------------------------------------------------------------------

def _aligners(**kw):
    return HMMAligner(**kw), JaxAligner(**kw)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("reduction, input_norm, target_norm", [
    ("mean", True, False), ("sum", False, True), (None, True, True)])
def test_forward_score_and_grad_match_jax(S, reduction, input_norm,
                                          target_norm):
    pa, ja = _aligners(states_per_phoneme=S, batch_reduction=reduction,
                       input_len_norm=input_norm,
                       target_len_norm=target_norm)
    batch = make_batch(3)
    phns, phn_rel = batch["gt_cnncl_seq"]
    lens = batch["feat"][1]
    lp = log_posteriors(4, K=S * N_CLS)
    p_states = pa.expand_phns_by_states_per_phoneme(phns)
    j_states = ja.expand_phns_by_states_per_phoneme(jnp.asarray(
        phns.numpy()), None)
    np.testing.assert_array_equal(p_states.numpy(), np.asarray(j_states))
    np.testing.assert_array_equal(
        pa.expand_phns_by_states_per_phoneme(phns.numpy()),
        np.asarray(j_states))
    weights = np.random.RandomState(5).rand(B).astype(np.float32)

    def j_score(x):
        return ja.forward_score(x, jnp.asarray(lens.numpy()), j_states,
                                jnp.asarray(phn_rel.numpy()))

    def j_fn(x):   # a scalar of the scores, for the gradient
        out = j_score(x)
        return jnp.sum(out * weights) if reduction is None else out
    x = torch.from_numpy(lp).requires_grad_(True)
    got = pa.forward_score(x, lens, p_states, phn_rel)
    want = j_score(jnp.asarray(lp))
    assert got.shape == want.shape == ((B,) if reduction is None else ())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=SCORE_RTOL)
    (got * torch.from_numpy(weights) if reduction is None
     else got).sum().backward()
    j_grad = torch.from_numpy(np.asarray(jax.grad(j_fn)(jnp.asarray(lp))))
    assert norm_err(x.grad, j_grad) <= SCORE_RTOL
    assert float(x.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# (c) viterbi, the alignment store and the accuracy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 3])
def test_viterbi_store_and_accuracy_match_jax(S):
    pa, ja = _aligners(states_per_phoneme=S, batch_reduction=None)
    batch = host_batch(make_batch(6))
    phns, phn_rel = batch["gt_cnncl_seq"]
    lens = batch["feat"][1]
    lp = log_posteriors(7, K=S * N_CLS)
    states = pa.expand_phns_by_states_per_phoneme(phns)
    # before anything is stored: the uniform split
    fake = np.zeros((B, T, 1), np.float32)
    np.testing.assert_array_equal(
        pa.get_prev_alignments(batch["id"], fake, lens, states, phn_rel),
        ja.get_prev_alignments(batch["id"], fake, lens, states, phn_rel))
    got_scores, got = pa.viterbi(torch.from_numpy(lp), torch.from_numpy(
        lens), torch.from_numpy(states), torch.from_numpy(phn_rel))
    want_scores, want = ja.viterbi(lp, lens, states, phn_rel)
    np.testing.assert_array_equal(got_scores, want_scores)
    assert len(got) == len(want) == B
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # a path visits every state of its utterance, in order
    for b, ali in enumerate(got):
        n = int(round(float(phn_rel[b]) * L)) * S
        np.testing.assert_array_equal(np.unique(ali, return_index=True)[0],
                                      np.unique(states[b, :n]))
    pa.store_alignments(batch["id"][:2], got[:2])
    ja.store_alignments(batch["id"][:2], want[:2])
    np.testing.assert_array_equal(
        pa.get_prev_alignments(batch["id"], fake, lens, states, phn_rel),
        ja.get_prev_alignments(batch["id"], fake, lens, states, phn_rel))
    ends = [e[:int(round(float(r) * L))] for e, r in
            zip(batch["gt_phn_end_seq"][0], batch["gt_phn_end_seq"][1])]
    ph = [p[:int(round(float(r) * L))] for p, r in zip(phns, phn_rel)]
    assert pa.calc_accuracy(got, ends, ph) == ja.calc_accuracy(want, ends,
                                                               ph)
    with pytest.raises(ValueError, match="unknown mode"):
        pa(torch.from_numpy(lp), lens, states, phn_rel, "nope")


# ---------------------------------------------------------------------------
# (d) the recipe's three training types, step by step
# ---------------------------------------------------------------------------

INJECTED = {"n_epochs": 1, "dataset_name": "SynAudioMNIST",
            "model_name": "bench", "output_dir": "/tmp/mlvae_bench",
            "input_size": INPUT_SIZE, "n_phonemes": N_CLS - 2,
            "batch_size": B, "dnn_neurons": 32}


def _models(training_type):
    injected = dict(INJECTED, init_training_type=training_type)
    with open(REPO / "mlvae_tpu/models/HMM_DNN_ALI/model.yaml") as f:
        hp = jax_load_hyperyaml(f, overrides=injected,
                                overrides_must_match=False)
    hp.update({k: v for k, v in injected.items() if k not in hp})
    jm = JaxHMM(modules=hp["modules"], hparams=hp, run_opts={},
                checkpointer=None)
    init_params_seeded(jm)
    jm.ensure_states(INPUT_SIZE)
    jm.init_optimizers()
    jm.training_type = training_type
    with open(RECIPE) as f:
        php = load_hyperyaml(f, overrides=injected,
                             overrides_must_match=False, device="cpu")
    php.update({k: v for k, v in injected.items() if k not in php})
    pm = SBModel(modules=php["modules"], hparams=php, device="cpu")
    pm.load_state_dict(from_jax(jax.device_get(jm.params),
                                jax.device_get(jm.states)), strict=True)
    pm.init_optimizers()
    return jm, pm


def _jax_prev(jm, batch):
    """The JAX recipe's ``prepare_batch`` on a dict batch: the stored
    alignments (or the uniform split) as ``prev_alignments``."""
    aligner = jm.hparams["aligner"]
    phns, phn_rel = (x.numpy() for x in batch["gt_cnncl_seq"])
    states = np.asarray(aligner.expand_phns_by_states_per_phoneme(
        phns, phn_rel))
    lens = batch["feat"][1].numpy()
    return aligner.get_prev_alignments(
        batch["id"], np.zeros((B, T, 1), np.float32), lens, states, phn_rel)


@pytest.mark.parametrize("training_type", TYPES)
def test_training_types_match_jax(training_type):
    jm, pm = _models(training_type)
    assert pm.training_type == training_type and pm.ALLOW_KEYLESS_CKPT
    assert sorted(n for n, _ in pm.named_children()) == \
        ["model", "normalizer", "output"]
    batch = make_batch(8)
    pm.set_stage(Stage.TEST)
    jb = jax_batch(batch)
    if training_type == "viterbi":
        prev = _jax_prev(jm, batch)
        jb["prev_alignments"] = (jnp.asarray(prev), jb["feat"][1])
        pm.prepare_batch(batch)
        np.testing.assert_array_equal(batch["prev_alignments"][0].numpy(),
                                      prev)
    j_preds, j_loss, _ = jm._get_compiled("eval", JaxStage.TEST)(
        jm.params, jm.states, jax.random.PRNGKey(0), jb, jnp.int32(1))
    preds, loss, losses = pm.eval_forward(batch)
    assert set(preds) == {"pout"} and losses == {}
    np.testing.assert_allclose(preds["pout"].numpy(),
                               np.asarray(j_preds["pout"]), atol=OUT_ATOL)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)

    step = jm._get_compiled("train", JaxStage.TRAIN)
    eval_train = jm._get_compiled("eval", JaxStage.TRAIN)
    jm.stats_loggers = {"accuracy_stats": JaxMetricStats(
        metric=jm.hparams["aligner"].calc_accuracy)}
    pm.on_stage_start(Stage.TRAIN, 1)
    host = host_batch(batch)
    for i in range(STEPS):
        rng = jax.random.PRNGKey(60 + i)
        if training_type == "viterbi":
            prev = _jax_prev(jm, batch)
            jb["prev_alignments"] = (jnp.asarray(prev), jb["feat"][1])
            host["prev_alignments"] = (prev, host["feat"][1])
        j_loss, _, j_grads = jax_step_grads(jm, jb, rng)
        (jm.params, jm.opt_states, jm.states, _, _) = step(
            jm.params, jm.opt_states, jm.states, rng, jb, jnp.int32(1))
        if training_type == "viterbi":   # the JAX recipe's realignment
            j_preds, _, _ = eval_train(jm.params, jm.states, rng, jb,
                                       jnp.int32(1))
            jm._batch_ids = batch["id"]
            jm.evaluate_predictions(j_preds, host, JaxStage.TRAIN)
        loss, _ = pm.fit_batch(batch, 1)
        np.testing.assert_allclose(float(loss), j_loss, rtol=RTOL,
                                   err_msg=f"step {i}")
        for mk, mod in pm.param_modules().items():
            got = torch.cat([q.grad.reshape(-1) for q in mod.parameters()])
            sd = from_jax({mk: j_grads[mk]})
            ref = torch.cat([sd[f"{mk}.{n}"].reshape(-1)
                             for n, _ in mod.named_parameters()])
            assert norm_err(got, ref) <= GRAD_RTOL, (i, mk)
        want = from_jax(jax.device_get(jm.params), jax.device_get(jm.states))
        for name, value in pm.state_dict().items():
            if name != "output.lin.bias":
                assert norm_err(value, want[name]) <= RTOL, (i, name)
        # the time-mean subtraction cancels the output bias: its gradient
        # is zero up to f32 noise in both packages, and Adam moves each
        # entry by a step of up to lr whose sign is the noise's
        assert float(pm.output.lin.bias.grad.abs().max()) < 1e-6
        drift = float((pm.output.lin.bias - want["output.lin.bias"]).abs(
        ).max())
        assert drift <= 2 * LR * (i + 1), (i, drift)
    p_store = pm.hparams["aligner"].align_dict
    j_store = jm.hparams["aligner"].align_dict
    if training_type == "viterbi":
        assert sorted(p_store) == sorted(j_store) == sorted(batch["id"])
        for k in j_store:
            np.testing.assert_array_equal(p_store[k], j_store[k])
        assert pm.stats_loggers["accuracy_stats"].scores == \
            jm.stats_loggers["accuracy_stats"].scores
    else:
        assert p_store == {}


# ---------------------------------------------------------------------------
# (e) fit and evaluate through the CLI's experiment
# ---------------------------------------------------------------------------

EPOCHS = 2
BATCH = 6


def cli_args(name, package, device, training_type, epochs=EPOCHS,
             debug=True):
    yaml = REPO / package / "models/HMM_DNN_ALI/model.yaml"
    args = [str(REPO / "config/run.yaml"), "--batch_size", str(BATCH),
            "--dataset", "SynAudioMNIST", "--language", "digits",
            "--n_phonemes", "12", "--model_class", "HMM_DNN_ALI",
            "--model_name", name, "--model", f"!include:{yaml}",
            "--extra_overrides",
            "{model: {n_epochs: %d, dnn_neurons: 32, init_training_type: "
            "%s, realign_during_train: True}}" % (epochs, training_type)]
    if debug:
        args += ["--debug", "--debug_batches", "2"]
    return args + (["--device", "cpu"] if device else [])


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("training_type", ["forward", "viterbi"])
def test_fit_and_evaluate_match_jax(training_type, workdir, monkeypatch):
    monkeypatch.setattr(jdio, "_native_lib", lambda: None)
    jp = jax_prepare(cli_args("jx", "mlvae_tpu", False, training_type),
                     prepare_exp_dir=True)
    pp = prepare_experiment(cli_args("px", "mlvae_tpu_torch", True,
                                     training_type))
    jm, pm = jp["model"], pp["model"]
    for jds, pds in zip(jp["datasets"], pp["datasets"]):
        assert pds.ids == jds.ids
    jm.init_params()
    missing, unexpected = pm.load_state_dict(
        from_jax(jax.device_get(jm.params)), strict=False)
    assert not unexpected and all(k.startswith("normalizer.")
                                  for k in missing)
    pm.noise_source = JaxDraws(jm.rng)
    jrec, prec = StageLosses(jm), StageLosses(pm)
    for prep, model in ((jp, jm), (pp, pm)):
        h = prep["hparams"]
        model.fit(h["model"]["epoch_counter"], prep["datasets"][0],
                  prep["datasets"][1],
                  train_loader_kwargs=h["train_dataloader_opts"],
                  valid_loader_kwargs=h["valid_dataloader_opts"])
    assert [s[:2] for s in prec.losses] == [s[:2] for s in jrec.losses] \
        == [(st, e) for e in range(1, EPOCHS + 1)
            for st in ("TRAIN", "VALID")]
    for (name, epoch, got), (_, _, want) in zip(prec.losses, jrec.losses):
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   err_msg=f"{name} epoch {epoch}")

    def store(prep):
        return prep["hparams"]["model"]["aligner"].align_dict
    # viterbi realigns every train batch; both align VALID's utterances
    assert sorted(store(pp)) == sorted(store(jp))
    n_train = len(jp["datasets"][0].ids)
    assert len(store(jp)) >= (n_train if training_type == "viterbi" else 0)
    for k, v in store(jp).items():
        np.testing.assert_array_equal(store(pp)[k], v, err_msg=k)

    # evaluate from the JAX run's newest checkpoint: the selection key is
    # absent from every checkpoint
    jck = jm.checkpointer.find_checkpoint()
    pm.checkpointer = type(pm.checkpointer)(jck.path.parent)
    for prep, model in ((jp, jm), (pp, pm)):
        with pytest.warns(UserWarning, match="falling back to the newest"):
            model.evaluate(prep["datasets"][2], max_key="flvl_md.F1",
                           test_loader_kwargs=prep["hparams"][
                               "test_dataloader_opts"])
    assert pm.checkpointer.last_selection_fell_back
    got, want = (m.stats_loggers["accuracy_stats"] for m in (pm, jm))
    assert got.scores == want.scores and got.ids == want.ids
    assert got.summarize("average") == want.summarize("average")
    for k, v in store(jp).items():
        np.testing.assert_array_equal(store(pp)[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# (f) the keyless-checkpoint repair
# ---------------------------------------------------------------------------

def test_hmm_evaluate_recalls_newest_on_absent_key(workdir):
    """Outside ``--debug`` (which skips the guard) and with one epoch (so
    that the epoch guard passes), ``cli.test`` of HMM_DNN_ALI evaluates the
    newest checkpoint with the loud warning, and restores its weights."""
    args = cli_args("hmm_keyless", "mlvae_tpu_torch", True, "forward",
                    epochs=1, debug=False)
    train_cli.main(args)
    ckpt_dir = workdir / "results/hmm_keyless/checkpoints"
    with pytest.warns(UserWarning, match="falling back to the newest"):
        model = test_cli.main(args)
    assert model.checkpointer.last_selection_fell_back
    newest = model.checkpointer.find_checkpoint()
    assert newest.path.parent.resolve() == ckpt_dir.resolve()
    saved = from_jax(read_npz_tree(newest.path / "params.npz"))
    for name, value in model.state_dict().items():
        if name in saved:
            np.testing.assert_array_equal(value.numpy(), saved[name].numpy())
    assert (workdir / "results/hmm_keyless/test_output/accuracy.txt"
            ).exists()


def test_keyless_guard_still_refuses_other_recipes(workdir):
    """test_phn_classifier selecting on a key no checkpoint records: the
    guard raises, as before, for every recipe that does not opt out."""
    from test_torch_harness import cli_args as harness_args
    args = harness_args("test_phn_classifier", "keyless", "mlvae_tpu_torch",
                        True)
    args = [a for a in args if a not in ("--debug", "--debug_batches",
                                         "2")]
    i = args.index("--extra_overrides") + 1
    args[i] = args[i].replace("n_epochs: 2",
                              "n_epochs: 1, max_key: no_such.metric")
    train_cli.main(args)
    with pytest.raises(RuntimeError, match="selection key"):
        test_cli.main(args)


# ---------------------------------------------------------------------------
# (g) the recipe copy
# ---------------------------------------------------------------------------

def test_recipe_copy_is_byte_equal():
    assert RECIPE.read_bytes() == \
        (REPO / "mlvae_tpu/models/HMM_DNN_ALI/model.yaml").read_bytes()
