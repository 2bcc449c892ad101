"""The five harness recipes (test_phn_classifier, test_b_ind_classifier,
test_vanilla_vae, test_gmm_vae, test_h_vae) and LSTM_FC's CLI recipe
against the JAX package, on the CPU:

* (a) ``PhnAccMetricStats`` and its scoring functions against the JAX
  package's on random logits, equal;
* (b) each harness recipe built from its ``model.yaml`` in both packages
  at narrow widths (every LSTM at H=32, B=4, T=24, L=5), the JAX weights
  and normalizer statistics carried across by ``from_jax``, on one
  numpy-seeded batch with every draw replayed (``SBModel.draws`` names
  them in the JAX RngStream's order): the TEST eval forward (predictions
  atol 1e-5, losses rel 1e-4), then three ``fit_batch`` steps, each
  step's losses rel 1e-4, each module's applied (clipped) gradient rel
  1e-3 in norm, every parameter after the step rel 1e-4 in norm;
* (c) the same three steps under ``--bf16`` at H=128 (a narrower bf16 LSTM
  takes ``lstm_scan``, not a kernel) with the JAX Pallas dispatch forced on
  and its fused kernels in interpret mode, both packages' fused budgets
  lowered alike so that a decoder's In=2H layer takes K4 as at H=512:
  the LSTM tiers by spies, the losses rel 1e-3, the norm of each
  module's applied gradient rel 5e-2 (the bound of
  ``tests/test_torch_amp_step.py`` and ``tests/test_torch_crdnn.py``). A
  bf16 step's gradient carries rounding noise of several per cent in
  both packages, from the bf16 roundings that the two place alike but sum
  in another order (``tests/test_torch_amp_step.py`` sets them out): at
  step 1 of test_phn_classifier the recognizer's bf16 gradients lie 5-7 %
  from the f32 gradient in the port and in the JAX package alike, 13 %
  from each other entry by entry and 2.3 % in norm;
* (d) ``fit`` and ``evaluate`` of each harness recipe and of LSTM_FC
  through the CLI's ``prepare_experiment`` against the JAX package's
  (two epochs, the JAX weights, every draw replayed): each stage's loss
  rel 1e-4, the checkpoints' trees under the JAX checkpointer's keys, and
  on the same weights TEST's statistics (phoneme accuracy, boundary, loss,
  frame-level MD) and ``test_metrics.txt`` equal. LSTM_FC runs at lr
  0.001 in place of its recipe's 1.0 here: at lr 1.0 Adam's first steps
  move every weight by +-1 wherever its gradient is non-zero, so an entry
  whose near-zero gradient takes another sign in the other package (f32
  sums in another order) moves by a whole 2, and the two runs' VALID
  losses part after one epoch (measured: 207.83 against 208.71, rel
  4.2e-3); at 0.001 they agree within 1e-4;
* (e) the recipe copies byte-equal to the JAX package's.
"""
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.lstm_pallas as lp
from mlvae_tpu.cli.experiment import prepare_experiment as jax_prepare
from mlvae_tpu.data import data_io as jdio
from mlvae_tpu.hyperyaml import load_hyperyaml as jax_load_hyperyaml
from mlvae_tpu.metrics import phn_acc as jpa
from mlvae_tpu.training.brain import Stage as JaxStage
from mlvae_tpu.training.checkpointer import _flatten as jax_flatten
from mlvae_tpu.utils import seed as jax_seed

import mlvae_tpu_torch.nn.rnn as prnn
import mlvae_tpu_torch.ops.lstm as L_ops
from mlvae_tpu_torch.bench_utils import INPUT_SIZE
from mlvae_tpu_torch.cli.experiment import prepare_experiment
from mlvae_tpu_torch.convert import from_jax, read_npz_flat
from mlvae_tpu_torch.hyperyaml import load_hyperyaml
from mlvae_tpu_torch.metrics import phn_acc as ppa
from mlvae_tpu_torch.training.brain import Stage
from test_torch_sfl import replay

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
HARNESS = ("test_phn_classifier", "test_b_ind_classifier",
           "test_vanilla_vae", "test_gmm_vae", "test_h_vae")
B, T, L = 4, 24, 5
N_CLS = 14
H = 32
OUT_ATOL, RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-3
AMP_H = 128
AMP_LOSS_RTOL, AMP_GRAD_RTOL = 1e-3, 5e-2
# between K3's and K4's resident bytes at H=128 (tests/test_torch_amp_step)
SEMI_BUDGET = 1_000_000
STEPS = 3
FC = 16


def widths(recipe, h):
    """The recipe's widths at LSTM width ``h`` and narrow FCs."""
    return {
        "test_phn_classifier": {"phn_rnn_hidden_size": h,
                                "phn_fc_size": FC},
        "test_b_ind_classifier": {"boundary_rnn_hidden_size": h,
                                  "boundary_fc_size": FC},
        "test_vanilla_vae": {"dec_rnn_hidden_size": h, "dec_fc_size": FC,
                             "enc_fc_size": FC, "latent_size": 8},
        "test_gmm_vae": {"dec_rnn_hidden_size": h, "dec_fc_size": FC,
                         "enc_fc_size": FC, "latent_size": 8},
        "test_h_vae": {"rnn_hidden_size": h, "pi_fc_size": FC,
                       "dec_rnn_hidden_size": h, "dec_fc_size": FC,
                       "enc_fc_size": FC, "latent_size": 8},
        "LSTM_FC": {"lstm_hidden_size": h, "lstm_num_layers": 2,
                    "fc_size": FC, "lr": 0.001},
    }[recipe]


def _injected(recipe, h):
    return {"n_epochs": 1, "dataset_name": "SynAudioMNIST",
            "model_name": "bench", "output_dir": "/tmp/mlvae_bench",
            "input_size": INPUT_SIZE, "n_phonemes": N_CLS - 2,
            "batch_size": B, **widths(recipe, h)}


def _jax_model(recipe, h=H, bf16=False):
    injected = _injected(recipe, h)
    with open(REPO / "mlvae_tpu/models" / recipe / "model.yaml") as f:
        hp = jax_load_hyperyaml(f, overrides=injected,
                                overrides_must_match=False)
    hp.update({k: v for k, v in injected.items() if k not in hp})
    cls = importlib.import_module(f"mlvae_tpu.models.{recipe}.model").SBModel
    model = cls(modules=hp["modules"], hparams=hp, run_opts={"bf16": bf16},
                checkpointer=None)
    init_params_seeded(model)
    model.ensure_states(INPUT_SIZE)
    rs = np.random.RandomState(1)
    model.states["normalizer"] = {
        "count": jnp.float32(12.0),
        "glob_mean": jnp.asarray(rs.randn(INPUT_SIZE).astype(np.float32)
                                 * 0.2),
        "glob_std": jnp.asarray((0.5 + rs.rand(INPUT_SIZE)).astype(
            np.float32))}
    model.init_optimizers()
    return model


def init_params_seeded(model, seed=0):
    """The JAX model's ``init_params`` from ``seed``, whatever global seed
    an earlier test's YAML left (``config/run.yaml`` sets one)."""
    before = jax_seed.get_seed()
    jax_seed.manual_seed(seed)
    try:
        model.init_params()
    finally:
        jax_seed.manual_seed(before)


def _port(recipe, jm, h=H, bf16=False):
    injected = _injected(recipe, h)
    with open(REPO / "mlvae_tpu_torch/models" / recipe / "model.yaml") as f:
        hp = load_hyperyaml(f, overrides=injected,
                            overrides_must_match=False, device="cpu")
    hp.update({k: v for k, v in injected.items() if k not in hp})
    cls = importlib.import_module(
        f"mlvae_tpu_torch.models.{recipe}.model").SBModel
    model = cls(modules=hp["modules"], hparams=hp, run_opts={"bf16": bf16},
                device="cpu")
    model.load_state_dict(from_jax(jax.device_get(jm.params),
                                   jax.device_get(jm.states)), strict=True)
    model.init_optimizers()
    return model


def make_batch(seed, n_cls=N_CLS):
    """A numpy-seeded batch of every key the harness recipes read, as
    (tensor, relative lengths): features, canonical phonemes and their
    frame-level expansion over ``gt_boundary_seq``, and forced-alignment
    boundaries, one start frame per phoneme."""
    rs = np.random.RandomState(seed)
    t_lens = np.array([T, T - 2, T - 5, T - 8])
    l_lens = np.array([L, L - 1, L - 2, 3])
    feats = rs.randn(B, T, INPUT_SIZE).astype(np.float32)
    cn = np.zeros((B, L), np.int64)
    fa, gt, flvl = (np.zeros((B, T), np.int64) for _ in range(3))
    for b in range(B):
        cn[b, :l_lens[b]] = rs.randint(1, n_cls, l_lens[b])
        for seq in (fa, gt):
            starts = np.sort(rs.choice(np.arange(1, t_lens[b]),
                                       l_lens[b] - 1, replace=False))
            seq[b, 0] = 1
            seq[b, starts] = 1
        idx = np.cumsum(gt[b, :t_lens[b]]) - 1
        flvl[b, :t_lens[b]] = cn[b, idx]
    t_rel = (t_lens / T).astype(np.float32)
    l_rel = (l_lens / L).astype(np.float32)

    def pair(a, rel):
        return (torch.from_numpy(a), torch.from_numpy(rel))
    return {"id": [f"utt{b}" for b in range(B)],
            "feat": pair(feats, t_rel), "gt_cnncl_seq": pair(cn, l_rel),
            "fa_boundary_seq": pair(fa, t_rel),
            "gt_boundary_seq": pair(gt, t_rel),
            "flvl_gt_cnncl_seq": pair(flvl, t_rel)}


def jax_batch(batch):
    return {k: tuple(jnp.asarray(x.numpy()) for x in v)
            for k, v in batch.items() if k != "id"}


def norm_err(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def jax_step_grads(jm, jb, rng, amp=False):
    """The JAX train step's losses and the grads it applies, by module
    (clipped as it clips them), from the model's current parameters
    (call it before the compiled step, which consumes them)."""
    from mlvae_tpu.training.brain import _cast_floats, _global_norm

    def loss_fn(p):
        b = jb
        if amp:
            p = _cast_floats(p, jnp.bfloat16)
            b = _cast_floats(jb, jnp.bfloat16, min_ndim=2)
        preds, _ = jm.compute_forward(p, jm.states, b, JaxStage.TRAIN, rng,
                                      1)
        if amp:
            preds = _cast_floats(preds, jnp.float32)
        return jm.compute_objectives(preds, jb, JaxStage.TRAIN)
    (loss, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jm.params)
    clip = min(1.0, jm.max_grad_norm / (float(_global_norm(grads)) + 1e-12))
    return float(loss), jax.device_get(losses), jax.tree_util.tree_map(
        lambda g: np.asarray(g) * np.float32(clip), jax.device_get(grads))


def module_grads(pm):
    """Each module's applied gradient; a module that autograd never
    reached (test_h_vae's ``pi_fc``, behind the sample) has zeros, as the
    JAX step gives it."""
    return {mk: torch.cat([(q.grad if q.grad is not None
                            else torch.zeros_like(q)).reshape(-1)
                           for q in mod.parameters()])
            for mk, mod in pm.param_modules().items()}


def jax_module_grad(pm, mk, j_grads):
    sd = from_jax({mk: j_grads[mk]})
    return torch.cat([sd[f"{mk}.{n}"].reshape(-1)
                      for n, _ in getattr(pm, mk).named_parameters()])


# ---------------------------------------------------------------------------
# (a) the phoneme accuracy metric
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phn_acc_matches_jax(seed):
    batch = make_batch(seed)
    rs = np.random.RandomState(seed + 10)
    lens = np.round(batch["feat"][1].numpy() * T).astype(int)
    llens = np.round(batch["gt_cnncl_seq"][1].numpy() * L).astype(int)
    preds = [rs.randn(n, N_CLS).astype(np.float32) for n in lens]
    flvl = [batch["flvl_gt_cnncl_seq"][0][b, :n].numpy()
            for b, n in enumerate(lens)]
    plvl = [batch["gt_cnncl_seq"][0][b, :n].numpy()
            for b, n in enumerate(llens)]
    bnd = [batch["gt_boundary_seq"][0][b, :n].numpy()
           for b, n in enumerate(lens)]
    # a prediction that gets every frame right
    preds[0][np.arange(lens[0]), flvl[0]] += 100.0
    got, want = ppa.PhnAccMetricStats(), jpa.PhnAccMetricStats()
    for stats in (got, want):
        stats.append(batch["id"], predictions=preds, flvl_targets=flvl,
                     plvl_targets=plvl, boundary_seqs=bnd)
        stats.append(["x"], predictions=preds[1:2], flvl_targets=flvl[1:2])
    assert got.scores_list == want.scores_list
    assert got.scores_list[0] == {"flvl_acc": 100.0, "plvl_acc": 100.0}
    assert got.summarize() == want.summarize()
    assert got.summarize("plvl_acc") == want.summarize("plvl_acc")
    with pytest.raises(ValueError):
        ppa.flvl_phn_acc_scoring(preds[0], flvl[0][:-1])
    with pytest.raises(ValueError):
        ppa.batch_phn_acc_scoring(preds, flvl, plvl_targets=plvl)
    with pytest.raises(TypeError):
        ppa.batch_phn_acc_scoring(tuple(preds), flvl)


# ---------------------------------------------------------------------------
# (b) the eval forward and three f32 steps
# ---------------------------------------------------------------------------

PRED_KEYS = {"test_phn_classifier": {"out"},
             "test_b_ind_classifier": {"boundary_v"},
             "test_vanilla_vae": set(), "test_gmm_vae": set(),
             "test_h_vae": set()}


@pytest.mark.parametrize("recipe", HARNESS)
def test_eval_forward_and_steps_match_jax(recipe):
    jm = _jax_model(recipe)
    pm = _port(recipe, jm)
    batch = make_batch(1)
    jb = jax_batch(batch)
    rng = jax.random.PRNGKey(7)
    j_preds, j_loss, j_losses = jm._get_compiled("eval", JaxStage.TEST)(
        jm.params, jm.states, rng, jb, jnp.int32(1))
    pm.set_stage(Stage.TEST)
    preds, loss, losses = pm.eval_forward(
        batch, noise=replay(pm.draws(B, T, False), rng))
    assert set(preds) == set(j_preds) == PRED_KEYS[recipe]
    for key in preds:
        np.testing.assert_allclose(preds[key].numpy(),
                                   np.asarray(j_preds[key]), atol=OUT_ATOL)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
    assert set(losses) == set(j_losses)
    for key in losses:
        np.testing.assert_allclose(float(losses[key]),
                                   float(j_losses[key]), rtol=RTOL)

    step = jm._get_compiled("train", JaxStage.TRAIN)
    for i in range(STEPS):
        rng = jax.random.PRNGKey(40 + i)
        j_loss, j_losses, j_grads = jax_step_grads(jm, jb, rng)
        (jm.params, jm.opt_states, jm.states, _, _) = step(
            jm.params, jm.opt_states, jm.states, rng, jb, jnp.int32(1))
        loss, losses = pm.fit_batch(batch, 1, noise=replay(
            pm.draws(B, T, True), rng))
        np.testing.assert_allclose(float(loss), j_loss, rtol=RTOL,
                                   err_msg=f"step {i}")
        for key in j_losses:
            np.testing.assert_allclose(float(losses[key]),
                                       float(j_losses[key]), rtol=RTOL,
                                       err_msg=f"step {i} {key}")
        for mk, got in module_grads(pm).items():
            assert norm_err(got, jax_module_grad(pm, mk, j_grads)) \
                <= GRAD_RTOL, (i, mk)
        want = from_jax(jax.device_get(jm.params),
                        jax.device_get(jm.states))
        for name, value in pm.state_dict().items():
            assert norm_err(value, want[name]) <= RTOL, (i, name)


# ---------------------------------------------------------------------------
# (c) three --bf16 steps at H=128 on the fused tiers
# ---------------------------------------------------------------------------

# each step's LSTM layers by direction, in the port's call order: a
# unidirectional two-layer stack takes K3 twice; the decoder's first
# bidirectional layer (In = latent) K3 and its second (In = 2H) K4
AMP_TIERS = {"test_phn_classifier": ["K3"] * 2,
             "test_b_ind_classifier": ["K3"] * 2,
             "test_vanilla_vae": ["K3"] * 2 + ["K4"] * 2,
             "test_gmm_vae": ["K3"] * 2 + ["K4"] * 2,
             "test_h_vae": ["K3"] * 4 + ["K4"] * 2}


@pytest.fixture
def amp_tiers(monkeypatch):
    """The JAX Pallas dispatch forced on, its fused kernels in interpret
    mode, both packages' budgets lowered alike, the port's LSTM autograd
    calls recorded."""
    pcalls = []
    real = {"K3": lp.lstm_layer_fused, "K4": lp.lstm_layer_semifused}

    def spy(name):
        def f(x, w_ih, bias, w_hh, reverse=False, interpret=False):
            return real[name](x, w_ih, bias, w_hh, reverse, True)
        return f

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer_fused", spy("K3"))
    monkeypatch.setattr(lp, "lstm_layer_semifused", spy("K4"))
    monkeypatch.setattr(lp, "FUSED_RESIDENT_BUDGET", SEMI_BUDGET)
    monkeypatch.setattr(L_ops, "FUSED_RESIDENT_BUDGET", SEMI_BUDGET)
    for name, short in (("LSTMRecurrence", "K1"), ("LSTMFused", "K3"),
                        ("LSTMSemiFused", "K4")):
        cls = getattr(prnn, name)

        def apply(*a, _orig=cls.apply, _short=short):
            pcalls.append((_short, a[0].dtype))
            return _orig(*a)
        monkeypatch.setattr(cls, "apply", apply)
    return pcalls


@pytest.mark.parametrize("recipe", HARNESS)
def test_bf16_steps_match_jax(recipe, amp_tiers):
    jm = _jax_model(recipe, AMP_H, bf16=True)
    pm = _port(recipe, jm, AMP_H, bf16=True)
    assert pm.auto_mix_prec and jm.auto_mix_prec
    batch = make_batch(2)
    jb = jax_batch(batch)
    step = jm._get_compiled("train", JaxStage.TRAIN)
    for i in range(STEPS):
        rng = jax.random.PRNGKey(50 + i)
        j_loss, j_losses, j_grads = jax_step_grads(jm, jb, rng, amp=True)
        (jm.params, jm.opt_states, jm.states, _, _) = step(
            jm.params, jm.opt_states, jm.states, rng, jb, jnp.int32(1))
        amp_tiers.clear()
        loss, losses = pm.fit_batch(batch, 1, noise=replay(
            pm.draws(B, T, True), rng))
        assert amp_tiers == [(k, torch.bfloat16)
                             for k in AMP_TIERS[recipe]], amp_tiers
        np.testing.assert_allclose(float(loss), j_loss, rtol=AMP_LOSS_RTOL,
                                   err_msg=f"step {i}")
        for key in j_losses:
            np.testing.assert_allclose(float(losses[key]),
                                       float(j_losses[key]),
                                       rtol=AMP_LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
        for mk, got in module_grads(pm).items():
            want = float(jax_module_grad(pm, mk, j_grads).norm())
            err = abs(float(got.norm()) - want) / max(want, 1e-30)
            assert err <= AMP_GRAD_RTOL, (i, mk, err)
    assert all(q.dtype == torch.float32 for q in pm.parameters())


# ---------------------------------------------------------------------------
# (d) fit and evaluate through the CLI's experiment
# ---------------------------------------------------------------------------

CLI_RECIPES = HARNESS + ("LSTM_FC",)
EPOCHS = 2
BATCH = 6   # the train set's 12 utterances in two batches, the others one
# the TEST statistics each recipe keeps, beside the loss statistics of its
# metric keys
TEST_STATS = {"test_phn_classifier": ["phn_acc_stats"],
              "test_b_ind_classifier": ["boundary_stats"],
              "test_vanilla_vae": ["kld_loss_stats", "recon_loss_stats"],
              "test_gmm_vae": ["kld_loss_stats", "recon_loss_stats"],
              "test_h_vae": ["recon_loss_stats", "vae_kld_loss_stats"],
              "LSTM_FC": ["flvl_md_stats"]}
SELECT = {"test_phn_classifier": ("phn_acc.flvl_acc", None),
          "test_b_ind_classifier": ("boundary.f1", None),
          "LSTM_FC": ("flvl_md.F1", None)}


def cli_args(recipe, name, package, device):
    yaml = REPO / package / "models" / recipe / "model.yaml"
    extra = ", ".join(f"{k}: {v}" for k, v in widths(recipe, H).items())
    args = [str(REPO / "config/run.yaml"), "--batch_size", str(BATCH),
            "--dataset", "SynAudioMNIST", "--language", "digits",
            "--n_phonemes", "12", "--model_class", recipe,
            "--model_name", name, "--model", f"!include:{yaml}",
            "--extra_overrides",
            "{model: {n_epochs: %d, %s}}" % (EPOCHS, extra),
            "--debug", "--debug_batches", "2"]
    return args + (["--device", "cpu"] if device else [])


class JaxDraws:
    """The JAX Brain's step keys (one split of its rng a step, train and
    eval alike), each step's draws made from its key."""

    def __init__(self, rng):
        self.rng = rng

    def __call__(self, draws):
        self.rng, key = jax.random.split(self.rng)
        return replay(draws, key)


class StageLosses:
    def __init__(self, model):
        self.losses = []
        end = model.on_stage_end

        def on_stage_end(stage, stage_loss, epoch=None):
            self.losses.append((stage.name, epoch, float(stage_loss)))
            return end(stage, stage_loss, epoch)
        model.on_stage_end = on_stage_end


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def fit_both(jp, pp, epochs):
    """Both runs' ``fit`` from the JAX weights, the draws replayed;
    returns each stage's (name, epoch, loss), port then JAX."""
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
    stages = [(st, e) for e in range(1, epochs + 1)
              for st in ("TRAIN", "VALID")]
    assert [s[:2] for s in prec.losses] == [s[:2] for s in jrec.losses] \
        == stages
    for (name, epoch, got), (_, _, want) in zip(prec.losses, jrec.losses):
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   err_msg=f"{name} epoch {epoch}")
    return prec.losses, jrec.losses


def test_metrics(workdir, run):
    text = (workdir / f"results/{run}/test_output/test_metrics.txt"
            ).read_text().splitlines()
    return dict(ln.split(": ") for ln in text[1:-1])


test_metrics.__test__ = False


@pytest.mark.parametrize("recipe", CLI_RECIPES)
def test_fit_and_evaluate_match_jax(recipe, workdir, monkeypatch):
    monkeypatch.setattr(jdio, "_native_lib", lambda: None)
    jp = jax_prepare(cli_args(recipe, "jx", "mlvae_tpu", False),
                     prepare_exp_dir=True)
    pp = prepare_experiment(cli_args(recipe, "px", "mlvae_tpu_torch", True))
    jm, pm = jp["model"], pp["model"]
    fit_both(jp, pp, EPOCHS)
    # the checkpoints: the same trees under the JAX checkpointer's keys
    max_key, min_key = SELECT.get(recipe, (None, "loss"))
    jck, pck = (m.checkpointer.find_checkpoint(max_key=max_key,
                                               min_key=min_key)
                for m in (jm, pm))
    for blob in ("params.npz", "states.npz", "opt__optimizer.npz"):
        got, want = read_npz_flat(pck.path / blob), \
            read_npz_flat(jck.path / blob)
        assert sorted(got) == sorted(want), blob
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
    assert jax_flatten(jax.device_get(jm.opt_states["optimizer"])).keys() \
        == read_npz_flat(pck.path / "opt__optimizer.npz").keys()

    # evaluate from the JAX run's best checkpoint, the draws replayed
    pm.checkpointer = type(pm.checkpointer)(jck.path.parent)
    pm.noise_source = JaxDraws(jm.rng)
    for prep, model in ((jp, jm), (pp, pm)):
        model.evaluate(prep["datasets"][2], max_key=max_key,
                       min_key=min_key, test_loader_kwargs=prep["hparams"][
                           "test_dataloader_opts"])
    assert sorted(pm.stats_loggers) == sorted(jm.stats_loggers) == \
        TEST_STATS[recipe]
    for key in TEST_STATS[recipe]:
        got, want = pm.stats_loggers[key], jm.stats_loggers[key]
        if key.endswith("_loss_stats"):
            np.testing.assert_allclose(got.summarize("loss"),
                                       want.summarize("loss"), rtol=RTOL)
        else:
            assert got.scores_list == want.scores_list, key
    got, want = test_metrics(workdir, "px"), test_metrics(workdir, "jx")
    assert list(got) == list(want)
    for key in want:
        if "loss" in key:   # rounded to 2 or 3 decimals
            assert abs(float(got[key]) - float(want[key])) <= 0.01, key
        else:
            assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# (e) the recipe copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", CLI_RECIPES)
def test_recipe_copies_are_byte_equal(recipe):
    port = REPO / "mlvae_tpu_torch/models" / recipe / "model.yaml"
    assert port.read_bytes() == \
        (REPO / "mlvae_tpu/models" / recipe / "model.yaml").read_bytes()
