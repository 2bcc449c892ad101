"""The CRDNN_CTC slice against the JAX package, on the CPU:

* (d) the CRDNN_CTC eval forward and one f32 train step at narrow widths
  (``cnn_channels`` (8, 16), H=32, ``dnn_neurons`` 32, B=4, T=24), the
  JAX recipe built from its ``model.yaml``, its weights carried across by
  ``from_jax`` and the dropout draws replayed (``CRDNN.draws`` names them
  in RngStream order): the log-probabilities atol 1e-5, the losses rel
  1e-4, every parameter and Adadelta moment after the step rel 1e-4 in
  norm; ``VanillaNN`` against the JAX module;
* (e) one ``--bf16`` step at LSTM H=128 with the JAX Pallas dispatch
  forced on (kernels in interpret mode) and both packages' fused budgets
  lowered alike, so that the first LSTM layer (In 480, padded to 512)
  falls out of both fused tiers onto K1 on bf16 streams and layers 2-4
  (In 256) take K4, as at full width: the dispatch by spies, the loss rel
  1e-2, each module's applied grad norm rel 5e-2 (the tolerances of
  ``tests/test_torch_amp_step.py``, for the same reasons);
* (f) ``fit`` and ``evaluate`` of both recipes through the CLI's
  ``prepare_experiment`` against the JAX package's, every draw replayed:
  each epoch's train and valid loss rel 1e-4; TEST's greedy decodes, PER,
  MD and boundary statistics and ``md_result_seqs.txt`` equal; the
  checkpoints' optimizer trees under the JAX checkpointer's keys;
* (g) ``k1_plan`` and the bf16 K1 wrappers at H = 128-512 (the launches'
  bookkeeping on meta tensors), H % 128 != 0 refused naming
  ``lstm_scan``, which ``nn.rnn`` runs such a layer on;
* (h) the recipe copies byte-equal to the JAX package's, the CLI and the
  registry refusing nothing (the wav2vec2 family, the last, is ported),
  and the HMM_DNN_ALI names resolving into the port."""
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
from mlvae_tpu.hyperyaml import load_hyperyaml
from mlvae_tpu.models.CRDNN_CTC.model import SBModel as JaxCRDNNCTC
from mlvae_tpu.modules.crdnn import VanillaNN as JaxVanillaNN
from mlvae_tpu.training.brain import Stage as JaxStage
from mlvae_tpu.training.checkpointer import _flatten as jax_flatten

import mlvae_tpu_torch.nn.rnn as prnn
import mlvae_tpu_torch.ops.lstm as L
from mlvae_tpu_torch.bench_utils import (INPUT_SIZE, build_crdnn_ctc,
                                         synth_ctc_batch)
from mlvae_tpu_torch.cli.experiment import (UNPORTED_MODELS,
                                            prepare_experiment)
from mlvae_tpu_torch.convert import from_jax, read_npz_flat
from mlvae_tpu_torch.hyperyaml import registry
from mlvae_tpu_torch.modules.crdnn import VanillaNN
from mlvae_tpu_torch.ops import k1_plan as P
from test_torch_lstm_wide_bf16 import _k1_args, recorded  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RECIPES = ("CRDNN_CTC", "CRDNN_CTC_cnncl")
B, T, L_PHN = 4, 24, 5
NARROW = {"cnn_channels": [8, 16], "rnn_neurons": 32, "dnn_neurons": 32}
OUT_ATOL, RTOL = 1e-5, 1e-4
AMP_H = 128
AMP_LOSS_RTOL, AMP_GRAD_RTOL = 1e-2, 5e-2
# layer 1 (In 480 -> 512) semi-fused needs (512+128)*512*2 + 128*512*4 =
# 917,504 bytes, layers 2-4 (In 256) 655,360 and fully fused 1,179,648:
# between the two, layer 1 takes K1 and layers 2-4 K4
AMP_BUDGET = 800_000


def _jax_model(widths, bf16=False):
    injected = {"n_epochs": 1, "dataset_name": "SynAudioMNIST",
                "model_name": "bench", "output_dir": "/tmp/mlvae_bench",
                "input_size": INPUT_SIZE, "n_phonemes": 12,
                "batch_size": B, **widths}
    with open(REPO / "mlvae_tpu/models/CRDNN_CTC/model.yaml") as f:
        hp = load_hyperyaml(f, overrides=injected,
                            overrides_must_match=False)
    hp.update({k: v for k, v in injected.items() if k not in hp})
    model = JaxCRDNNCTC(modules=hp["modules"], hparams=hp,
                        run_opts={"bf16": bf16}, checkpointer=None)
    model.init_params()
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


def _port(jm, widths, bf16=False):
    pm = build_crdnn_ctc(B, overrides={**widths, "cnn_channels": tuple(
        widths["cnn_channels"])}, device="cpu", bf16=bf16)
    pm.load_state_dict(from_jax(jax.device_get(jm.params),
                                jax.device_get(jm.states)), strict=True)
    return pm


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


def _norm_err(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


# ---------------------------------------------------------------------------
# (d) the forward and one f32 train step
# ---------------------------------------------------------------------------

def test_eval_forward_and_train_step_match_jax():
    jm = _jax_model(NARROW)
    pm = _port(jm, NARROW)
    assert {n for n, _ in pm.named_children()} == {"crdnn", "output",
                                                   "normalizer"}
    batch = synth_ctc_batch(B, T, L_PHN, seed=1, device="cpu")
    jb = _jax_batch(batch)
    j_preds, j_loss, _ = jm._get_compiled("eval", JaxStage.TEST)(
        jm.params, jm.states, jax.random.PRNGKey(0), jb, jnp.int32(1))
    preds, loss, losses = pm.eval_forward(batch)
    assert set(preds) == {"pout"} and losses == {}
    assert preds["pout"].shape == (B, T // 2, 14)
    np.testing.assert_allclose(preds["pout"].numpy(),
                               np.asarray(j_preds["pout"]), atol=OUT_ATOL)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)

    rng = jax.random.PRNGKey(40)
    _, j_grads = _jax_step_grads(jm, batch, rng)   # before the step
    p, o, s, j_loss, _ = jm._get_compiled("train", JaxStage.TRAIN)(
        jm.params, jm.opt_states, jm.states, rng, jb, jnp.int32(1))
    draws = pm.draws(B, T, train=True)
    assert [d[0] for d in draws] == ["cnn_dropout"] * 2 + \
        ["rnn_dropout"] * 3 + ["dnn_dropout"] * 2
    assert [d[2] for d in draws][::2] == [(B, 1, 1, 8), (T // 2, B, 64),
                                          (T // 2, B, 64), (B, T // 2, 32)]
    loss, _ = pm.fit_batch(batch, 1, noise=_replay(draws, rng))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
    # each module's applied (clipped) gradient, entry by entry in norm
    for mk, mod in pm.param_modules().items():
        got = torch.cat([q.grad.reshape(-1) for q in mod.parameters()])
        want_g = from_jax({mk: j_grads[mk]})
        ref = torch.cat([want_g[f"{mk}.{n}"].reshape(-1)
                         for n, _ in mod.named_parameters()])
        assert _norm_err(got, ref) <= RTOL, mk
    want = from_jax(jax.device_get(p), jax.device_get(s))
    for name, value in pm.state_dict().items():
        assert _norm_err(value, want[name]) <= RTOL, name
    j_opt = jax.device_get(o["optimizer"])
    for mk, mod in pm.param_modules().items():
        inner = j_opt[mk].inner_state[1]
        st = pm.opt_states["optimizer"][mk]
        assert int(st["count"]) == int(j_opt[mk].count) == 1
        for key in ("e_g", "e_x"):
            sd = from_jax(getattr(inner, key))
            ref = torch.cat([sd[f"{mk}.{n}"].reshape(-1)
                             for n, _ in mod.named_parameters()])
            assert _norm_err(st[key], ref) <= RTOL, (mk, key)


def test_vanilla_nn_matches_jax():
    jmod = JaxVanillaNN(input_shape=(None, None, 24), dnn_blocks=3,
                        dnn_neurons=16)
    params = jmod.init(jax.random.PRNGKey(3))
    x = np.random.RandomState(2).randn(3, 7, 24).astype(np.float32)
    pmod = VanillaNN(input_size=24, dnn_blocks=3, dnn_neurons=16)
    pmod.load_state_dict(from_jax(jax.device_get(params)), strict=True)
    np.testing.assert_allclose(pmod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmod.apply(params, x)),
                               atol=OUT_ATOL)
    with pytest.raises(ValueError):
        VanillaNN()


# ---------------------------------------------------------------------------
# (e) one --bf16 step: the first LSTM layer on K1 on bf16 streams
# ---------------------------------------------------------------------------

@pytest.fixture
def amp_tiers(monkeypatch):
    """The JAX Pallas dispatch forced on, its K1 and K4 in interpret mode
    and recorded, both packages' budgets lowered alike, the port's LSTM
    autograd calls recorded."""
    jcalls, pcalls = [], []
    real_k1, real_semi = lp.lstm_layer, lp.lstm_layer_semifused

    def k1(gx, w_hh, reverse=False, interpret=False):
        jcalls.append(("K1", gx.dtype, reverse))
        return real_k1(gx, w_hh, reverse, True)

    def semi(x, w_ih, bias, w_hh, reverse=False, interpret=False):
        jcalls.append(("K4", x.dtype, reverse))
        return real_semi(x, w_ih, bias, w_hh, reverse, True)

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer", k1)
    monkeypatch.setattr(lp, "lstm_layer_semifused", semi)
    monkeypatch.setattr(lp, "FUSED_RESIDENT_BUDGET", AMP_BUDGET)
    monkeypatch.setattr(L, "FUSED_RESIDENT_BUDGET", AMP_BUDGET)
    names = {"LSTMRecurrence": "K1", "LSTMFused": "K3",
             "LSTMSemiFused": "K4"}
    for name, short in names.items():
        cls = getattr(prnn, name)

        def apply(*a, _orig=cls.apply, _short=short):
            pcalls.append((_short, a[0].dtype, a[-1]))
            return _orig(*a)
        monkeypatch.setattr(cls, "apply", apply)
    return jcalls, pcalls


def test_bf16_step_takes_k1_then_k4_and_matches_jax(amp_tiers):
    jcalls, pcalls = amp_tiers
    widths = dict(NARROW, rnn_neurons=AMP_H)
    jm = _jax_model(widths, bf16=True)
    pm = _port(jm, widths, bf16=True)
    assert pm.auto_mix_prec and jm.auto_mix_prec
    batch = synth_ctc_batch(B, T, L_PHN, seed=2, device="cpu")
    rng = jax.random.PRNGKey(41)
    j_loss, j_grads = _jax_step_grads(jm, batch, rng, amp=True)
    loss, _ = pm.fit_batch(batch, 1, noise=_replay(pm.draws(B, T, True),
                                                   rng))
    # each layer and direction: layer 1 on K1, layers 2-4 on K4, bf16
    want = [("K1", True)] * 2 + [("K4", True)] * 6
    bf = jnp.bfloat16
    assert [(k, d == bf) for k, d, _ in jcalls[:8]] == want, jcalls
    assert [(k, d == torch.bfloat16) for k, d, _ in pcalls] == want, pcalls
    assert [r for _, _, r in pcalls] == [False, True] * 4
    np.testing.assert_allclose(float(loss), float(j_loss),
                               rtol=AMP_LOSS_RTOL)
    # the applied grads, module by module, against the JAX step's
    for mk, mod in pm.param_modules().items():
        got = float(torch.cat([q.grad.reshape(-1) for q in
                               mod.parameters()]).norm())
        want_norm = float(np.sqrt(sum(
            np.sum(np.square(np.asarray(g, np.float64)))
            for g in jax.tree_util.tree_leaves(j_grads[mk]))))
        assert abs(got - want_norm) <= AMP_GRAD_RTOL * want_norm, \
            (mk, got, want_norm)
    assert all(q.dtype == torch.float32 for q in pm.parameters())


def _jax_step_grads(jm, batch, rng, amp=False):
    """The JAX train step's loss and the grads it applies, by module
    (clipped as it clips them; none was non-finite), from the model's
    current parameters (the compiled step consumes them: call this
    first), through its
    ``compute_forward`` and ``compute_objectives`` under its casts."""
    from mlvae_tpu.training.brain import _cast_floats, _global_norm
    jb = _jax_batch(batch)

    def loss_fn(p):
        b = jb
        if amp:
            p = _cast_floats(p, jnp.bfloat16)
            b = _cast_floats(jb, jnp.bfloat16, min_ndim=2)
        preds, _ = jm.compute_forward(p, jm.states, b, JaxStage.TRAIN, rng,
                                      1)
        if amp:
            preds = _cast_floats(preds, jnp.float32)
        return jm.compute_objectives(preds, jb, JaxStage.TRAIN)[0]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jm.params)
    clip = min(1.0, jm.max_grad_norm / (float(_global_norm(grads)) + 1e-12))
    return float(loss), jax.tree_util.tree_map(
        lambda g: np.asarray(g) * np.float32(clip), jax.device_get(grads))


# ---------------------------------------------------------------------------
# (f) fit and evaluate through the CLI's experiment, both recipes
# ---------------------------------------------------------------------------

EPOCHS = {"CRDNN_CTC": 2, "CRDNN_CTC_cnncl": 1}
BATCH = 6   # the train set's 12 utterances in two batches, the others one


def _args(recipe, name, package, device):
    yaml = REPO / package / "models" / recipe / "model.yaml"
    args = [str(REPO / "config/run.yaml"), "--batch_size", str(BATCH),
            "--dataset", "SynAudioMNIST", "--language", "digits",
            "--n_phonemes", "12", "--model_class", recipe,
            "--model_name", name, "--model", f"!include:{yaml}",
            "--extra_overrides",
            "{model: {n_epochs: %d, cnn_channels: [8, 16], rnn_neurons: 32,"
            " dnn_neurons: 32}}" % EPOCHS[recipe],
            "--debug", "--debug_batches", "2"]
    return args + (["--device", "cpu"] if device else [])


class _JaxDraws:
    """The JAX Brain's step keys (a split of its rng a step, train and
    eval alike), each step's draws made from its key."""

    def __init__(self, rng):
        self.rng = rng

    def __call__(self, draws):
        self.rng, key = jax.random.split(self.rng)
        return _replay(draws, key)


class _Stages:
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


@pytest.mark.parametrize("recipe", RECIPES)
def test_fit_and_evaluate_match_jax(recipe, workdir, monkeypatch):
    monkeypatch.setattr(jdio, "_native_lib", lambda: None)
    jp = jax_prepare(_args(recipe, "jx", "mlvae_tpu", False),
                     prepare_exp_dir=True)
    pp = prepare_experiment(_args(recipe, "px", "mlvae_tpu_torch", True))
    jm, pm = jp["model"], pp["model"]
    assert type(pm).CTC_TARGET_KEY == type(jm).CTC_TARGET_KEY
    for jds, pds in zip(jp["datasets"], pp["datasets"]):
        assert pds.ids == jds.ids
    jm.init_params()
    missing, unexpected = pm.load_state_dict(
        from_jax(jax.device_get(jm.params)), strict=False)
    assert not unexpected and all(k.startswith("normalizer.")
                                  for k in missing)
    pm.noise_source = _JaxDraws(jm.rng)
    jrec, prec = _Stages(jm), _Stages(pm)
    for prep, model in ((jp, jm), (pp, pm)):
        h = prep["hparams"]
        model.fit(h["model"]["epoch_counter"], prep["datasets"][0],
                  prep["datasets"][1],
                  train_loader_kwargs=h["train_dataloader_opts"],
                  valid_loader_kwargs=h["valid_dataloader_opts"])
    stages = [(st, e) for e in range(1, EPOCHS[recipe] + 1)
              for st in ("TRAIN", "VALID")]
    assert [s[:2] for s in prec.losses] == [s[:2] for s in jrec.losses] \
        == stages
    for (name, epoch, got), (_, _, want) in zip(prec.losses, jrec.losses):
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   err_msg=f"{name} epoch {epoch}")
    # the checkpoints: the same trees under the JAX checkpointer's keys
    jck, pck = (m.checkpointer.find_checkpoint(max_key="plvl_md.F1")
                for m in (jm, pm))
    for blob in ("params.npz", "opt__optimizer.npz"):
        got, want = read_npz_flat(pck.path / blob), \
            read_npz_flat(jck.path / blob)
        assert sorted(got) == sorted(want), blob
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
    assert jax_flatten(jax.device_get(jm.opt_states["optimizer"])).keys() \
        == read_npz_flat(pck.path / "opt__optimizer.npz").keys()

    # evaluate on the same weights and statistics
    pm.load_state_dict(from_jax(jax.device_get(jm.params),
                                jax.device_get(jm.states)))
    pm.checkpointer = type(pm.checkpointer)(jck.path.parent)
    for prep, model in ((jp, jm), (pp, pm)):
        model.evaluate(prep["datasets"][2], max_key="plvl_md.F1",
                       test_loader_kwargs=prep["hparams"][
                           "test_dataloader_opts"])
    assert sorted(pm.stats_loggers) == sorted(jm.stats_loggers) == [
        "boundary_stats", "cnncl_per_stats", "phn_per_stats",
        "plvl_md_stats"]
    for key in ("phn_per_stats", "cnncl_per_stats"):
        got, want = pm.stats_loggers[key], jm.stats_loggers[key]
        assert [d["hyp"] for d in got.details] == \
            [d["hyp"] for d in want.details]
        assert got.summarize() == want.summarize()
    for key in ("plvl_md_stats", "boundary_stats"):
        assert pm.stats_loggers[key].scores_list == \
            jm.stats_loggers[key].scores_list, key
    out = "results/{}/test_output/"
    assert (workdir / out.format("px") / "md_result_seqs.txt").read_text() \
        == (workdir / out.format("jx") / "md_result_seqs.txt").read_text()
    for name in ("phn_per.txt", "cnncl_per.txt", "plvl_md.txt",
                 "boundary.txt"):
        assert (workdir / out.format("px") / name).read_text() == \
            (workdir / out.format("jx") / name).read_text(), name

    def metrics(run):
        text = (workdir / out.format(run) / "test_metrics.txt"
                ).read_text().splitlines()
        return dict(ln.split(": ") for ln in text[1:-1])
    got, want = metrics("px"), metrics("jx")
    assert list(got) == list(want)
    for key in want:
        if key == "loss":
            assert abs(float(got[key]) - float(want[key])) <= 0.01
        else:
            assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# (g) K1 on bf16 streams at H <= 512
# ---------------------------------------------------------------------------

NARROW_BF16_H = (128, 256, 384, 512)


@pytest.mark.parametrize("Hn", NARROW_BF16_H)
@pytest.mark.parametrize("Bn", [1, 8, 24, 64, 70])
def test_bf16_plans_at_narrow_h(Hn, Bn):
    f = P.k1_fwd_plan(Hn, Bn, bf16=True)
    b = P.k1_bwd_plan(Hn, Bn, bf16=True)
    w = P.k1_dw_plan(Hn, Bn)
    for plan in (f, b):
        assert plan.variant == "wide_bf16"
        assert plan.units == 8 and plan.blocks == Hn // 8 <= P.SMS
        assert plan.threads == 256 and 0 < plan.smem_bytes <= P.SMEM_LIMIT
    # a slice a warp: H/128 of the eight warps multiply
    assert f.ring == Hn // 128 and f.smem_bytes == Hn // 128 * (
        64 * 128 * 2 + 8)
    assert b.ring == 16 and b.split == (Bn <= 64)
    assert b.smem_bytes == 8 * 16384 + 8 * 64 * 8 * 4 + \
        8 * (4 * Hn + 8) * 2 + 8 * (Hn // 128 + 16)
    assert w.variant == "dw_bf16" and w.blocks == (Hn // 128) * (
        4 * Hn // 128)
    # f32 streams keep the narrow builds
    assert P.k1_fwd_plan(Hn, Bn).variant == "narrow"
    assert P.k1_bwd_plan(Hn, Bn).variant == "narrow"


@pytest.mark.parametrize("Hn", [16, 64, 192, 320, 448, 528])
def test_bf16_h_off_the_lane_names_item_4(Hn):
    for plan in (P.k1_fwd_plan, P.k1_bwd_plan):
        with pytest.raises(ValueError, match="lstm_scan"):
            plan(Hn, 64, bf16=True)
        assert plan(Hn, 64).variant == "narrow"
    with pytest.raises(ValueError, match="lstm_scan"):
        P.k1_dw_plan(Hn, 64)


@pytest.mark.parametrize("Hn", NARROW_BF16_H)
@pytest.mark.parametrize("Tn, Bn", [(1, 1), (2, 8), (80, 24), (9, 64)])
def test_bf16_narrow_layers_take_the_bf16_builds(recorded, Hn, Tn, Bn):
    args = _k1_args(Tn, Bn, Hn, torch.bfloat16)
    hs, cs = L.lstm_layer_fwd(*args[:2])
    assert hs.dtype == torch.bfloat16 and cs.dtype == torch.float32
    dgx, dw = L.lstm_layer_bwd(*args)
    assert dgx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    want = [("lstm_fwd_wide_bf16", 10), ("lstm_bwd_wide_bf16", 14)]
    if Tn > 1:
        want.append(("lstm_dw_wide_bf16", 8))
    assert recorded == want
    assert L.LSTM_FWD_WIDE_BF16.launches == L.LSTM_BWD_WIDE_BF16.launches \
        == 1
    assert L.LSTM_DW_WIDE_BF16.launches == (Tn > 1)
    assert L.LSTM_FWD.launches == L.LSTM_BWD.launches == 0


@pytest.mark.parametrize("Hn", [128, 512])
def test_f32_narrow_layers_keep_the_f32_builds(recorded, Hn):
    args = _k1_args(3, 8, Hn, torch.float32)
    L.lstm_layer_fwd(*args[:2])
    L.lstm_layer_bwd(*args)
    assert recorded == [("lstm_fwd", 11), ("lstm_bwd", 16)]


def test_crdnn_first_layer_is_outside_both_fused_tiers():
    """At the recipe's widths the first layer (In = 256 x 30 = 7,680) takes
    K1 on bf16 streams, the later ones (In = 1,024) K4; f32 takes K1."""
    assert prnn.fused_tier(7680, 512, torch.bfloat16) is None
    assert prnn.fused_tier(1024, 512, torch.bfloat16) is L.LSTMSemiFused
    assert prnn.fused_tier(7680, 512, torch.float32) is None
    assert P.k1_fwd_plan(512, 64, bf16=True).variant == "wide_bf16"


# ---------------------------------------------------------------------------
# (h) the recipe copies, the CLI's and the registry's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_copies_are_byte_equal(recipe):
    port = REPO / "mlvae_tpu_torch/models" / recipe / "model.yaml"
    assert port.read_bytes() == \
        (REPO / "mlvae_tpu/models" / recipe / "model.yaml").read_bytes()


def test_cli_refuses_only_what_is_unported():
    """No recipe is refused: the six wav2vec2 recipes, the last, were
    ported with item 11."""
    assert not set(RECIPES) & set(UNPORTED_MODELS)
    assert UNPORTED_MODELS == {}
    assert registry.UNPORTED == {} and registry.UNPORTED_PREFIXES == {}


@pytest.mark.parametrize("name, target", [
    ("torch.optim.Adadelta", "mlvae_tpu_torch.training.optim"),
    ("torch.optim.SGD", "mlvae_tpu_torch.training.optim"),
    ("speechbrain.nnet.linear.Linear", "mlvae_tpu_torch.nn.sb_compat"),
    ("speechbrain.nnet.activations.Softmax", "mlvae_tpu_torch.nn.sb_compat"),
    ("speechbrain.nnet.schedulers.NewBobScheduler",
     "mlvae_tpu_torch.training.schedulers"),
    ("speechbrain.nnet.losses.ctc_loss", "mlvae_tpu_torch.ops.ctc"),
    ("speechbrain.lobes.models.CRDNN.CRDNN", "mlvae_tpu_torch.modules.crdnn"),
    ("speechbrain.lobes.models.VanillaNN.VanillaNN",
     "mlvae_tpu_torch.modules.crdnn"),
    ("modules.crdnn.CRDNN", "mlvae_tpu_torch.modules.crdnn"),
])
def test_registry_resolves_the_ctc_names(name, target):
    assert registry.locate(name).__module__ == target


@pytest.mark.parametrize("name", [
    "speechbrain.nnet.losses.nll_loss",
    "speechbrain.alignment.aligner.HMMAligner",
    "modules.hmm_aligner.HMMAligner"])
def test_registry_still_refuses_the_hmm_aligner_recipe(name):
    """The HMM_DNN_ALI names, refused until its port, now resolve into the
    port's ``ops.losses`` and ``modules.hmm_aligner``."""
    target = registry.locate(name)
    assert target.__module__ in ("mlvae_tpu_torch.ops.losses",
                                 "mlvae_tpu_torch.modules.hmm_aligner")
