"""The CTC family's host and loss side against the JAX package, on the CPU:

* (a) ``ops.ctc.ctc_loss`` against ``mlvae_tpu.ops.ctc.ctc_loss``
  (``optax.ctc_loss``): values and the gradients with respect to the
  log-probabilities at rel 1e-5, over a case set with padded frames,
  repeated labels, an infeasible utterance (gradient exactly 0) and each
  reduction; the greedy decode, the forced alignment and the segmentation
  boundaries equal;
* (b) ``Adadelta`` and ``SGD`` (with and without momentum) against optax
  through the JAX ``OptimizerFactory``: parameters and moments after five
  steps at rel 1e-6; and on a tiny model of three modules through both
  train steps, the non-finite skip, the inactive modules and the
  checkpoint trees (``opt__optimizer``'s keys and values) equal to the JAX
  checkpointer's;
* (c) ``ErrorRateStats``, ``batch_align_sequences``, ``NewBobScheduler``
  (values and ``state_dict`` over a metric series) and
  ``resample_by_factor_np`` (its guard included) equal to the JAX
  package's."""
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mlvae_tpu.metrics.alignment import \
    batch_align_sequences as jax_batch_align
from mlvae_tpu.metrics.error_rate import ErrorRateStats as JaxErrorRateStats
from mlvae_tpu.nn.layers import Linear as JaxLinear
from mlvae_tpu.ops import ctc as jctc
from mlvae_tpu.training import optim as joptim
from mlvae_tpu.training.brain import Brain as JaxBrain
from mlvae_tpu.training.checkpointer import _flatten as jax_flatten
from mlvae_tpu.training.schedulers import NewBobScheduler as JaxNewBob
from mlvae_tpu.utils.tensor import resample_by_factor_np as jax_resample

from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.metrics.alignment import batch_align_sequences
from mlvae_tpu_torch.metrics.error_rate import ErrorRateStats
from mlvae_tpu_torch.models.md_model import MDModel
from mlvae_tpu_torch.nn.layers import Linear
from mlvae_tpu_torch.ops import ctc
from mlvae_tpu_torch.training import optim
from mlvae_tpu_torch.training.schedulers import NewBobScheduler
from mlvae_tpu_torch.utils.tensor import resample_by_factor_np

torch.set_num_threads(2)

RTOL = 1e-5
OPT_RTOL = 1e-6


# ---------------------------------------------------------------------------
# (a) the CTC loss and the host-side decode, alignment and boundaries
# ---------------------------------------------------------------------------

def _ctc_case(seed, B=6, T=14, K=9, L=6):
    """Log-probabilities, targets with a repeat, input lengths with padded
    frames and one infeasible row (the last: 3 frames for 6 labels)."""
    rs = np.random.RandomState(seed)
    lp = np.asarray(jax.nn.log_softmax(rs.randn(B, T, K) * 2.0))
    tg = rs.randint(1, K, (B, L)).astype(np.int64)
    tg[1, 2] = tg[1, 1]
    tg[2, :3] = tg[2, 0]
    in_l = np.array([1.0, 13 / 14, 0.5, 1.0, 11 / 14, 3 / 14], np.float32)
    tl = np.array([1.0, 5 / 6, 1.0, 0.5, 4 / 6, 1.0], np.float32)
    return lp.astype(np.float32), tg, in_l, tl


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reduction", ["mean", "batchmean", "none"])
def test_ctc_loss_and_grads_match_optax(seed, reduction):
    lp, tg, in_l, tl = _ctc_case(seed)
    B, T, K = lp.shape
    w = np.random.RandomState(9).randn(B).astype(np.float32)

    def jf(x):
        out = jctc.ctc_loss(x, jnp.asarray(tg), jnp.asarray(in_l),
                            jnp.asarray(tl), reduction=reduction)
        return out if out.ndim == 0 else jnp.sum(out * w)
    j_val, j_grad = jax.value_and_grad(jf)(jnp.asarray(lp))
    x = torch.tensor(lp, requires_grad=True)
    out = ctc.ctc_loss(x, torch.from_numpy(tg), torch.from_numpy(in_l),
                       torch.from_numpy(tl), reduction=reduction)
    val = out if out.dim() == 0 else (out * torch.from_numpy(w)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val),
                               rtol=RTOL)
    g, jg = x.grad.numpy(), np.asarray(j_grad)
    np.testing.assert_allclose(g, jg, rtol=RTOL,
                               atol=RTOL * np.abs(jg).max())
    # the infeasible row contributes nothing; padded frames take no grad
    assert not g[-1].any()
    for i, n in enumerate(np.round(in_l * T).astype(int)):
        assert not g[i, n:].any(), i
    if reduction == "none":
        assert float(out[-1].detach()) == 0.0


def test_ctc_loss_is_f32_and_names_the_feasibility_rule():
    lp, tg, in_l, tl = _ctc_case(2)
    x = torch.tensor(lp).to(torch.bfloat16)
    per = ctc.ctc_loss(x, torch.from_numpy(tg), torch.from_numpy(in_l),
                       torch.from_numpy(tl), reduction="none")
    assert per.dtype == torch.float32
    want = np.asarray(jctc.ctc_loss(jnp.asarray(x.float().numpy()),
                                    jnp.asarray(tg), jnp.asarray(in_l),
                                    jnp.asarray(tl), reduction="none"))
    np.testing.assert_allclose(per.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_alignment_and_boundaries_equal_jax(seed):
    lp, tg, in_l, tl = _ctc_case(seed, B=5, T=40, K=7, L=8)
    in_l = np.array([1.0, 0.9, 0.85, 0.5, 0.35], np.float32)
    assert ctc.ctc_greedy_decode(lp, in_l) == \
        jctc.ctc_greedy_decode(lp, in_l)
    assert ctc.ctc_greedy_decode(lp, in_l, blank_id=3) == \
        jctc.ctc_greedy_decode(lp, in_l, blank_id=3)
    for i in range(lp.shape[0]):
        n = int(round(float(in_l[i]) * lp.shape[1]))
        for labels in (list(tg[i, :4]), [2, 2, 5], [3]):
            np.testing.assert_array_equal(
                ctc.ctc_forced_alignment(lp[i, :n], labels),
                jctc.ctc_forced_alignment(lp[i, :n], labels))
            np.testing.assert_array_equal(
                ctc.ctc_segmentation_boundaries(lp[i, :n], labels),
                jctc.ctc_segmentation_boundaries(lp[i, :n], labels))


# ---------------------------------------------------------------------------
# (b) Adadelta and SGD against optax, and through the train step
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adadelta": (lambda: joptim.Adadelta(lr=1.0, rho=0.95, eps=1e-8),
                 lambda: optim.Adadelta(lr=1.0, rho=0.95, eps=1e-8),
                 {"e_g": "inner_state[1].e_g", "e_x": "inner_state[1].e_x"}),
    "adadelta_defaults": (lambda: joptim.Adadelta(), lambda: optim.Adadelta(),
                          {"e_g": "inner_state[1].e_g",
                           "e_x": "inner_state[1].e_x"}),
    "sgd": (lambda: joptim.SGD(lr=0.05), lambda: optim.SGD(lr=0.05), {}),
    "sgd_momentum": (lambda: joptim.SGD(lr=0.05, momentum=0.9),
                     lambda: optim.SGD(lr=0.05, momentum=0.9),
                     {"trace": "inner_state[0].trace"}),
}


def _moment(jstate, path, names, mk=None):
    """A moment of an injected optax state by its inner path, flattened in
    the order of ``names`` as the port keeps it."""
    idx, field = path.split(".")
    tree = getattr(jstate.inner_state[int(idx[12:-1])], field)
    tree = tree if mk is None else tree[mk]
    return np.concatenate([np.asarray(tree[n]).reshape(-1) for n in names])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    make_j, make_p, moments = OPTIMIZERS[name]
    rs = np.random.RandomState(0)
    params = {"b": rs.randn(5).astype(np.float32),
              "w": rs.randn(6, 5).astype(np.float32)}
    opt_j = make_j().make()
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state_j = opt_j.init(p_j)
    opt = make_p()
    assert opt.MOMENTS == moments
    p = [torch.from_numpy(params[k].copy()) for k in ("b", "w")]
    state = opt.init(p)
    for step in range(5):
        g = {"b": (rs.randn(5) * 10.0 ** rs.randint(-6, 1, 5)).astype(
            np.float32), "w": rs.randn(6, 5).astype(np.float32)}
        g["b"][0] = 0.0
        upd, state_j = opt_j.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    state_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        opt.step(p, torch.from_numpy(np.concatenate(
            [g["b"], g["w"].reshape(-1)])), state)
        for k, t in zip(("b", "w"), p):
            np.testing.assert_allclose(t.numpy(), np.asarray(p_j[k]),
                                       rtol=OPT_RTOL, atol=0, err_msg=k)
        assert int(state["count"]) == int(state_j.count) == step + 1
        for key, path in moments.items():
            np.testing.assert_allclose(
                state[key].numpy(), _moment(state_j, path, ["b", "w"]),
                rtol=OPT_RTOL, err_msg=key)
    assert {k: float(np.float32(v)) for k, v in opt.hyperparams().items()} \
        == {k: float(v) for k, v in state_j.hyperparams.items()}


class _JaxTiny(JaxBrain):
    def compute_forward(self, params, states, batch, stage, rng, epoch):
        x = batch["x"]
        return {"y": self.modules["a"].apply(params["a"], x),
                "z": self.modules["b"].apply(params["b"], x)}, states

    def compute_objectives(self, preds, batch, stage):
        loss = jnp.mean(jnp.square(preds["y"])) + 0.0 * jnp.mean(preds["z"])
        return loss, {"loss": loss}


class _Tiny(MDModel):
    max_grad_norm = 0.5

    def __init__(self, opt):
        super().__init__({"optimizer": opt})
        self.a, self.b, self.c = Linear(3, 2), Linear(3, 2), Linear(3, 2)

    def compute_forward(self, batch, noise=None, generator=None,
                        train=False, epoch=1):
        return {"y": self.a(batch["x"]), "z": self.b(batch["x"])}

    def compute_objectives(self, preds, batch):
        loss = (preds["y"] ** 2).mean() + 0.0 * preds["z"].mean()
        return loss, {"loss": loss}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_train_step_rules_and_checkpoint_tree_match_jax(name):
    """Three steps of both train steps (a clipped batch, a batch holding a
    NaN, another batch): the parameters after each, the non-finite step
    leaving every parameter and state as it was, modules b (zero grads)
    and c (never reached) never advancing, and the checkpoint tree of the
    optimizer states: the JAX checkpointer's keys, equal values."""
    make_j, make_p, _ = OPTIMIZERS[name]
    rs = np.random.RandomState(1)
    xs = [(rs.randn(4, 3) * 20).astype(np.float32) for _ in range(3)]
    xs[1][2, 1] = np.nan
    jb = _JaxTiny(modules={k: JaxLinear(3, 2) for k in "abc"},
                  hparams={"optimizer": make_j()},
                  run_opts={"max_grad_norm": 0.5})
    jb.init_params()
    jb.init_optimizers()
    tiny = _Tiny(make_p())
    tiny.load_state_dict(from_jax(jax.device_get(jb.params)))
    tiny.init_optimizers()
    step = jax.jit(jb._make_train_step_raw())
    p, o = jb.params, jb.opt_states
    for i, x in enumerate(xs):
        before = {k: v.clone() for k, v in tiny.state_dict().items()}
        tree_before = tiny._opt_tree("optimizer")
        p, o, _, loss, _ = step(p, o, {}, jax.random.PRNGKey(i), {"x": x}, 1)
        t_loss, _ = tiny.fit_batch({"x": torch.from_numpy(x)}, 1)
        want = from_jax(jax.device_get(p))
        for k, v in tiny.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=RTOL, atol=1e-7, err_msg=k)
        j_tree = jax_flatten(jax.device_get(o["optimizer"]))
        tree = tiny._opt_tree("optimizer")
        assert sorted(tree) == sorted(j_tree)
        for k, v in j_tree.items():
            assert tree[k].dtype == v.dtype and tree[k].shape == v.shape, k
            np.testing.assert_allclose(tree[k], v, rtol=RTOL, atol=1e-9,
                                       err_msg=k)
        if i == 1:   # the non-finite step
            assert not np.isfinite(float(loss)) and \
                not np.isfinite(float(t_loss))
            for k, v in tiny.state_dict().items():
                assert torch.equal(v, before[k]), k
            for k, v in tree.items():
                np.testing.assert_array_equal(v, tree_before[k], err_msg=k)
    counts = {mk: int(st["count"]) for mk, st in
              tiny.opt_states["optimizer"].items()}
    assert counts == {"a": 2, "b": 0, "c": 0}
    # a fresh model restores the states from the tree
    other = _Tiny(make_p())
    other.init_optimizers()
    other._set_opt_tree("optimizer", tiny._opt_tree("optimizer"))
    for mk, st in other.opt_states["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(v, tiny.opt_states["optimizer"][mk][k])


# ---------------------------------------------------------------------------
# (c) error rates, alignment, the scheduler and the resampling
# ---------------------------------------------------------------------------

def _seqs(seed, n=7):
    rs = np.random.RandomState(seed)
    gt = [list(rs.randint(1, 6, rs.randint(1, 9))) for _ in range(n)]
    pred = [list(rs.randint(1, 6, rs.randint(0, 10))) for _ in range(n)]
    cn = [[x if rs.rand() < 0.8 else int(rs.randint(1, 6)) for x in g]
          for g in gt]
    return gt, pred, cn


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alignment_and_error_rates_equal_jax(seed):
    gt, pred, cn = _seqs(seed)
    assert batch_align_sequences(gt, pred, cn) == \
        jax_batch_align(gt, pred, cn)
    assert batch_align_sequences(gt, pred, cn, empty_value=-7) == \
        jax_batch_align(gt, pred, cn, empty_value=-7)
    L = max(len(g) for g in gt)
    padded = np.zeros((len(gt), L), np.int64)
    for i, g in enumerate(gt):
        padded[i, :len(g)] = g
    lens = np.array([len(g) / L for g in gt], np.float32)
    ids = [f"u{i}" for i in range(len(gt))]
    labels = {i: f"p{i}" for i in range(5)}   # 5 has no label: <unk:5>
    ind2lab = lambda seq: [labels[int(x)] for x in seq]  # noqa: E731
    port, ref = ErrorRateStats(), JaxErrorRateStats()
    for stats in (port, ref):
        stats.append(ids=ids, predict=pred, target=padded, target_len=lens,
                     ind2lab=ind2lab)
        stats.append(ids=ids[:2], predict=pred[:2],
                     target=[np.asarray(g) for g in gt[:2]])
    assert port.summarize() == ref.summarize()
    assert port.summarize("error_rate") == ref.summarize("error_rate")
    a, b = io.StringIO(), io.StringIO()
    port.write_stats(a)
    ref.write_stats(b)
    assert a.getvalue() == b.getvalue()
    # targets as tensors (the port's device batches) score the same
    tensor_stats = ErrorRateStats()
    tensor_stats.append(ids=ids, predict=pred,
                        target=torch.from_numpy(padded),
                        target_len=torch.from_numpy(lens))
    assert tensor_stats.details[0]["ref"] == ref.details[0]["ref"]
    with pytest.raises(ValueError):
        ErrorRateStats().summarize()


def test_newbob_scheduler_equals_jax():
    series = [10.0, 9.0, 8.99, 8.98, 9.5, 7.0, 6.99, 6.98, 0.0, 0.0, 3.0]
    for patient in (0, 1, 2):
        port = NewBobScheduler(1.0, improvement_threshold=0.0025,
                               annealing_factor=0.8, patient=patient)
        ref = JaxNewBob(1.0, improvement_threshold=0.0025,
                        annealing_factor=0.8, patient=patient)
        for v in series:
            assert port(v) == ref(v)
            assert port.state_dict() == ref.state_dict()
        fresh = NewBobScheduler(0.5, improvement_threshold=0.0025,
                                annealing_factor=0.8, patient=patient)
        fresh.load_state_dict(port.state_dict())
        assert fresh.state_dict() == port.state_dict()
        assert fresh(5.0) == ref(5.0)


@pytest.mark.parametrize("src_len, target_len", [(12, 24), (12, 25),
                                                 (12, 26), (10, 33),
                                                 (7, 7), (13, 27)])
def test_resample_by_factor_equals_jax(src_len, target_len):
    x = np.random.RandomState(src_len).randn(3, src_len, 4).astype(
        np.float32)
    np.testing.assert_array_equal(resample_by_factor_np(x, target_len),
                                  jax_resample(x, target_len))
    y = np.moveaxis(x, 1, 0)
    np.testing.assert_array_equal(
        resample_by_factor_np(y, target_len, axis=0),
        jax_resample(y, target_len, axis=0))


@pytest.mark.parametrize("src_len, target_len", [(12, 5), (10, 39)])
def test_resample_by_factor_guard_raises(src_len, target_len):
    x = np.zeros((2, src_len, 3), np.float32)
    for fn in (resample_by_factor_np, jax_resample):
        with pytest.raises(ValueError):
            fn(x, target_len)
