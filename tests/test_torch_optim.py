"""The port's Adam against ``optax.adam`` as the JAX package builds it, and
the port's train-step rules against the JAX train step on a tiny model of
three modules: one trained, one that autograd reaches with exactly zero
grads, and one it never reaches. The step clips at ``max_grad_norm``; a
non-finite loss leaves parameters and optimizer states untouched; a
module with all-zero grads advances neither its Adam count nor its
parameters. Tolerance rtol 1e-6 (Adam on the same numbers, f32 in both,
only ``b1 ** count`` computed by another library), 1e-5 for the tiny
model's trajectory (its gradients are sums in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mlvae_tpu.nn.layers import Linear as JaxLinear
from mlvae_tpu.training.brain import Brain as JaxBrain
from mlvae_tpu.training.brain import Stage
from mlvae_tpu.training.optim import Adam as JaxAdam

from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.models.md_model import MDModel
from mlvae_tpu_torch.nn.layers import Linear
from mlvae_tpu_torch.training.optim import Adam

torch.set_num_threads(2)

MAX_NORM = 0.5


def _adam_state(jstate, names, mk=None):
    """(count, mu, nu) of an injected optax Adam state (of module ``mk``),
    the moments flattened in the order of the dotted parameter ``names``,
    as the port keeps them."""
    inner = jstate.inner_state[0]
    out = []
    for tree in (inner.mu, inner.nu):
        tree = tree if mk is None else tree[mk]
        leaves = []
        for name in names:
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            leaves.append(np.asarray(leaf).reshape(-1))
        out.append(np.concatenate(leaves))
    return int(inner.count), out[0], out[1]


def test_adam_matches_optax():
    rs = np.random.RandomState(0)
    params = {"b": rs.randn(5).astype(np.float32),
              "w": rs.randn(6, 5).astype(np.float32)}
    opt_j = JaxAdam(lr=1e-3).make()
    state_j = opt_j.init(jax.tree_util.tree_map(jnp.asarray, params))
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt = Adam(lr=1e-3)
    p = [torch.from_numpy(params[k].copy()) for k in ("b", "w")]
    state = opt.init(p)
    for step in range(5):
        # a zero and a tiny gradient entry exercise eps
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
                                       rtol=1e-6, atol=0, err_msg=k)
        count, mu, nu = _adam_state(state_j, ["b", "w"])
        assert int(state["count"]) == count == step + 1
        np.testing.assert_allclose(state["mu"].numpy(), mu, rtol=1e-6)
        np.testing.assert_allclose(state["nu"].numpy(), nu, rtol=1e-6)


class _JaxTiny(JaxBrain):
    def compute_forward(self, params, states, batch, stage, rng, epoch):
        x = batch["x"]
        y = self.modules["a"].apply(params["a"], x)
        z = self.modules["b"].apply(params["b"], x)
        return {"y": y, "z": z}, states

    def compute_objectives(self, preds, batch, stage):
        loss = jnp.mean(jnp.square(preds["y"])) + 0.0 * jnp.mean(preds["z"])
        return loss, {"loss": loss}


class _Tiny(MDModel):
    max_grad_norm = MAX_NORM

    def __init__(self):
        super().__init__({"optimizer": Adam(lr=0.01)})
        self.a, self.b, self.c = Linear(3, 2), Linear(3, 2), Linear(3, 2)

    def compute_forward(self, batch, noise=None, generator=None,
                        train=False, epoch=1):
        return {"y": self.a(batch["x"]), "z": self.b(batch["x"])}

    def compute_objectives(self, preds, batch):
        loss = (preds["y"] ** 2).mean() + 0.0 * preds["z"].mean()
        return loss, {"loss": loss}


@pytest.fixture(scope="module")
def trajectories():
    """The port's initial weights, then three steps of both: a large batch
    (clipped), a batch holding a NaN (non-finite), another large batch."""
    rs = np.random.RandomState(1)
    xs = [(rs.randn(4, 3) * 20).astype(np.float32) for _ in range(3)]
    xs[1][2, 1] = np.nan
    jb = _JaxTiny(modules={"a": JaxLinear(3, 2), "b": JaxLinear(3, 2),
                           "c": JaxLinear(3, 2)},
                  hparams={"optimizer": JaxAdam(lr=0.01)},
                  run_opts={"max_grad_norm": MAX_NORM})
    jb.init_params()
    jb.init_optimizers()
    tiny = _Tiny()
    tiny.load_state_dict(from_jax(jax.device_get(jb.params)))
    tiny.init_optimizers()
    step = jax.jit(jb._make_train_step_raw())
    p, o = jb.params, jb.opt_states
    out = [{k: v.detach().clone() for k, v in tiny.state_dict().items()}]
    for i, x in enumerate(xs):
        gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in
                                   jax.tree_util.tree_leaves(jax.grad(
                                       lambda pp: jb.compute_objectives(
                                           jb.compute_forward(
                                               pp, {}, {"x": x}, Stage.TRAIN,
                                               None, 1)[0], None,
                                           Stage.TRAIN)[0])(p)))))
        p, o, _, loss, _ = step(p, o, {}, jax.random.PRNGKey(i), {"x": x}, 1)
        t_loss, _ = tiny.fit_batch({"x": torch.from_numpy(x)}, 1)
        out.append((gnorm, jax.device_get(p), jax.device_get(o), float(loss),
                    float(t_loss), {k: v.detach().clone() for k, v in
                                    tiny.state_dict().items()},
                    {mk: {k: v.clone() for k, v in s.items()} for mk, s in
                     tiny.opt_states["optimizer"].items()},
                    {n: (None if q.grad is None else q.grad.clone())
                     for n, q in tiny.named_parameters()}))
    return out


def _assert_same_state(j_params, j_opt, t_params, t_opt):
    want = from_jax(j_params)
    for k, v in t_params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for mk, st in t_opt.items():
        count, mu, nu = _adam_state(j_opt["optimizer"][mk],
                                    ["weight", "bias"], mk)
        assert int(st["count"]) == count, mk
        np.testing.assert_allclose(st["mu"].numpy(), mu, rtol=1e-5,
                                   atol=1e-9, err_msg=mk)
        np.testing.assert_allclose(st["nu"].numpy(), nu, rtol=1e-5,
                                   atol=1e-12, err_msg=mk)


def test_train_step_clips_at_max_grad_norm(trajectories):
    gnorm, j_p, j_o, j_loss, t_loss, t_p, t_o, t_g = trajectories[1]
    assert gnorm > 10 * MAX_NORM              # the clip is engaged
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    applied = torch.cat([t_g[n].reshape(-1) for n in ("a.weight", "a.bias")])
    np.testing.assert_allclose(float(applied.norm()), MAX_NORM, rtol=1e-5)
    _assert_same_state(j_p, j_o, t_p, t_o)


def test_non_finite_step_leaves_state_untouched(trajectories):
    before, after = trajectories[1], trajectories[2]
    assert not np.isfinite(after[3]) and not np.isfinite(after[4])
    for k, v in after[5].items():
        assert torch.equal(v, before[5][k]), k
    for mk, st in after[6].items():
        for k, v in st.items():
            assert torch.equal(v, before[6][mk][k]), (mk, k)
    # the grads as applied were replaced by zeros, not scaled
    assert all(g is None or not g.any() for g in after[7].values())
    _assert_same_state(after[1], after[2], after[5], after[6])


def test_all_zero_grad_module_is_skipped(trajectories):
    init, last = trajectories[0], trajectories[3]
    _assert_same_state(last[1], last[2], last[5], last[6])
    counts = {mk: int(st["count"]) for mk, st in last[6].items()}
    assert counts == {"a": 2, "b": 0, "c": 0}
    # b was reached with exactly zero grads, c never
    assert last[7]["b.weight"] is not None and not last[7]["b.weight"].any()
    assert last[7]["c.weight"] is None
    for mod in ("b", "c"):
        for k in ("weight", "bias"):
            key = f"{mod}.{k}"
            assert torch.equal(last[5][key], init[key]), key
