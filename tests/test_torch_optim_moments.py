"""Adam with its moments kept in a reduced dtype (``moment_dtype``, or
``MLVAE_OPT_MOMENT_DTYPE``), against the JAX package's
``OptimizerFactory.make`` (``mlvae_tpu/training/optim.py:20-62,80-86``) on
the CPU:

* five steps with bf16 moments: the moments bit-equal to the JAX state's
  after every step, the parameters bit-equal too;
* the environment variable selects it where the argument is absent, as
  in the JAX package, and float32 keeps ``optax.adam``;
* the checkpoint's optimizer tree: the JAX state's keys and hyperparameters
  (no ``eps_root``), the moments in bf16 as the JAX checkpointer writes
  them (``|V2``), byte-equal, and read back bit-equal."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.training.checkpointer import _flatten as jax_flatten
from mlvae_tpu.training.optim import Adam as JaxAdam

from mlvae_tpu_torch.models.md_model import MDModel
from mlvae_tpu_torch.training.optim import Adam

SHAPES = {"weight": (8, 16), "bias": (8,)}


def _params():
    rs = np.random.RandomState(0)
    return {k: (rs.randn(*s) * 0.1).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(i):
    rs = np.random.RandomState(100 + i)
    return {k: (rs.randn(*s) * 0.01).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(tree):
    return torch.cat([torch.from_numpy(np.asarray(tree[k], np.float32))
                      .reshape(-1) for k in SHAPES])


def _bits(t):
    return t.view(torch.int16).numpy()


def _jax_bits(a):
    return np.asarray(a).view(np.int16)


def test_bf16_moments_bit_equal_to_jax():
    factory = JaxAdam(lr=1e-3)
    factory.kwargs["moment_dtype"] = "bfloat16"
    jopt = factory.make()
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    jst = jopt.init(jp)

    opt = Adam(lr=1e-3, moment_dtype="bfloat16")
    ps = [torch.from_numpy(_params()[k].copy()) for k in SHAPES]
    st = opt.init(ps)
    assert st["mu"].dtype == st["nu"].dtype == torch.bfloat16
    for i in range(5):
        g = _grads(i)
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        opt.step(ps, _flat(g), st)
        inner = jst.inner_state[0]
        assert int(st["count"]) == int(inner.count) == i + 1
        for key in ("mu", "nu"):
            want = np.concatenate([_jax_bits(getattr(inner, key)[k])
                                   .reshape(-1) for k in SHAPES])
            np.testing.assert_array_equal(_bits(st[key]), want)
        for p, k in zip(ps, SHAPES):
            np.testing.assert_array_equal(p.numpy(), np.asarray(jp[k]))


def test_environment_selects_the_moment_dtype(monkeypatch):
    monkeypatch.setenv("MLVAE_OPT_MOMENT_DTYPE", "bfloat16")
    assert Adam().moment_dtype == torch.bfloat16
    assert Adam(moment_dtype="float32").moment_dtype == torch.float32
    assert "eps_root" not in Adam().hyperparams()
    monkeypatch.setenv("MLVAE_OPT_MOMENT_DTYPE", "float32")
    assert Adam().moment_dtype == torch.float32
    assert "eps_root" in Adam().hyperparams()
    monkeypatch.delenv("MLVAE_OPT_MOMENT_DTYPE")
    assert Adam().init([torch.zeros(3)])["mu"].dtype == torch.float32
    with pytest.raises(ValueError, match="moment_dtype"):
        Adam(moment_dtype="int8")


class _Tiny(MDModel):
    def __init__(self, opt):
        super().__init__({"optimizer": opt})
        self.lin = torch.nn.Linear(16, 8)


def _npz(tmp_path, flat):
    path = tmp_path / "opt.npz"
    np.savez(path, **flat)
    return path


def test_checkpoint_tree_in_the_jax_layout_and_dtype(tmp_path):
    factory = JaxAdam(lr=1e-3)
    factory.kwargs["moment_dtype"] = "bfloat16"
    jopt = factory.make()
    jp = {"lin": {k: jnp.asarray(v) for k, v in _params().items()}}
    jst = jopt.init(jp["lin"])
    model = _Tiny(Adam(lr=1e-3, moment_dtype="bfloat16"))
    with torch.no_grad():
        for k, v in _params().items():
            getattr(model.lin, k).copy_(torch.from_numpy(v))
    model.init_optimizers()
    st = model.opt_states["optimizer"]["lin"]
    ps = list(model.lin.parameters())
    names = [n for n, _ in model.lin.named_parameters()]
    for i in range(3):
        g = _grads(i)
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jp["lin"])
        model.optimizers["optimizer"][0].step(
            ps, torch.cat([torch.from_numpy(g[n]).reshape(-1)
                           for n in names]), st)
    want = {f"['lin']{k}": v for k, v in
            jax_flatten(jax.tree_util.tree_map(
                lambda a: a, {"x": jst})).items()}
    want = {k.replace("['lin']['x']", "['lin']"): v for k, v in want.items()}
    want = {k.replace(".mu['", ".mu['lin']['").replace(
        ".nu['", ".nu['lin']['"): v for k, v in want.items()}
    got = model._opt_tree("optimizer")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype or (
            got[k].dtype.str == "|V2" and v.dtype.name == "bfloat16"), k
        assert got[k].tobytes() == np.asarray(v).tobytes(), k
    # the tree as an npz round trip reads back bit-equal
    before = {k: st[k].clone() for k in ("mu", "nu")}
    path = _npz(tmp_path, got)
    st["mu"].zero_()
    st["nu"].zero_()
    with np.load(path) as saved:
        model._set_opt_tree("optimizer", {k: saved[k] for k in saved.files})
    for k in ("mu", "nu"):
        np.testing.assert_array_equal(_bits(st[k]), _bits(before[k]))
