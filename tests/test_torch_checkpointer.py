"""The port's checkpointer against ``mlvae_tpu.training.checkpointer``:
``find_checkpoint`` picks the same directory by ``max_key``, by
``min_key``, on ties (the newest) and without its key (the newest, with a
warning); ``save_and_keep_only`` keeps the same set; and each package reads
the other's checkpoints of the MD_VAE recipe (narrow widths): parameters,
the normalizer's statistics and the Adam states, bit for bit."""
import json
import warnings

import numpy as np
import pytest
import torch

import jax

from mlvae_tpu.models.MD_VAE.model import SBModel as JaxSBModel
from mlvae_tpu.training.checkpointer import Checkpointer as JaxCheckpointer

from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.models.MD_VAE.model import SBModel
from mlvae_tpu_torch.training.brain import check_run_opts
from mlvae_tpu_torch.training.checkpointer import (CheckpointKeyMismatch,
                                                   Checkpointer)
from test_torch_yaml import _run_yaml

torch.set_num_threads(2)

BLOB = {"params": {"['w']": np.arange(3, dtype=np.float32)}}
SCENARIOS = {
    "distinct": [{"F1": 1.0}, {"F1": 3.0}, {"F1": 2.0}],
    "ties": [{"F1": 2.0}, {"F1": 2.0}, {"F1": 1.0}, {"F1": 2.0}],
    "all_tied": [{"F1": 0.0}] * 4,
    "partly_keyed": [{"F1": 5.0}, {}, {"F1": 4.0}, {}],
}


def _write(root, metas):
    """Checkpoints with these metas, unixtime 100, 101, ... in order."""
    ck = JaxCheckpointer(root)
    for i, meta in enumerate(metas):
        ck.save_checkpoint({"params": {"w": np.arange(3.0)}},
                           dict(meta, unixtime=100.0 + i))
    return ck


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("key", [("max_key", "F1"), ("min_key", "F1"),
                                 ("max_key", "absent"), (None, None)])
def test_find_checkpoint_matches_jax(tmp_path, scenario, key):
    jck = _write(tmp_path, SCENARIOS[scenario])
    pck = Checkpointer(tmp_path)
    kw = {key[0]: key[1]} if key[0] else {}
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jck.find_checkpoint(**kw)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = pck.find_checkpoint(**kw)
    assert got.path == want.path
    assert got.meta == want.meta
    assert pck.last_selection_fell_back == jck.last_selection_fell_back
    assert len(pw) == len(jw)
    if key[1] == "absent":
        assert pck.last_selection_fell_back


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("rule", [
    {"max_keys": ["F1"]}, {"min_keys": ["F1"]},
    {"max_keys": ["F1"], "min_keys": ["loss"]},
    {"max_keys": ["F1"], "num_to_keep": 2},
    {"max_keys": ["F1"], "keep_recent": False}])
def test_keep_only_pruning_matches_jax(tmp_path, scenario, rule):
    """The same saves, one after the other, keep the same checkpoints."""
    kept = {}
    for name, ck in (("jax", JaxCheckpointer(tmp_path / "jax")),
                     ("port", Checkpointer(tmp_path / "port"))):
        state = {"params": {"w": np.arange(3.0)}} if name == "jax" else BLOB
        for i, meta in enumerate(SCENARIOS[scenario]):
            meta = dict(meta, unixtime=100.0 + i, loss=float(i % 2))
            ck.save_and_keep_only(state, meta=meta, **rule)
        kept[name] = sorted(c.meta["unixtime"] for c in ck.list_checkpoints())
    assert kept["port"] == kept["jax"] and kept["port"]


def test_async_saves_and_other_backends_are_refused(tmp_path):
    """``--async_ckpt`` raises at the Brain's run options; the checkpointer
    takes no save-mode or backend argument, so a recipe that names one
    fails at construction."""
    with pytest.raises(NotImplementedError, match="item 12"):
        check_run_opts({"async_ckpt": True})
    for key, value in (("async_save", True), ("backend", "orbax")):
        with pytest.raises(TypeError, match=key):
            Checkpointer(tmp_path, **{key: value})


def test_layout_and_shape_mismatches_raise(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save_checkpoint(BLOB, {"F1": 1.0})
    ckpt = ck.find_checkpoint()
    with pytest.raises(CheckpointKeyMismatch):
        ck.load_checkpoint(ckpt, {"params": {"['v']": np.zeros(3)}})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.load_checkpoint(ckpt, {"params": {"['w']": np.zeros(4)}})
    out = ck.load_checkpoint(ckpt, {"params": {"['w']": np.zeros(3)},
                                    "absent": {}})
    assert list(out) == ["params"]
    np.testing.assert_array_equal(out["params"]["['w']"], np.arange(3))
    assert json.loads((ckpt.path / "meta.json").read_text())["F1"] == 1.0
    restored, found = ck.recover_if_possible(
        {"params": {"['w']": np.zeros(3, np.float64)}}, max_key="F1")
    assert found.path == ckpt.path
    assert restored["params"]["['w']"].dtype == np.float64
    assert Checkpointer(tmp_path / "empty").recover_if_possible({}) == \
        (None, None)


@pytest.fixture(scope="module")
def models():
    jh, ph = _run_yaml(True), _run_yaml(False)
    jm = JaxSBModel(modules=jh["model"]["modules"], hparams=jh["model"],
                    run_opts={}, checkpointer=None, label_encoder=None)
    jm.init_params()
    jm.ensure_states(jh["model"]["input_size"])
    jm.init_optimizers()
    pm = SBModel(modules=ph["model"]["modules"], hparams=ph["model"],
                 run_opts={}, device="cpu")
    pm.init_optimizers()
    return jm, pm


def _randomize_jax(jm, seed):
    """Every float leaf of the JAX model's state random, Adam counts 5."""
    rs = np.random.RandomState(seed)

    def rand(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return np.full(x.shape, 5, np.int32)
        if x.ndim == 0:     # hyperparameters and the normalizer's count
            return x
        return rs.randn(*x.shape).astype(x.dtype)
    jm.params = jax.tree_util.tree_map(rand, jm.params)
    jm.states = jax.tree_util.tree_map(rand, jm.states)
    jm.opt_states = jax.tree_util.tree_map(rand, jm.opt_states)


def _jax_adam(jm, mk, names):
    inner = jm.opt_states["optimizer"][mk].inner_state[0]
    out = {}
    for moment in ("mu", "nu"):
        leaves = []
        for name in names:
            leaf = getattr(inner, moment)[mk]
            for part in name.split("."):
                leaf = leaf[part]
            leaves.append(np.asarray(leaf).reshape(-1))
        out[moment] = np.concatenate(leaves)
    return int(inner.count), out


def test_port_reads_a_jax_checkpoint(models, tmp_path):
    jm, pm = models
    _randomize_jax(jm, 1)
    jck = JaxCheckpointer(tmp_path)
    jck.save_and_keep_only(jm._checkpoint_state(),
                           meta={"plvl_md.F1": 12.5, "epoch": 3},
                           max_keys=["plvl_md.F1"])
    pm.checkpointer = Checkpointer(tmp_path)
    pm.hparams["epoch_counter"].current = 0
    pm._restore(pm.checkpointer.find_checkpoint(max_key="plvl_md.F1"),
                with_opt=True)
    assert pm.hparams["epoch_counter"].current == 3
    want = from_jax(jax.device_get(jm.params), jax.device_get(jm.states))
    got = pm.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for mk, mod in pm.param_modules().items():
        names = [n for n, _ in mod.named_parameters()]
        count, moments = _jax_adam(jm, mk, names)
        st = pm.opt_states["optimizer"][mk]
        assert int(st["count"]) == count == 5
        for moment in ("mu", "nu"):
            np.testing.assert_array_equal(st[moment].numpy(),
                                          moments[moment], err_msg=mk)


def test_jax_reads_a_port_checkpoint(models, tmp_path):
    jm, pm = models
    rs = np.random.RandomState(2)
    with torch.no_grad():
        for p in pm.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)))
        pm.normalizer.glob_mean.copy_(torch.from_numpy(
            rs.randn(pm.normalizer.feat_dim).astype(np.float32)))
        pm.normalizer.count.fill_(7.0)
        for st in pm.opt_states["optimizer"].values():
            st["count"].fill_(3)
            for moment in ("mu", "nu"):
                st[moment].copy_(torch.from_numpy(
                    rs.rand(st[moment].numel()).astype(np.float32)))
    pm.checkpointer = Checkpointer(tmp_path)
    pm.checkpointer.save_and_keep_only(
        pm.checkpoint_state(), meta={"plvl_md.F1": 1.0, "epoch": 2},
        max_keys=["plvl_md.F1"])
    jck = JaxCheckpointer(tmp_path)
    restored, ckpt = jck.recover_if_possible(jm._checkpoint_templates(),
                                             max_key="plvl_md.F1")
    assert ckpt.meta["epoch"] == 2
    want = pm.state_dict()
    got = from_jax(restored["params"], restored["states"])
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    jm.opt_states = {"optimizer": restored["opt__optimizer"]}
    for mk, mod in pm.param_modules().items():
        names = [n for n, _ in mod.named_parameters()]
        count, moments = _jax_adam(jm, mk, names)
        st = pm.opt_states["optimizer"][mk]
        assert count == int(st["count"]) == 3
        assert int(restored["opt__optimizer"][mk].count) == 3
        for moment in ("mu", "nu"):
            np.testing.assert_array_equal(moments[moment],
                                          st[moment].numpy(), err_msg=mk)
