"""The port's checkpointer against ``mlvae_tpu.training.checkpointer``:
``find_checkpoint`` picks the same directory by ``max_key``, by
``min_key``, on ties (the newest) and without its key (the newest, with a
warning); ``save_and_keep_only`` keeps the same set; and each package reads
the other's checkpoints of the MD_VAE recipe (narrow widths): parameters,
the normalizer's statistics and the Adam states, bit for bit.

The worker-thread saver (``--async_ckpt``): the cases of
``tests/test_async_ckpt.py`` on the port's checkpointer (every thread wait
bounded), a snapshot's copy that a later in-place update does not reach,
the stream fence of ``wait_device_release``, and async saves of the
recipe's state writing the files a synchronous save writes. The resume
after an optimizer-state layout change (the JAX ``MDModel.on_fit_start``
fallback, ``tests/test_resume.py``): fresh moments and a warning, while a
parameter mismatch still raises."""
import json
import logging
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import jax

from mlvae_tpu.models.MD_VAE.model import SBModel as JaxSBModel
from mlvae_tpu.training.checkpointer import Checkpointer as JaxCheckpointer

from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.models.MD_VAE.model import SBModel
from mlvae_tpu_torch.training.brain import Brain
from mlvae_tpu_torch.training.checkpointer import (CheckpointKeyMismatch,
                                                   Checkpointer,
                                                   DeviceSnapshot)
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
    """``--async_ckpt`` reaches the checkpointer through the Brain's run
    options (``async_save``, as the JAX Brain sets it); the orbax backend
    is not ported, so a recipe that names one fails at construction."""
    ck = Checkpointer(tmp_path)
    assert ck.async_save is False
    Brain({}, run_opts={"async_ckpt": True}, checkpointer=ck)
    assert ck.async_save is True
    assert Checkpointer(tmp_path, async_save=True).async_save is True
    with pytest.raises(TypeError, match="backend"):
        Checkpointer(tmp_path, backend="orbax")


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


# -- the worker-thread saver (tests/test_async_ckpt.py on the port) ----------
WAIT = 10.0   # seconds: the bound of every thread wait below


def _state(v):
    return {"params": {"['w']": np.full((4, 4), float(v), np.float32)}}


def _gated(ck, fail_epoch=None):
    """Stall the worker's saves at a gate (and fail one epoch's)."""
    gate = threading.Event()
    orig = ck._save_and_prune

    def slow(state, meta, *rest):
        assert gate.wait(timeout=WAIT)
        if meta.get("epoch") == fail_epoch:
            raise OSError("disk full")
        orig(state, meta, *rest)
    ck._save_and_prune = slow
    return gate


def _queued(ck, which="_queue"):
    with ck._cv:
        return [m["epoch"] for (_, m, *_r) in getattr(ck, which)]


def _until(pred):
    """Wait (bounded) until the worker reaches a state."""
    t0 = time.time()
    while not pred():
        assert time.time() - t0 < WAIT, "the worker did not get there"
        time.sleep(0.01)


def test_async_saves_persist_and_prune_like_sync(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    for epoch, f1 in enumerate([10.0, 30.0, 20.0], start=1):
        ck.save_and_keep_only(_state(epoch), meta={"F1": f1, "epoch": epoch},
                              max_keys=["F1"])
    ck.flush()
    best = ck.find_checkpoint(max_key="F1")
    assert best.meta["F1"] == 30.0
    assert ck.find_checkpoint().meta["epoch"] == 3
    restored = ck.load_checkpoint(best, templates=_state(0))
    assert restored["params"]["['w']"][0, 0] == 2.0
    ck.close()


def test_supersede_drop_never_loses_best(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    gate = _gated(ck)
    ck.save_and_keep_only(_state(1), meta={"F1": 5.0, "epoch": 1},
                          max_keys=["F1"])
    _until(lambda: ck._inflight_meta is not None)   # save 1 in flight
    for epoch, f1 in ((2, 50.0), (3, 7.0), (4, 6.0)):
        ck.save_and_keep_only(_state(epoch), meta={"F1": f1, "epoch": epoch},
                              max_keys=["F1"])
    queued = _queued(ck)
    assert 2 in queued and 3 not in queued and queued[-1] == 4
    gate.set()
    ck.flush()
    assert ck.find_checkpoint(max_key="F1").meta["F1"] == 50.0
    assert ck.find_checkpoint().meta["epoch"] == 4
    ck.close()


def test_no_keys_supersede_drops_intermediates(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    gate = _gated(ck)
    for epoch in range(1, 5):
        ck.save_and_keep_only(_state(epoch), meta={"epoch": epoch})
    queued = _queued(ck)
    assert queued[-1] == 4 and len(queued) <= 2
    gate.set()
    ck.flush()
    assert ck.find_checkpoint().meta["epoch"] == 4
    ck.close()


def test_worker_error_surfaces_on_flush(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    ck._save_and_prune = lambda *a: (_ for _ in ()).throw(
        OSError("disk full"))
    ck.save_and_keep_only(_state(1), meta={"epoch": 1})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.flush()
    ck.close()


def test_find_checkpoint_drains_pending(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    ck.save_and_keep_only(_state(1), meta={"F1": 9.0, "epoch": 1},
                          max_keys=["F1"])
    assert ck.find_checkpoint(max_key="F1").meta["epoch"] == 1
    ck.close()


def test_drop_survives_superseder_failure(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    gate = _gated(ck, fail_epoch=3)
    ck.save_and_keep_only(_state(1), meta={"F1": 5.0, "epoch": 1},
                          max_keys=["F1"])
    _until(lambda: ck._inflight_meta is not None)
    ck.save_and_keep_only(_state(2), meta={"F1": 40.0, "epoch": 2},
                          max_keys=["F1"])
    ck.save_and_keep_only(_state(3), meta={"F1": 50.0, "epoch": 3},
                          max_keys=["F1"])
    assert _queued(ck) == [3] and _queued(ck, "_dropped") == [2]
    gate.set()
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.flush()
    best = ck.find_checkpoint(max_key="F1")
    assert best.meta["epoch"] == 2 and best.meta["F1"] == 40.0
    ck.close()


def _snapshot(v, event=None):
    """A one-tensor snapshot of the saved layout; ``event`` stands for a
    card's copy that is still running."""
    snap = DeviceSnapshot(
        {"w": torch.full((4, 4), float(v))},
        lambda host: {"params": {"['w']": host["w"].numpy()}})
    snap.event = event
    return snap


class _Copy:
    """A copy from the card that ends when ``done`` is set."""

    def __init__(self):
        self.done = threading.Event()

    def synchronize(self):
        assert self.done.wait(timeout=WAIT)


def test_held_drops_are_staged_to_host(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    gate = _gated(ck)
    ck.save_and_keep_only(_snapshot(1), meta={"F1": 5.0, "epoch": 1},
                          max_keys=["F1"])
    _until(lambda: ck._inflight_meta is not None)
    ck.save_and_keep_only(_snapshot(2), meta={"F1": 7.0, "epoch": 2},
                          max_keys=["F1"])
    ck.save_and_keep_only(_snapshot(3), meta={"F1": 50.0, "epoch": 3},
                          max_keys=["F1"])
    with ck._cv:
        held = [leaf for (s, *_r) in ck._dropped for tree in s.values()
                for leaf in tree.values()]
    assert held and all(isinstance(leaf, np.ndarray) for leaf in held)
    gate.set()
    ck.flush()
    ck.close()


def test_backpressure_bounds_queue_depth(tmp_path, monkeypatch):
    """Two queued saves block a third; above
    ``MLVAE_ASYNC_CKPT_TIGHT_BYTES`` one queued save blocks a second."""
    for tight, n_free in ((False, 2), (True, 1)):
        if tight:
            monkeypatch.setenv("MLVAE_ASYNC_CKPT_TIGHT_BYTES", "8")
        ck = Checkpointer(tmp_path / f"ckpts{tight}", async_save=True)
        gate = _gated(ck)
        ck.save_and_keep_only(_state(1), meta={"m1": 1.0, "epoch": 1},
                              max_keys=["m1"])
        _until(lambda: ck._inflight_meta is not None)
        for e in range(2, 2 + n_free):
            ck.save_and_keep_only(_state(e), meta={f"m{e}": 1.0,
                                                   "epoch": e},
                                  max_keys=[f"m{e}"])
        done = threading.Event()
        last = 2 + n_free

        def enqueue():
            ck.save_and_keep_only(_state(last), meta={f"m{last}": 1.0,
                                                      "epoch": last},
                                  max_keys=[f"m{last}"])
            done.set()
        t = threading.Thread(target=enqueue, daemon=True)
        t.start()
        assert not done.wait(timeout=0.3), "the enqueue should block"
        gate.set()
        assert done.wait(timeout=WAIT)
        t.join(timeout=WAIT)
        ck.flush()
        assert [c.meta["epoch"] for c in ck.list_checkpoints()] == [last]
        ck.close()


def test_async_saves_under_thread_switches_keep_the_best(tmp_path):
    """Forty saves with a worker stalled at random, the interpreter
    switching threads every microsecond: the best save by its key and the
    newest persist, nothing stays pinned or queued."""
    import sys
    rs = np.random.RandomState(0)
    f1s = rs.rand(40) * 100
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    orig = ck._save_and_prune
    ck._save_and_prune = lambda *a: (time.sleep(rs.rand() * 2e-3),
                                     orig(*a))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for epoch, f1 in enumerate(f1s, start=1):
            ck.save_and_keep_only(_snapshot(epoch), meta={
                "F1": float(f1), "epoch": epoch}, max_keys=["F1"])
        ck.flush()
    finally:
        sys.setswitchinterval(interval)
    assert ck.find_checkpoint(max_key="F1").meta["F1"] == float(f1s.max())
    assert ck.find_checkpoint().meta["epoch"] == len(f1s)
    assert ck._device_pinned == 0 and not ck._queue and not ck._dropped
    ck.close()
    assert ck._worker is None


def test_close_stops_worker_and_stays_usable(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    ck.save_and_keep_only(_state(1), meta={"epoch": 1})
    ck.close()
    assert ck._worker is None
    assert ck.find_checkpoint().meta["epoch"] == 1
    ck.save_and_keep_only(_state(2), meta={"epoch": 2})
    ck.flush()
    assert ck.find_checkpoint().meta["epoch"] == 2
    ck.close()


def test_list_checkpoints_skips_torn_entries(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts")
    ck.save_and_keep_only(_state(1), meta={"epoch": 1})
    torn = tmp_path / "ckpts" / "CKPT-torn"
    torn.mkdir()
    (torn / "params.npz").write_bytes(b"partial")
    torn2 = tmp_path / "ckpts" / "CKPT-torn2"
    torn2.mkdir()
    (torn2 / "meta.json").write_text("{invalid json")
    assert [c.meta["epoch"] for c in ck.list_checkpoints()] == [1]


def test_wait_device_release_fences_the_copies(tmp_path, monkeypatch):
    """A snapshot whose copy from the card may still run pins the device
    until the worker's fetch or ``wait_device_release``, which makes the
    stream wait for the copy (no host wait); the file holds the values of
    the snapshot, not those of a later in-place update."""
    fenced = []
    monkeypatch.setattr(DeviceSnapshot, "fence",
                        lambda self: fenced.append(self))
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    copy = _Copy()
    w = torch.full((4, 4), 1.0)
    snap = DeviceSnapshot({"w": w},
                          lambda host: {"params": {"['w']":
                                                   host["w"].numpy()}})
    snap.event = copy
    w.add_(1.0)      # the next step's in-place update
    ck.save_and_keep_only(snap, meta={"F1": 10.0, "epoch": 1},
                          max_keys=["F1"])
    assert ck._device_pinned == 1
    ck.wait_device_release()
    assert ck._device_pinned == 0 and fenced == [snap]
    copy.done.set()
    ck.flush()
    best = ck.find_checkpoint(max_key="F1")
    restored = ck.load_checkpoint(best, templates=_state(0))
    assert restored["params"]["['w']"][0, 0] == 1.0
    # the worker's fetch releases a snapshot too, once
    snap2 = _snapshot(2, event=_Copy())
    snap2.event.done.set()
    ck.save_and_keep_only(snap2, meta={"F1": 1.0, "epoch": 2},
                          max_keys=["F1"])
    ck.flush()
    assert ck._device_pinned == 0 and fenced == [snap]
    ck.close()


def test_wait_device_release_noop_without_worker(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=False)
    ck.wait_device_release()
    ck.save_and_keep_only(_snapshot(1), meta={"epoch": 1})
    ck.wait_device_release()
    assert ck.find_checkpoint() is not None


def test_host_state_saves_keep_pin_accounting_balanced(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts", async_save=True)
    for epoch in (1, 2, 3):
        ck.save_and_keep_only(_state(epoch), meta={"epoch": epoch})
    ck.flush()
    assert ck._device_pinned == 0
    ck.save_and_keep_only(_snapshot(4), meta={"epoch": 4})
    ck.wait_device_release()
    assert ck._device_pinned == 0
    ck.close()


def test_metric_tie_breaks_to_newest(tmp_path):
    ck = Checkpointer(tmp_path / "ckpts")
    for epoch in (1, 2, 3):
        ck.save_and_keep_only(
            _state(epoch), meta={"F1": 35.85, "loss": 3.0, "epoch": epoch},
            max_keys=["F1"], num_to_keep=1)
    assert ck.find_checkpoint(max_key="F1").meta["epoch"] == 3
    assert ck.find_checkpoint(min_key="loss").meta["epoch"] == 3
    kept = [c.meta["epoch"] for c in ck.list_checkpoints()]
    assert 3 in kept and 1 not in kept


def _npz(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: (data[k].dtype.str, data[k].shape, data[k].tobytes())
                for k in data.files}


def test_async_and_sync_saves_write_identical_files(models, tmp_path):
    """The recipe's state saved by the worker from an asynchronous
    snapshot and saved at once: the same blobs (every key's dtype, shape
    and bytes; an npz's zip stamps its write time) and the same
    ``meta.json``, bf16 moments (``|V2``) included."""
    _, pm = models
    rs = np.random.RandomState(4)
    with torch.no_grad():
        for p in pm.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)))
        for st in pm.opt_states["optimizer"].values():
            st["count"].fill_(2)
            for moment in ("mu", "nu"):
                st[moment].copy_(torch.from_numpy(
                    rs.rand(st[moment].numel()).astype(np.float32)))
    first = next(iter(pm.opt_states["optimizer"].values()))
    first["mu"] = first["mu"].to(torch.bfloat16)
    try:
        meta = {"plvl_md.F1": 3.0, "epoch": 2, "unixtime": 100.0}
        sync = Checkpointer(tmp_path / "sync")
        sync.save_and_keep_only(pm.checkpoint_state(), meta=dict(meta),
                                max_keys=["plvl_md.F1"])
        ack = Checkpointer(tmp_path / "async", async_save=True)
        ack.save_and_keep_only(pm.checkpoint_snapshot(asynchronous=True),
                               meta=dict(meta), max_keys=["plvl_md.F1"])
        ack.close()
    finally:
        first["mu"] = first["mu"].float()
    (a,), (b,) = sync.list_checkpoints(), ack.list_checkpoints()
    names = sorted(p.name for p in a.path.iterdir())
    assert names == sorted(p.name for p in b.path.iterdir())
    assert "opt__optimizer.npz" in names
    assert (a.path / "meta.json").read_text() == \
        (b.path / "meta.json").read_text()
    for name in names:
        if name.endswith(".npz"):
            assert _npz(a.path / name) == _npz(b.path / name), name
    assert "|V2" in {v[0] for v in _npz(a.path / "opt__optimizer.npz")
                     .values()}


# -- the resume after an optimizer-state layout change ----------------------
def test_resume_tolerates_opt_state_layout_change(models, tmp_path, caplog):
    """A checkpoint whose ``opt__*`` keys predate the current layout
    resumes the parameters with fresh moments and a warning naming the
    optimizer-state layout; a parameter missing from a checkpoint still
    raises."""
    _, pm = models
    with torch.no_grad():
        for p in pm.parameters():
            p.add_(0.5)
        for st in pm.opt_states["optimizer"].values():
            st["count"].fill_(4)
            st["mu"].fill_(0.25)
    want = {k: v.clone() for k, v in pm.state_dict().items()}
    ck = Checkpointer(tmp_path)
    ck.save_and_keep_only(pm.checkpoint_state(), meta={"epoch": 2})
    ckpt = ck.find_checkpoint()
    opt_path = ckpt.path / "opt__optimizer.npz"
    with np.load(opt_path, allow_pickle=False) as data:
        legacy = {f".legacy{k}": data[k] for k in data.files}
    np.savez(opt_path, **legacy)
    pm.checkpointer = ck
    pm.init_optimizers()                  # fresh moments
    with torch.no_grad():
        for p in pm.parameters():
            p.zero_()
    pm.hparams["epoch_counter"].current = 0
    with caplog.at_level(logging.WARNING):
        pm._restore(ckpt, with_opt=True)
    assert any("optimizer-state layout" in r.getMessage()
               for r in caplog.records)
    got = pm.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert pm.hparams["epoch_counter"].current == 2
    for st in pm.opt_states["optimizer"].values():
        assert int(st["count"]) == 0 and not st["mu"].any()
    # a parameter the checkpoint lacks: not a layout the fallback covers
    params_path = ckpt.path / "params.npz"
    with np.load(params_path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    flat.pop(sorted(flat)[0])
    np.savez(params_path, **flat)
    with pytest.raises(ValueError, match="does not fit the model"):
        pm._restore(ckpt, with_opt=True)
    with pytest.raises(CheckpointKeyMismatch, match="params"):
        ck.load_checkpoint(ckpt, {"params": {"['absent']": np.zeros(2)}})
