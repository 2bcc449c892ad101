"""The Brain's run options on the CPU (``training/brain.py``):

* ``--scan_epoch``: the scanned TRAIN epoch (its chunks run eagerly here,
  as over gloo) against the per-batch loop at the sizes and batch plan of
  ``tests/test_scan_epoch.py`` (three batches of T=32, two of T=48):
  losses, parameters and the step generator's state equal, bit for bit,
  by default and in the tight mode (``MLVAE_HBM_TIGHT=1``: a wait every
  chunk); the scanned epoch steps on the device-batch cache's own
  tensors; the card's step-graph bookkeeping with a stand-in graph (eager
  at a key's first batch, captured at its second, the most recent
  ``STEP_GRAPHS_KEPT`` kept, one memory pool an epoch, no ``.grad`` left
  after a graph's step); the scanned TEST epoch against the per-batch
  loop (losses and the metric statistics). The per-batch loop is itself
  held against the JAX train step with every draw replayed
  (``tests/test_torch_train_step.py``).
* ``--cache_device_batches``: cached and uncached epochs give the same
  losses, and the cache keeps within its byte cap;
  ``_autoscale_cache_budget`` from ``MLVAE_HBM_BYTES``.
* the frozen-trunk feature cache of the w2v recipes on a tiny trunk:
  the cached ``w2v_feat`` equal to the features the step computes, bit for
  bit, in f32 and under ``--bf16``, and the steps from it equal to steps
  without the cache (``MLVAE_W2V_FROZEN_CACHE=0``).
* the trunk's per-layer recompute (``MLVAE_W2V_REMAT``): gradients equal
  with it on and off, with the draws replayed and drawn from a generator,
  and within rel 1e-4 (in norm) of the JAX trunk's at 2 layers and d=32.
* ``cli.train`` / ``cli.test`` with ``--scan_epoch --async_ckpt
  --profile`` on ``test_vanilla_vae`` (the counterpart of
  ``tests/test_end_to_end.py::test_scan_epoch_with_async_ckpt``): the
  epochs run, the checkpoints persist, TEST reads the best one, and
  ``--profile`` writes ``step_times.jsonl`` (the JAX ``StepTimer`` keys,
  one line an epoch) and a Chrome trace of epoch 1."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.modules.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from mlvae_tpu.nn.core import RngStream

from mlvae_tpu_torch.bench_utils import (build_md_vae, build_w2v_lstm_fc,
                                         synth_batch, synth_w2v_fc_batch)
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.models.w2v_common import W2V_FEAT_KEY
from mlvae_tpu_torch.modules import wav2vec2 as W
from mlvae_tpu_torch.training.brain import Stage
from mlvae_tpu_torch.utils.profiling import StepTimer
from test_torch_wav2vec2 import replay

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# tests/test_scan_epoch.py's SMALL
SMALL = {
    "phn_rnn_hidden_size": 64, "boundary_rnn_hidden_size": 64,
    "rnn_hidden_size": 64, "dec_rnn_hidden_size": 64,
    "phn_rnn_num_layers": 1, "boundary_rnn_num_layers": 1,
    "rnn_num_layers": 1, "dec_rnn_num_layers": 1,
}
PLAN = (32, 32, 32, 48, 48)
STEP_KEYS = {"steps", "mean_s", "p50_s", "p90_s", "compile_s",
             "utt_sec_per_sec"}
TINY = dict(conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)


def _host_batches():
    """tests/test_scan_epoch.py's batches as host batches with ids."""
    out = []
    for i, T in enumerate(PLAN):
        b = synth_batch(batch_size=8, T=T, L=4, seed=100 + i, device="cpu")
        hb = {k: tuple(t.numpy() for t in v) for k, v in b.items()}
        hb["id"] = [f"u{i}_{j}" for j in range(8)]
        out.append(hb)
    return out


def _model(**run_opts):
    model = build_md_vae(batch_size=8, overrides=dict(SMALL), device="cpu",
                         run_opts=run_opts)
    model.generator = torch.Generator().manual_seed(7)
    model.step_timer = StepTimer()
    model.train()
    return model


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _recorder(model):
    """The per-key losses each step records, in order."""
    recorded = []
    model._record_losses = lambda losses: recorded.append(
        {k: float(v) for k, v in losses.items()})
    return recorded


def _fit(model, scanned, epoch=3, batches=None):
    """One TRAIN epoch of the VAE target: (mean loss, recorded losses)."""
    model.on_stage_start(Stage.TRAIN, epoch)
    recorded = _recorder(model)
    batches = batches or _host_batches()
    if scanned:
        loss = model._fit_epoch_scanned(batches, epoch)[0]
    else:
        loss = float(np.mean([float(model.train_batch(b, epoch))
                              for b in batches]))
    return loss, recorded


@pytest.fixture(scope="module")
def per_batch():
    model = _model()
    loss, stats = _fit(model, False)
    return loss, stats, _state(model), model.generator.get_state()


@pytest.mark.parametrize("tight", [False, True], ids=["depth3", "tight"])
def test_scanned_epoch_matches_per_batch_loop(per_batch, monkeypatch,
                                              tight):
    if tight:
        monkeypatch.setenv("MLVAE_HBM_TIGHT", "1")
    model = _model(scan_epoch=True)
    model._autoscale_cache_budget()
    assert model._hbm_tight == tight
    assert model._scan_depth() == (1 if tight else 3)
    assert model.scan_dispatch() == "eager"
    loss, stats = _fit(model, True)
    want_loss, want_stats, want_state, want_gen = per_batch
    assert loss == want_loss
    assert stats == want_stats
    got = _state(model)
    assert all(torch.equal(got[k], want_state[k]) for k in want_state)
    assert torch.equal(model.generator.get_state(), want_gen)
    assert model.step == len(PLAN)
    # two runs (T=32, T=48): a wait at each chunk in the tight mode, none
    # with three in flight
    assert model.scan_stats["waits"] == (2 if tight else 0)
    assert model.scan_stats["eager"] == len(PLAN)


def test_scanned_epoch_steps_on_the_cached_batches():
    """Each step of a scanned epoch gets the device-batch cache's own
    batch (no stacked copy of a run), every epoch; with a cap below one
    batch nothing is cached and the epoch is the same."""
    model = _model(scan_epoch=True)
    batches = _host_batches()
    seen = []
    step = model._scan_step

    def spy(kind, stage, sig, epoch, dev, fn):
        seen.append(id(dev))
        return step(kind, stage, sig, epoch, dev, fn)
    model._scan_step = spy
    _fit(model, True, batches=batches)
    _fit(model, True, batches=batches)
    cached = {id(d) for d in model._dev_batch_cache.values()}
    assert len(cached) == len(PLAN)
    assert seen[:len(PLAN)] == seen[len(PLAN):] and set(seen) == cached
    capped = _model(scan_epoch=True, device_batch_cache_mb=0)
    ref = _model(scan_epoch=True)
    assert _fit(capped, True) == _fit(ref, True)
    assert not capped._dev_batch_cache
    got, want = _state(capped), _state(ref)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_step_graphs_kept_and_their_gradients(monkeypatch):
    """The card's dispatch with a stand-in for the CUDA graph (which runs
    the step): three shapes with ``STEP_GRAPHS_KEPT`` 2, so the first
    shape's graph is dropped and captured again; one pool for the epoch's
    graphs; no ``.grad`` after a graph's step; the losses and parameters
    of the per-batch loop."""
    from mlvae_tpu_torch.training import brain as B
    plan = (32, 32, 48, 48, 64, 64, 32, 32)
    batches = []
    for i, T in enumerate(plan):
        b = synth_batch(batch_size=8, T=T, L=4, seed=200 + i, device="cpu")
        hb = {k: tuple(t.numpy() for t in v) for k, v in b.items()}
        hb["id"] = [f"g{i}_{j}" for j in range(8)]
        batches.append(hb)
    pools, graphs = [], []

    class Graph:
        def __init__(self, fn, inputs, pool=None):
            self.fn, self.pool = fn, pool
            graphs.append(self)

        def __call__(self, *inputs):
            return self.fn(*inputs)
    monkeypatch.setattr(B, "StepGraph", Graph)
    monkeypatch.setattr(B, "STEP_GRAPHS_KEPT", 2)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: pools.append(object()) or pools[-1])
    model = _model(scan_epoch=True)
    model.scan_dispatch = lambda: "graph"
    loss, stats = _fit(model, True, batches=batches)
    assert model.scan_stats["eager"] == 3
    assert model.scan_stats["captures"] == 4
    assert model.scan_stats["replays"] == 5
    assert len(pools) == 1 and all(g.pool is pools[0] for g in graphs)
    assert not model._graphs          # dropped at the epoch's end
    assert all(p.grad is None for p in model.parameters())
    ref = _model()
    assert (loss, stats) == _fit(ref, False, batches=batches)
    got, want = _state(model), _state(ref)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_scanned_eval_matches_per_batch_loop():
    """The same losses, and the same host hook calls: each batch's
    predictions, ids and stage, in order."""
    def run(scanned):
        model = _model(scan_epoch=scanned)
        model.eval()
        model.generator = torch.Generator().manual_seed(11)
        model.on_stage_start(Stage.TEST, 1)
        recorded, hooked = _recorder(model), []
        model.evaluate_predictions = lambda preds, batch, stage: \
            hooked.append((list(model._batch_ids), list(batch["id"]),
                           stage, preds))
        batches = _host_batches()
        if scanned:
            avg = model._eval_epoch_scanned(batches, Stage.TEST)
        else:
            avg = float(np.mean([model.evaluate_batch(b, Stage.TEST)
                                 for b in batches]))
        return avg, recorded, hooked, model.generator.get_state()
    a, b = run(False), run(True)
    assert a[0] == b[0] and a[1] == b[1]
    assert torch.equal(a[3], b[3])
    assert len(a[2]) == len(b[2]) == len(PLAN)
    for (ids_a, hb_a, st_a, pa), (ids_b, hb_b, st_b, pb) in zip(a[2], b[2]):
        assert ids_a == ids_b == hb_a == hb_b and st_a == st_b
        assert sorted(pa) == sorted(pb) and pa
        assert all(torch.equal(pa[k], pb[k]) for k in pa)


def test_device_batch_cache_matches_uncached_within_its_cap():
    batches = _host_batches()
    one = 8 * 32 * 120 * 4      # the feature bytes of a T=32 batch
    runs = {}
    for name, opts in (("off", {"cache_device_batches": False}),
                       ("on", {}), ("capped", {})):
        model = _model(**opts)
        if name == "capped":
            model.device_batch_cache_limit = 3 * one
        runs[name] = ([_fit(model, False, epoch=e, batches=batches)
                       for e in (3, 4)], _state(model), model)
    assert runs["on"][0] == runs["off"][0] == runs["capped"][0]
    for name in ("on", "capped"):
        got, want = runs[name][1], runs["off"][1]
        assert all(torch.equal(got[k], want[k]) for k in want)
    on, capped = runs["on"][2], runs["capped"][2]
    assert len(on._dev_batch_cache) == len(PLAN)
    assert not runs["off"][2]._dev_batch_cache
    assert 0 < len(capped._dev_batch_cache) < len(PLAN)
    assert capped._dev_batch_cache_bytes <= capped.device_batch_cache_limit


def test_cache_budget_scales_with_the_card(monkeypatch):
    """The JAX Brain's rule: tight where 4.5x the parameters' bytes and 2
    GiB pass 3/5 of the card, the budget half of what is left; nothing to
    do off the card without ``MLVAE_HBM_BYTES``."""
    model = _model()
    limit = model.device_batch_cache_limit
    model._autoscale_cache_budget()
    assert model.device_batch_cache_limit == limit
    assert not model._hbm_tight
    param_bytes = sum(p.numel() * 4 for p in model.parameters())
    reserve = 9 * param_bytes // 2 + 2 * 1024 ** 3
    hbm = reserve + 1024 ** 3
    monkeypatch.setenv("MLVAE_HBM_BYTES", str(hbm))
    model._autoscale_cache_budget()
    assert model._hbm_tight
    assert model.device_batch_cache_limit == (hbm - reserve) // 2
    monkeypatch.setenv("MLVAE_HBM_TIGHT", "0")
    model._autoscale_cache_budget()
    assert not model._hbm_tight


# -- the w2v frozen-trunk feature cache ----------------------------------
def _w2v(bf16):
    model = build_w2v_lstm_fc(overrides={"wav2vec2_size": 32}, device="cpu",
                              bf16=bf16, freeze=True, **TINY)
    model.generator = torch.Generator().manual_seed(3)
    model.train()
    return model


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_w2v_frozen_feature_cache_is_the_step_path(monkeypatch, bf16):
    """The cached features against those the step computes (caught from
    the trunk inside the AMP or f32 step), bit for bit; the trunk's weights
    as both calls see them; two steps from the cached batch against two
    from the uncached one."""
    host = {k: tuple(t.numpy() for t in v) for k, v in
            synth_w2v_fc_batch(batch_size=3, samples=3200, seed=2,
                               device="cpu").items()}
    host["id"] = ["a", "b", "c"]
    runs = {}
    for cached in (True, False):
        monkeypatch.setenv("MLVAE_W2V_FROZEN_CACHE", "1" if cached else "0")
        model = _w2v(bf16)
        model._fitting = True
        model.on_stage_start(Stage.TRAIN, 1)
        seen, weights = [], []
        model.wav2vec2.register_forward_hook(
            lambda mod, args, out: seen.append(out))
        model.wav2vec2.register_forward_pre_hook(
            lambda mod, args: weights.append(
                {(p.dtype, p.requires_grad) for p in mod.parameters()}))
        dev = model._cached_device_batch(model.prepare_batch(host))
        assert (W2V_FEAT_KEY in dev) == cached
        assert ("wav" in dev) != cached
        losses = [float(model.train_batch(host, 1)) for _ in range(2)]
        T = dev["feat"][0].shape[1]
        feats = dev[W2V_FEAT_KEY][0] if cached else \
            model._match_len(seen[0], T)
        assert len(seen) == (1 if cached else 2)
        runs[cached] = (feats, losses, _state(model), weights[0])
    assert runs[True][0].dtype == (torch.bfloat16 if bf16
                                   else torch.float32)
    # the trunk sees its weights as in the step, requires_grad included:
    # it steers torch.matmul between one GEMM and a batched one, whose bf16
    # sums round apart on the card
    assert runs[True][3] == runs[False][3]
    assert torch.equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    got, want = runs[True][2], runs[False][2]
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_w2v_frozen_cache_only_in_the_fit_scope(monkeypatch):
    monkeypatch.delenv("MLVAE_W2V_FROZEN_CACHE", raising=False)
    model = _w2v(False)
    dev = {k: v for k, v in synth_w2v_fc_batch(
        batch_size=2, samples=3200, device="cpu").items()}
    assert model.augment_device_batch(dev) is dev     # not fitting
    model._fitting = True
    out = model.augment_device_batch(dev)
    assert W2V_FEAT_KEY in out and "wav" not in out
    assert model.step_draws(out, True) == model.step_draws(dev, True) == []


# -- the trunk's per-layer recompute -------------------------------------
def _grads(pm, x, w, noise, generator, remat, monkeypatch):
    monkeypatch.setenv("MLVAE_W2V_REMAT", "1" if remat else "0")
    pm.zero_grad(set_to_none=True)
    x = x.clone().requires_grad_(True)
    out = pm(x, train=True, noise=noise, generator=generator)
    (out * w).sum().backward()
    return out.detach(), x.grad, {n: p.grad.clone()
                                  for n, p in pm.named_parameters()}


def test_trunk_recompute_gradients(monkeypatch):
    args = dict(output_size=32, freeze=False, **TINY)
    jm = JaxEncoder(**args)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    pm = W.Wav2Vec2Encoder(**args)
    pm.load_state_dict({k[len("e."):]: v for k, v in
                        from_jax({"e": params}).items()}, strict=True)
    assert pm.num_hidden_layers == 2 and pm.hidden_size == 32
    B, n = 2, 3600
    T = W.conv_output_length(n)
    wav = np.random.RandomState(1).randn(B, n).astype(np.float32)
    w = torch.from_numpy(np.random.RandomState(2).randn(B, T, 32)
                         .astype(np.float32))
    x = torch.from_numpy(wav)
    rng = jax.random.PRNGKey(5)
    noise = replay(pm.draws(B, T, train=True), rng)
    on = _grads(pm, x, w, noise, None, True, monkeypatch)
    off = _grads(pm, x, w, noise, None, False, monkeypatch)
    for a, b in zip(on[:2], off[:2]):
        assert torch.equal(a, b)
    assert all(torch.equal(on[2][k], off[2][k]) for k in off[2])
    # drawn from a generator: the same masks with the recompute on
    gens = [torch.Generator().manual_seed(9) for _ in range(2)]
    on = _grads(pm, x, w, None, gens[0], True, monkeypatch)
    off = _grads(pm, x, w, None, gens[1], False, monkeypatch)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(on[2][k], off[2][k]) for k in off[2])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # the AMP step's forward (functional_call on bf16 copies): the
    # recompute runs on the copies too
    amp = {}
    for remat in (True, False):
        monkeypatch.setenv("MLVAE_W2V_REMAT", "1" if remat else "0")
        pm.zero_grad(set_to_none=True)
        out = torch.func.functional_call(
            pm, {n: p.to(torch.bfloat16) for n, p in pm.named_parameters()},
            (x.to(torch.bfloat16),), dict(train=True, noise=noise))
        (out.float() * w).sum().backward()
        amp[remat] = {n: p.grad.clone() for n, p in pm.named_parameters()}
    assert all(torch.equal(amp[True][k], amp[False][k]) for k in amp[False])
    # against the JAX trunk (its jax.checkpoint on, the default)
    monkeypatch.delenv("MLVAE_W2V_REMAT", raising=False)

    def jloss(p, xx):
        out = jm.apply(p, xx, rng=RngStream(rng), train=True)
        return jnp.sum(out * jnp.asarray(w.numpy()))
    jg, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(wav))
    _, dx, grads = _grads(pm, x, w, noise, None, True, monkeypatch)
    want = {k[len("e."):]: v for k, v in
            from_jax({"e": jax.device_get(jg)}).items()}
    floor = 1e-3 * float(np.sqrt(sum(float((v ** 2).sum())
                                      for v in want.values())))
    for name, g in grads.items():
        err = float(np.linalg.norm(g.numpy() - want[name].numpy()))
        assert err <= 1e-4 * max(float(np.linalg.norm(want[name])),
                                 floor), name
    assert float(np.linalg.norm(dx.numpy() - np.asarray(jdx))) <= \
        1e-4 * float(np.linalg.norm(np.asarray(jdx)))


# -- the options through the CLI -----------------------------------------
def test_cli_scan_epoch_async_ckpt_profile(tmp_path, monkeypatch):
    from mlvae_tpu_torch.cli import test as test_cli
    from mlvae_tpu_torch.cli import train as train_cli
    monkeypatch.chdir(tmp_path)
    yaml = REPO / "mlvae_tpu_torch/models/test_vanilla_vae/model.yaml"
    args = [str(REPO / "config/run.yaml"), "--dataset", "SynAudioMNIST",
            "--language", "digits", "--n_phonemes", "12",
            "--model_class", "test_vanilla_vae", "--model_name", "tv",
            "--model", f"!include:{yaml}", "--extra_overrides",
            "{model: {n_epochs: 3, recon_weight: 1.0, kld_weight: 1.0, "
            "dec_rnn_hidden_size: 32, dec_fc_size: 16, enc_fc_size: 16, "
            "latent_size: 8}}",
            "--scan_epoch", "True", "--async_ckpt", "True",
            "--profile", "True", "--noprogressbar", "True",
            "--device", "cpu"]
    model = train_cli.main(args)
    assert model.scan_epoch and model.use_scan()
    assert model.checkpointer.async_save
    assert model.checkpointer._worker is None      # closed at fit's end
    assert model.hparams["epoch_counter"].current == 3
    assert model.scan_stats["eager"] > 0
    out = tmp_path / "results/tv"
    assert list((out / "checkpoints").iterdir())
    lines = (out / "step_times.jsonl").read_text().splitlines()
    assert len(lines) == 3
    assert all(set(json.loads(ln)) == STEP_KEYS for ln in lines)
    trace = json.loads((out / "profile/trace.json").read_text())
    assert trace["traceEvents"]
    tested = test_cli.main(args)
    assert tested.use_scan() and tested._scanned_batches > 0
    assert (out / "test_output/test_metrics.txt").exists()
