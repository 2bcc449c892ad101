"""The environment switch ``MLVAE_PALLAS_FUSED`` that the port reads as
the JAX package does (``utils/envflags.env_tristate``, read by
``nn/rnn.py`` at import).

- The parser: the port's ``env_tristate`` / ``env_bool`` against the JAX
  package's over the same spellings, and a misspelled switch raising when
  the port's ``nn/rnn.py`` is imported.
- MD_VAE's VAE train step at narrow width (H=128, B=4, T=8, L=4) against
  the JAX package's jitted step from the same weights (the port's seeded
  init), normalizer statistics and fresh Adam states, every draw replayed,
  under ``MLVAE_PALLAS_FUSED=1`` on f32 streams, the switch set alike in
  both packages. On the CPU the JAX LSTM would take its scan, so its
  Pallas dispatch is forced on (``_pallas_eligible``) and its kernels run
  in interpret mode; both packages' fused budgets are set to 2^20 bytes,
  so that in f32 the In=128 layers take K3 and the decoder's In=2H layers
  K4, as MD_VAE's In=128 and In=512 layers do at H=512.
- The same step's routes under ``=0`` and ``--bf16``: every layer
  direction takes K1 in both packages (the JAX step traced, not compiled;
  the layers' outputs and gradients on that route are held by
  ``tests/test_torch_lstm_fused.py``'s ``off`` dispatch cases).

Tolerances, with their reasons: f32 losses within 1e-4 relative and each
module's applied grads within 1e-3 relative in norm (sums in another
order through ten layers; the f32 train-step test's loss bound; measured
5e-7).
"""
import importlib.util

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.lstm_pallas as lp
import mlvae_tpu.utils.envflags as jflags
from mlvae_tpu.bench_utils import build_md_vae as jax_build_md_vae
from mlvae_tpu.bench_utils import synth_batch as jax_synth_batch
from mlvae_tpu.training.brain import Stage as JaxStage

import mlvae_tpu_torch.nn.rnn as prnn
import mlvae_tpu_torch.ops.lstm as pl
import mlvae_tpu_torch.utils.envflags as pflags
from mlvae_tpu_torch.bench_utils import RECIPE, build_md_vae, synth_batch
from mlvae_tpu_torch.convert import from_jax, to_jax
from mlvae_tpu_torch.training.brain import Stage

torch.set_num_threads(2)

H = 128
SMALL = {"phn_rnn_hidden_size": H, "boundary_rnn_hidden_size": H,
         "rnn_hidden_size": H, "dec_rnn_hidden_size": H}
B, T, L = 4, 8, 4
EPOCH = 3   # the VAE target
# In=128 at H=128: K3 (128 + 128) * 4H * 8 = 2^20 bytes, within; the
# decoder's In=2H: K3 1.5 * 2^20 over, K4 (256 + 128) * 4H * 4 + 4H * H *
# 4 = 2^20 within
BUDGET = 1 << 20
LOSS_TOL, GRAD_TOL = 1e-4, 1e-3
VAE_ACTIVE = {"feat_fc", "phn_recog_fc", "concat_fc", "rnn", "pi_fc",
              "encoder", "decoder"}
SPELLINGS = [None, "", "auto", "1", "true", "0", "off", "ture"]


def _parse(mod, fn, name, monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    try:
        return getattr(mod, fn)(name, *(("auto",) if fn == "env_tristate"
                                       else (False,)))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("fn", ["env_tristate", "env_bool"])
@pytest.mark.parametrize("raw", SPELLINGS,
                         ids=["unset", "empty", *SPELLINGS[2:]])
def test_env_flags_parse_as_jax(fn, raw, monkeypatch):
    """The same value from both packages' parsers for every spelling, or
    the same ``ValueError`` (``ture``; ``auto`` for a boolean)."""
    name = "MLVAE_PALLAS_FUSED"
    got = _parse(pflags, fn, name, monkeypatch, raw)
    want = _parse(jflags, fn, name, monkeypatch, raw)
    assert got == want
    if raw == "ture":
        assert got[0] == "ValueError"


def test_misspelled_switch_raises_at_import(monkeypatch):
    """``MLVAE_PALLAS_FUSED=ture`` stops the port's ``nn/rnn.py`` at import
    with the parser's error, as it stops the JAX package's (the parsers'
    equality is held above): the module's source executed afresh under
    another name, which leaves the imported module as it is."""
    monkeypatch.setenv("MLVAE_PALLAS_FUSED", "ture")
    spec = importlib.util.spec_from_file_location(
        "mlvae_tpu_torch.nn._rnn_misspelled", prnn.__file__)
    with pytest.raises(ValueError, match="MLVAE_PALLAS_FUSED='ture' is not "
                       "a recognized boolean"):
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


def test_port_reads_the_switch_at_import():
    """The port's module value is the parse of this process's
    environment, as the JAX module's is."""
    want = pflags.env_tristate("MLVAE_PALLAS_FUSED", "auto")
    assert prnn.PALLAS_LSTM_FUSED == want == jrnn.PALLAS_LSTM_FUSED


def _replay(draws, rng):
    """The port's named draws made as the JAX step makes them (draw i from
    ``fold_in(rng, i)`` in the draw's dtype; dropout gaps as lists)."""
    noise = {}
    for i, (name, kind, shape, keep, dtype) in enumerate(draws):
        k = jax.random.fold_in(rng, i)
        if kind == "bernoulli":
            noise.setdefault(name, []).append(torch.from_numpy(
                np.array(jax.random.bernoulli(k, keep, shape))))
            continue
        fn = {"uniform": jax.random.uniform, "normal": jax.random.normal,
              "gumbel": jax.random.gumbel}[kind]
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        v = np.array(fn(k, shape, jd).astype(jnp.float32))
        noise[name] = torch.from_numpy(v).to(dtype)
    return noise


def _spy(monkeypatch):
    """Force the JAX dispatch and run its three LSTM kernels in interpret
    mode; record each JAX and port layer direction's kernel in order."""
    jcalls, pcalls = [], []
    real = {"K3": lp.lstm_layer_fused, "K4": lp.lstm_layer_semifused}
    real_k1 = lp.lstm_layer

    def fused(name):
        def f(x, w_ih, bias, w_hh, reverse=False, interpret=False):
            jcalls.append(name)
            return real[name](x, w_ih, bias, w_hh, reverse, True)
        return f

    def k1(gates_x, w_hh, reverse=False, interpret=False):
        jcalls.append("K1")
        return real_k1(gates_x, w_hh, reverse, True)

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer_fused", fused("K3"))
    monkeypatch.setattr(lp, "lstm_layer_semifused", fused("K4"))
    monkeypatch.setattr(lp, "lstm_layer", k1)
    for name, tag in (("LSTMRecurrence", "K1"), ("LSTMFused", "K3"),
                      ("LSTMSemiFused", "K4")):
        cls = getattr(prnn, name)

        def apply(*a, _orig=cls.apply, _tag=tag):
            pcalls.append(_tag)
            return _orig(*a)

        monkeypatch.setattr(cls, "apply", apply)
    return jcalls, pcalls


def _mu(jstate, mk, names):
    inner = jstate.inner_state[0]
    leaves = []
    for name in names:
        leaf = inner.mu[mk]
        for part in name.split("."):
            leaf = leaf[part]
        leaves.append(np.asarray(leaf).reshape(-1))
    return np.concatenate(leaves)


def _step_setup(amp, switch, monkeypatch):
    """Both packages' MD_VAE at narrow width, the switch and the 2^20-byte
    budgets set alike, the JAX model on the port's weights and both at the
    VAE target's first step: (port, JAX model, the JAX step, its rng, the
    JAX and port kernel records)."""
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_FUSED", switch)
    monkeypatch.setattr(prnn, "PALLAS_LSTM_FUSED", switch)
    monkeypatch.setattr(lp, "FUSED_RESIDENT_BUDGET", BUDGET)
    monkeypatch.setattr(pl, "FUSED_RESIDENT_BUDGET", BUDGET)
    jcalls, pcalls = _spy(monkeypatch)
    port = build_md_vae(batch_size=B, overrides=SMALL, device="cpu",
                        bf16=amp)
    jax_model = jax_build_md_vae(batch_size=B, overrides=dict(SMALL))
    if amp:
        jax_model.run_opts["bf16"] = True
        jax_model.auto_mix_prec = True
    # the port's seeded weights (JAX's own init runs op by op, 15 s here)
    jax_model.params = jax.tree_util.tree_map(
        jnp.asarray, to_jax(port.state_dict())[0])
    jax_model.ensure_states(RECIPE["input_size"])
    rs = np.random.RandomState(1)
    C = RECIPE["input_size"]
    jax_model.states["normalizer"] = {
        "count": jnp.float32(12.0),
        "glob_mean": jnp.asarray(rs.randn(C).astype(np.float32) * 0.2),
        "glob_std": jnp.asarray((0.5 + rs.rand(C)).astype(np.float32))}
    jax_model.init_optimizers()
    jax_model.on_stage_start(JaxStage.TRAIN, EPOCH)
    step = jax_model._get_compiled("train", JaxStage.TRAIN)
    port.load_state_dict(from_jax(jax.device_get(jax_model.params),
                                  jax.device_get(jax_model.states)))
    port.on_stage_start(Stage.TRAIN, EPOCH)
    return port, jax_model, step, jax.random.PRNGKey(17), jcalls, pcalls


def _stepped(port):
    return {mk for mk, st in port.opt_states["optimizer"].items()
            if int(st["count"])}


@pytest.mark.parametrize("case", ["f32-on"])
def test_vae_step_under_the_switch_matches_jax(case, monkeypatch):
    """One f32 VAE train step under ``MLVAE_PALLAS_FUSED=1`` in both
    packages: the same kernel for each layer direction (the forward's ten:
    K3 for the In=128 layers, K4 for the decoder's In=2H pair), the
    losses, and each module's clipped grads (optax's first Adam moment
    over 0.1) against the port's applied grads; exactly the VAE modules
    stepped."""
    port, jax_model, step, rng, jcalls, pcalls = _step_setup(
        False, True, monkeypatch)
    _, o, _, j_loss, j_losses = step(
        jax_model.params, jax_model.opt_states, jax_model.states, rng,
        jax_synth_batch(B, T, L, seed=0), jnp.int32(EPOCH))
    loss, losses = port.fit_batch(synth_batch(B, T, L, seed=0, device="cpu"),
                                  EPOCH, noise=_replay(
                                      port.draws(B, T, train=True), rng))

    assert jcalls == pcalls == ["K3"] * 8 + ["K4"] * 2
    assert set(losses) == set(j_losses)
    for key in j_losses:
        np.testing.assert_allclose(float(losses[key]), float(j_losses[key]),
                                   rtol=LOSS_TOL, err_msg=key)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_TOL)
    j_opt = jax.device_get(o["optimizer"])
    assert _stepped(port) == VAE_ACTIVE
    for mk in VAE_ACTIVE:
        mod = port.param_modules()[mk]
        names = [n for n, _ in mod.named_parameters()]
        g_j = _mu(j_opt[mk], mk, names) / np.float32(0.1)
        g = torch.cat([q.grad.reshape(-1) for q in mod.parameters()])
        assert g.dtype == torch.float32
        err = np.linalg.norm(g.numpy() - g_j) / np.linalg.norm(g_j)
        assert err < GRAD_TOL, (mk, err)


def test_vae_step_routes_under_the_switch_off_match_jax(monkeypatch):
    """The AMP VAE train step under ``MLVAE_PALLAS_FUSED=0`` in both
    packages: every one of the forward's ten layer directions takes K1
    (the JAX step traced by ``jax.eval_shape``, which records each layer's
    kernel without compiling), the port's step gives a finite loss and
    steps exactly the VAE modules."""
    port, jax_model, step, rng, jcalls, pcalls = _step_setup(
        True, False, monkeypatch)
    jax.eval_shape(step, jax_model.params, jax_model.opt_states,
                   jax_model.states, rng, jax_synth_batch(B, T, L, seed=0),
                   jnp.int32(EPOCH))
    loss, _ = port.fit_batch(synth_batch(B, T, L, seed=0, device="cpu"),
                             EPOCH, noise=_replay(
                                 port.draws(B, T, train=True), rng))
    assert jcalls == pcalls == ["K1"] * 10
    assert np.isfinite(float(loss))
    assert _stepped(port) == VAE_ACTIVE
