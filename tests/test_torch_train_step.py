"""The whole training slice: MD_VAE's train step in the port against the
JAX package's jitted train step, at narrow widths (H=32, 2 layers, B=4,
T=24, L=4), with the JAX weights, normalizer statistics and fresh Adam
states carried across and every draw of every step replayed. Three steps
of each target (epoch 1: PHN_RECOG, 2: B_DETECTOR, 3: VAE): step 1's
losses and the grads each module applied, the set of modules that moved,
the normalizer's statistics after each step, the VAE target's decoded
sequences, and the later steps' losses; plus the draw order against the
JAX package's RngStream."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.bench_utils import build_md_vae as jax_build_md_vae
from mlvae_tpu.bench_utils import synth_batch as jax_synth_batch
from mlvae_tpu.nn.core import RngStream
from mlvae_tpu.training.brain import Stage as JaxStage

from mlvae_tpu_torch.bench_utils import RECIPE, build_md_vae, synth_batch
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.models.MD_VAE.model import Target
from mlvae_tpu_torch.training.brain import Stage

torch.set_num_threads(2)

SMALL = {"phn_rnn_hidden_size": 32, "boundary_rnn_hidden_size": 32,
         "rnn_hidden_size": 32, "dec_rnn_hidden_size": 32}
B, T, L = 4, 24, 4
STEPS = 3
RTOL = 1e-4
# Steps 2-3 could drift further: Adam's first steps move each weight by
# about +-lr wherever its gradient is non-zero, however small, so rounding
# noise in a near-zero gradient becomes a full lr step. At these widths the
# later losses still agree within a few 1e-7, so they keep step 1's bound.
LATER_RTOL = 1e-4
DECODED = ("decoded_boundary_seq", "decoded_flvl_md_lbl_seq",
           "decoded_plvl_md_lbl_seq", "decoded_t_lens", "decoded_l_lens")
TARGETS = {1: Target.PHN_RECOG, 2: Target.B_DETECTOR, 3: Target.VAE}
ACTIVE = {
    Target.PHN_RECOG: {"phoneme_recognizer"},
    Target.B_DETECTOR: {"boundary_detector"},
    Target.VAE: {"feat_fc", "phn_recog_fc", "concat_fc", "rnn", "pi_fc",
                 "encoder", "decoder"},
}


def _replay(draws, rng):
    """The port's named draws made as the JAX step makes them: draw i from
    ``fold_in(rng, i)``; repeated names (dropout gaps) become lists."""
    noise = {}
    for i, (name, kind, shape, keep, _) in enumerate(draws):
        k = jax.random.fold_in(rng, i)
        if kind == "bernoulli":
            noise.setdefault(name, []).append(torch.from_numpy(
                np.array(jax.random.bernoulli(k, keep, shape))))
            continue
        fn = {"uniform": jax.random.uniform, "normal": jax.random.normal,
              "gumbel": jax.random.gumbel}[kind]
        noise[name] = torch.from_numpy(np.array(fn(k, shape, jnp.float32)))
    return noise


def _adam_count_mu(jstate, mk, names):
    inner = jstate.inner_state[0]
    leaves = []
    for name in names:
        leaf = inner.mu[mk]
        for part in name.split("."):
            leaf = leaf[part]
        leaves.append(np.asarray(leaf).reshape(-1))
    return int(inner.count), np.concatenate(leaves)


@pytest.fixture(scope="module")
def jax_model():
    model = jax_build_md_vae(batch_size=B, overrides=dict(SMALL))
    model.init_params()
    model.ensure_states(RECIPE["input_size"])
    rs = np.random.RandomState(1)
    C = RECIPE["input_size"]
    # running statistics with history, so that the update's weighting shows
    model.states["normalizer"] = {
        "count": jnp.float32(12.0),
        "glob_mean": jnp.asarray(rs.randn(C).astype(np.float32) * 0.2),
        "glob_std": jnp.asarray((0.5 + rs.rand(C)).astype(np.float32))}
    model.init_optimizers()
    return model


def _port_model(jax_model):
    model = build_md_vae(batch_size=B, overrides=SMALL, device="cpu")
    model.load_state_dict(from_jax(jax.device_get(jax_model.params),
                                   jax.device_get(jax_model.states)))
    return model


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


@pytest.mark.parametrize("epoch", [1, 2, 3])
def test_train_steps_match_jax(jax_model, epoch):
    target = TARGETS[epoch]
    jax_model.on_stage_start(JaxStage.TRAIN, epoch)
    step = jax_model._get_compiled("train", JaxStage.TRAIN)
    jbatch = jax_synth_batch(B, T, L, seed=0)
    rngs = [jax.random.PRNGKey(100 * epoch + i) for i in range(STEPS)]
    params0 = jax.device_get(jax_model.params)
    p, o, s = (_copy(jax_model.params), _copy(jax_model.opt_states),
               _copy(jax_model.states))

    port = _port_model(jax_model)
    port.on_stage_start(Stage.TRAIN, epoch)
    assert port.target == target
    batch = synth_batch(B, T, L, seed=0, device="cpu")
    mods = port.param_modules()

    if target == Target.VAE:
        # the decode inside the step, on step 1's forward
        fwd = jax.jit(lambda pp, ss, bb, rr: jax_model.compute_forward(
            pp, ss, bb, JaxStage.TRAIN, rr, epoch)[0])
        j_preds = fwd(p, s, jbatch, rngs[0])
        preds = port.compute_forward(
            port.prepare_batch(batch), noise=_replay(port.draws(B, T, True),
                                                     rngs[0]),
            train=True, epoch=epoch)
        for key in DECODED:
            np.testing.assert_array_equal(preds[key].numpy(),
                                          np.asarray(j_preds[key]),
                                          err_msg=key)

    for i, rng in enumerate(rngs):
        p, o, s, j_loss, j_losses = step(p, o, s, rng, jbatch,
                                         jnp.int32(epoch))
        noise = _replay(port.draws(B, T, train=True), rng)
        loss, losses = port.fit_batch(batch, epoch, noise=noise)

        rtol = RTOL if i == 0 else LATER_RTOL
        assert set(losses) == set(j_losses)   # a jitted dict comes sorted
        for key in j_losses:
            np.testing.assert_allclose(float(losses[key]),
                                       float(j_losses[key]), rtol=rtol,
                                       err_msg=f"step {i + 1} {key}")
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=rtol)

        j_norm = jax.device_get(s["normalizer"])
        assert float(port.normalizer.count) == float(j_norm["count"])
        for key in ("glob_mean", "glob_std"):
            np.testing.assert_allclose(getattr(port.normalizer, key).numpy(),
                                       j_norm[key], rtol=1e-5, atol=1e-6,
                                       err_msg=key)

        j_opt = jax.device_get(o["optimizer"])
        counts = {mk: int(st["count"])
                  for mk, st in port.opt_states["optimizer"].items()}
        j_counts = {mk: int(j_opt[mk].inner_state[0].count) for mk in j_opt}
        assert counts == j_counts
        assert {mk for mk, c in counts.items() if c} == ACTIVE[target]
        if i == 0:
            # the clipped grads: optax's first mu is (1 - b1) * g
            for mk, mod in mods.items():
                names = [n for n, _ in mod.named_parameters()]
                _, mu = _adam_count_mu(j_opt[mk], mk, names)
                g_j = mu / np.float32(0.1)
                if mk not in ACTIVE[target]:
                    assert not mu.any(), mk
                    assert all(q.grad is None or not q.grad.any()
                               for q in mod.parameters()), mk
                    continue
                g = torch.cat([q.grad.reshape(-1)
                               for q in mod.parameters()]).numpy()
                np.testing.assert_allclose(
                    g, g_j, rtol=RTOL, atol=RTOL * np.abs(g_j).max(),
                    err_msg=mk)
        # inactive modules stay bit-identical to the start
        for mk in mods:
            if mk in ACTIVE[target]:
                continue
            want = from_jax({mk: params0[mk]})
            for name, value in mods[mk].state_dict().items():
                assert torch.equal(value, want[f"{mk}.{name}"]), (mk, name)


@pytest.mark.parametrize("epoch", [1, 2, 3, None])
def test_draw_order_matches_rngstream(jax_model, epoch, monkeypatch):
    """Trace the JAX forward abstractly, recording which fold of the
    RngStream each jax.random draw consumes and its shape, and hold the
    record against the port's ``draws`` (None: the TEST-target eval)."""
    keys, record = [], []
    next_ = RngStream.next

    def recording_next(self):
        k = next_(self)
        keys.append((k, self._count - 1))
        return k

    def recorder(kind, fn, shape_of):
        def draw(key, *args, **kwargs):
            fold = next(i for k, i in keys if k is key)
            record.append((fold, kind, tuple(shape_of(*args, **kwargs))))
            return fn(key, *args, **kwargs)
        return draw

    monkeypatch.setattr(RngStream, "next", recording_next)
    for kind, name, shape_of in (
            ("uniform", "uniform", lambda shape, *a, **k: shape),
            ("normal", "normal", lambda shape, *a, **k: shape),
            ("gumbel", "gumbel", lambda shape, *a, **k: shape),
            ("bernoulli", "bernoulli", lambda p, shape, *a, **k: shape),
            ("gumbel", "categorical", lambda logits, *a, **k: logits.shape)):
        monkeypatch.setattr(jax.random, name,
                            recorder(kind, getattr(jax.random, name),
                                     shape_of))
    stage = JaxStage.TRAIN if epoch else JaxStage.TEST
    jax_model.on_stage_start(stage, epoch)
    jax.eval_shape(lambda pp, ss, bb, rr: jax_model.compute_forward(
        pp, ss, bb, stage, rr, epoch or 1)[0], jax_model.params,
        jax_model.states, jax_synth_batch(B, T, L, seed=0),
        jax.random.PRNGKey(0))

    port = build_md_vae(batch_size=B, overrides=SMALL, device="cpu")
    port.on_stage_start(Stage.TRAIN if epoch else Stage.TEST, epoch)
    draws = port.draws(B, T, train=epoch is not None)
    assert record == [(i, kind, tuple(shape))
                      for i, (_, kind, shape, _, _) in enumerate(draws)]
