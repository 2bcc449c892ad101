"""The AMP (bf16) training slice: MD_VAE's train step with ``auto_mix_prec``
on in the port against the JAX package's jitted train step with
``auto_mix_prec`` on, at narrow widths (H=128, 2 layers, B=4, T=24, L=4),
with the JAX weights, normalizer statistics and fresh Adam states carried
across and every draw replayed (``pi_gumbel`` in bf16, as
``jax.random.categorical`` draws it for bf16 logits). Three steps of each
target.

On the CPU the JAX LSTM would take its bf16-carry ``lax.scan``, which is
not what the TPU runs, so its Pallas dispatch is forced on
(``_pallas_eligible``) and its fused kernels run in interpret mode: every
layer takes K3 (``lstm_layer_fused``), or, with both packages' budgets
lowered alike, the decoder's In=2H layers take K4
(``lstm_layer_semifused``), as at H=512.

Tolerances, with their reasons: the two packages round to bf16 at the same
points, but XLA and PyTorch take some bf16 sums in another order (the
linears' and the LSTMs' products) and round some fused elementwise chains
once where the other rounds twice, so a value can land one bf16 ulp (2^-8
relative) apart and carry that through ten layers. Step 1's losses within
1e-2 relative; steps 2-3's within 3e-2, since Adam's first steps move each
weight by about +-lr wherever its gradient is non-zero, however small, so
the grad noise below becomes whole lr steps. Each module's applied grads
within 5e-2 relative in norm: a grad is summed from bf16-rounded
cotangents, and XLA sums a broadcast bias's grad in bf16 with more than
one rounding (measured on the CPU: 6.4e-3 of the largest entry for 96
terms, against 2.1e-3 for a sum rounded once, as PyTorch's is), so single
entries, a final bias's above all, can differ by several per cent of the
module's largest. The normalizer's statistics, computed in f32 from the
bf16 features, within 1e-5. The decoded sequences of the VAE target are
compared exactly, and where they differ the test says by how many labels
and how many bf16 roundings the π logits are apart.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.lstm_pallas as lp
from mlvae_tpu.bench_utils import build_md_vae as jax_build_md_vae
from mlvae_tpu.bench_utils import synth_batch as jax_synth_batch
from mlvae_tpu.training.brain import Stage as JaxStage

import mlvae_tpu_torch.ops.lstm as pl
from mlvae_tpu_torch.bench_utils import RECIPE, build_md_vae, synth_batch
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.models.MD_VAE.model import Target
from mlvae_tpu_torch.training.brain import Stage, cast_floats

torch.set_num_threads(2)

H = 128
SMALL = {"phn_rnn_hidden_size": H, "boundary_rnn_hidden_size": H,
         "rnn_hidden_size": H, "dec_rnn_hidden_size": H}
B, T, L = 4, 24, 4
STEPS = 3
LOSS_RTOL = 1e-2
LATER_RTOL = 3e-2
GRAD_RTOL = 5e-2
# (256 + 128) * 4H * 6 bytes is over it and (256 + 128) * 4H * 2 +
# 4H * H * 4 under: the decoder's In=2H layers take the semi-fused tier
SEMI_BUDGET = 1_000_000
TARGETS = {1: Target.PHN_RECOG, 2: Target.B_DETECTOR, 3: Target.VAE}
ACTIVE = {
    Target.PHN_RECOG: {"phoneme_recognizer"},
    Target.B_DETECTOR: {"boundary_detector"},
    Target.VAE: {"feat_fc", "phn_recog_fc", "concat_fc", "rnn", "pi_fc",
                 "encoder", "decoder"},
}
DECODED = ("decoded_boundary_seq", "decoded_flvl_md_lbl_seq",
           "decoded_plvl_md_lbl_seq")


def _replay(draws, rng):
    """The port's named draws made as the JAX step makes them: draw i from
    ``fold_in(rng, i)`` in the draw's dtype; repeated names (dropout gaps)
    become lists."""
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


@pytest.fixture
def patched(monkeypatch, request):
    """Force the JAX module's Pallas dispatch (kernels in interpret mode)
    and, for ``semi``, lower both packages' budgets alike."""
    real = {"fused": lp.lstm_layer_fused, "semi": lp.lstm_layer_semifused}
    calls = []

    def spy(name):
        def f(x, w_ih, bias, w_hh, reverse=False, interpret=False):
            calls.append(name)
            return real[name](x, w_ih, bias, w_hh, reverse, True)
        return f

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer_fused", spy("fused"))
    monkeypatch.setattr(lp, "lstm_layer_semifused", spy("semi"))
    if getattr(request, "param", "") == "semi":
        monkeypatch.setattr(lp, "FUSED_RESIDENT_BUDGET", SEMI_BUDGET)
        monkeypatch.setattr(pl, "FUSED_RESIDENT_BUDGET", SEMI_BUDGET)
    return calls


def _jax_model():
    model = jax_build_md_vae(batch_size=B, overrides=dict(SMALL))
    model.run_opts["bf16"] = True
    model.auto_mix_prec = True
    model.init_params()
    model.ensure_states(RECIPE["input_size"])
    rs = np.random.RandomState(1)
    C = RECIPE["input_size"]
    model.states["normalizer"] = {
        "count": jnp.float32(12.0),
        "glob_mean": jnp.asarray(rs.randn(C).astype(np.float32) * 0.2),
        "glob_std": jnp.asarray((0.5 + rs.rand(C)).astype(np.float32))}
    model.init_optimizers()
    return model


def _mu(jstate, mk, names):
    inner = jstate.inner_state[0]
    leaves = []
    for name in names:
        leaf = inner.mu[mk]
        for part in name.split("."):
            leaf = leaf[part]
        leaves.append(np.asarray(leaf).reshape(-1))
    return np.concatenate(leaves)


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def _decode_report(preds, j_preds, pi_j):
    """How the two decodes differ: labels that differ per key, and the
    largest distance of the π logits in bf16 roundings (2^-8 relative)."""
    out = {}
    for key in DECODED:
        got, want = preds[key].numpy(), np.asarray(j_preds[key])
        out[key] = int((got != want).sum())
    pi = preds["pi_logits"].float().numpy()
    out["pi_logits_max_ulps"] = float(np.max(
        np.abs(pi - pi_j) / np.maximum(np.abs(pi_j), 1e-3) * 256))
    return out


@pytest.mark.parametrize("patched,epoch", [
    ("fused", 1), ("fused", 2), ("fused", 3), ("semi", 3)],
    indirect=["patched"])
def test_amp_train_steps_match_jax(patched, epoch):
    calls = patched
    target = TARGETS[epoch]
    jax_model = _jax_model()
    jax_model.on_stage_start(JaxStage.TRAIN, epoch)
    step = jax_model._get_compiled("train", JaxStage.TRAIN)
    jbatch = jax_synth_batch(B, T, L, seed=0)
    rngs = [jax.random.PRNGKey(200 * epoch + i) for i in range(STEPS)]
    params0 = jax.device_get(jax_model.params)
    p, o, s = (_copy(jax_model.params), _copy(jax_model.opt_states),
               _copy(jax_model.states))

    port = build_md_vae(batch_size=B, overrides=SMALL, device="cpu",
                        bf16=True)
    assert port.auto_mix_prec
    port.load_state_dict(from_jax(params0, jax.device_get(jax_model.states)))
    port.on_stage_start(Stage.TRAIN, epoch)
    batch = synth_batch(B, T, L, seed=0, device="cpu")
    mods = port.param_modules()
    semi = lp.FUSED_RESIDENT_BUDGET == SEMI_BUDGET

    if target == Target.VAE:
        # the decode inside the step on step 1's forward, both in AMP: the
        # JAX forward as its train step runs it (cast params and batch)
        def fwd(pp, ss, bb, rr):
            preds, _ = jax_model.compute_forward(
                jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), pp),
                ss, {k: tuple(v.astype(jnp.bfloat16)
                              if v.ndim >= 2 and jnp.issubdtype(
                                  v.dtype, jnp.floating) else v for v in val)
                     for k, val in bb.items()},
                JaxStage.TRAIN, rr, epoch)
            return preds
        j_preds = jax.jit(fwd)(p, s, jbatch, rngs[0])
        noise = _replay(port.draws(B, T, True), rngs[0])
        assert noise["pi_gumbel"].dtype == torch.bfloat16
        params = {n: q.to(torch.bfloat16)
                  for n, q in port.named_parameters()}
        with torch.no_grad():
            preds = torch.func.functional_call(
                port, params, (cast_floats(port.prepare_batch(batch),
                                           torch.bfloat16, 2),),
                dict(noise=noise, train=True, epoch=epoch))
        # epoch 3 freezes the normalizer's statistics: this forward leaves
        # the state the step starts from as it was
        assert preds["pi_logits"].dtype == torch.bfloat16
        pi_j = np.asarray(j_preds["pi_logits"].astype(jnp.float32))
        report = _decode_report(preds, j_preds, pi_j)
        assert all(report[k] == 0 for k in DECODED), report
        for key in ("decoded_t_lens", "decoded_l_lens"):
            np.testing.assert_array_equal(preds[key].numpy(),
                                          np.asarray(j_preds[key]))

    for i, rng in enumerate(rngs):
        calls.clear()
        p, o, s, j_loss, j_losses = step(p, o, s, rng, jbatch,
                                         jnp.int32(epoch))
        n_fused, n_semi = calls.count("fused"), calls.count("semi")
        noise = _replay(port.draws(B, T, train=True), rng)
        loss, losses = port.fit_batch(batch, epoch, noise=noise)

        # the same tiers as the JAX step traced (only the first call traces)
        if i == 0:
            n_layers = {Target.PHN_RECOG: 2, Target.B_DETECTOR: 2,
                        Target.VAE: 10}[target]
            assert n_fused + n_semi == n_layers
            assert n_semi == (2 if semi else 0)
        assert set(losses) == set(j_losses)
        rtol = LOSS_RTOL if i == 0 else LATER_RTOL
        for key in j_losses:
            assert losses[key].dtype == torch.float32
            np.testing.assert_allclose(float(losses[key]),
                                       float(j_losses[key]), rtol=rtol,
                                       err_msg=f"step {i + 1} {key}")
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=rtol)

        j_norm = jax.device_get(s["normalizer"])
        assert float(port.normalizer.count) == float(j_norm["count"])
        for key in ("glob_mean", "glob_std"):
            assert getattr(port.normalizer, key).dtype == torch.float32
            np.testing.assert_allclose(getattr(port.normalizer, key).numpy(),
                                       j_norm[key], rtol=1e-5, atol=1e-5,
                                       err_msg=key)

        # master parameters, their grads and the Adam states stay f32
        assert all(q.dtype == torch.float32 for q in port.parameters())
        assert all(v.dtype == torch.float32
                   for st in port.opt_states["optimizer"].values()
                   for v in st.values() if v.is_floating_point())
        j_opt = jax.device_get(o["optimizer"])
        counts = {mk: int(st["count"])
                  for mk, st in port.opt_states["optimizer"].items()}
        assert counts == {mk: int(j_opt[mk].inner_state[0].count)
                          for mk in j_opt}
        assert {mk for mk, c in counts.items() if c} == ACTIVE[target]
        if i == 0:
            # the clipped grads: optax's first mu is (1 - b1) * g
            for mk, mod in mods.items():
                names = [n for n, _ in mod.named_parameters()]
                g_j = _mu(j_opt[mk], mk, names) / np.float32(0.1)
                if mk not in ACTIVE[target]:
                    assert not g_j.any(), mk
                    assert all(q.grad is None or not q.grad.any()
                               for q in mod.parameters()), mk
                    continue
                g = torch.cat([q.grad.reshape(-1)
                               for q in mod.parameters()])
                assert g.dtype == torch.float32
                err = np.linalg.norm(g.numpy() - g_j) / np.linalg.norm(g_j)
                assert err < GRAD_RTOL, (mk, err)
        # inactive modules stay bit-identical to the start
        for mk in mods:
            if mk in ACTIVE[target]:
                continue
            want = from_jax({mk: params0[mk]})
            for name, value in mods[mk].state_dict().items():
                assert torch.equal(value, want[f"{mk}.{name}"]), (mk, name)


def test_amp_draws_name_bf16_pi_gumbel():
    """``draws`` marks ``pi_gumbel`` bf16 under AMP and f32 otherwise; every
    other draw is f32 either way."""
    for amp in (False, True):
        port = build_md_vae(batch_size=B, overrides=SMALL, device="cpu",
                            bf16=amp)
        port.on_stage_start(Stage.TRAIN, 3)
        dtypes = {name: dt for name, _, _, _, dt in port.draws(B, T, True)}
        assert dtypes.pop("pi_gumbel") == (torch.bfloat16 if amp
                                           else torch.float32)
        assert set(dtypes.values()) == {torch.float32}


@pytest.mark.parametrize("amp", [False, True])
def test_amp_step_sums_gemms_in_f32(amp):
    """The AMP step's forward and backward run with cuBLAS's reduced-
    precision bf16 reduction off (the JAX package's products sum in f32)
    and leave the flag as they found it; the f32 step does not touch it.
    The step draws its noise from a generator here: its losses are finite."""
    matmul = torch.backends.cuda.matmul
    seen = []
    port = build_md_vae(batch_size=B, overrides=SMALL, device="cpu",
                        bf16=amp)
    objectives = port.compute_objectives

    def spy(preds, batch):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return objectives(preds, batch)

    port.compute_objectives = spy
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        loss, _ = port.fit_batch(synth_batch(B, T, L, seed=0, device="cpu"),
                                 3, generator=torch.Generator().manual_seed(0))
        assert seen == [not amp]
        assert matmul.allow_bf16_reduced_precision_reduction
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    assert torch.isfinite(loss)


def test_amp_batch_cast_keeps_lengths_f32():
    """The AMP cast takes the batch's float arrays of ndim >= 2 to bf16 and
    leaves the 1-D relative lengths and the integer arrays alone (the JAX
    Brain's ``_cast_floats(batch, bf16, min_ndim=2)``)."""
    batch = synth_batch(B, T, L, seed=0, device="cpu")
    cast = cast_floats(batch, torch.bfloat16, 2)
    for key, (arr, lens) in cast.items():
        want = torch.bfloat16 if batch[key][0].is_floating_point() \
            else batch[key][0].dtype
        assert arr.dtype == want, key
        assert lens.dtype == torch.float32 and torch.equal(
            lens, batch[key][1]), key
