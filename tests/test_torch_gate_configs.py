"""The port's BASELINE gate configs against the JAX compositions of
``tests/test_gate_configs.py``: three Adam steps of each of the four gates
(``bench_utils.build_gate``) against the same steps with ``optax.adam``,
every draw replayed, gate 3 also under AMP; ``nn.conv`` (``Conv2d`` at
stride 1 and 2 and even and odd sizes, which covers XLA's SAME padding,
``max_pool``, ``layer_norm``) against ``mlvae_tpu.nn.conv``; and gate 4's
padding invariance.

Tolerances, with their reasons: in f32 losses within 1e-4 relative and
each parameter tensor within 1e-4 relative in norm (``||p - p_jax|| /
||p_jax||``): the sums run in another order, and Adam divides each
gradient by its own running size, which magnifies the relative error of a
gradient entry near zero in that entry alone. Under AMP losses within
1e-3 and parameters within 1e-2: JAX sums a bf16 bias gradient with bf16
roundings where torch sums in f32 and rounds once (about 1e-2 apart). The
JAX gate 3 runs its scan in f32, as the JAX test does; under AMP the JAX
GRU's Pallas dispatch is forced on and its kernel runs in interpret mode
(on the CPU it would take a bf16-carry scan, which is not what the TPU
runs at H=512) and the port's GRU route is pinned to K5 alike, and the
JAX step runs op by op: under ``jit`` XLA may keep fused
bf16 intermediates in f32 (excess precision), where the port, as the
Pallas kernels, rounds each.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.gru_pallas as gp
from mlvae_tpu.modules.conv_vae import ConvVAE as JConvVAE
from mlvae_tpu.modules.grouped_vae import (GroupedLatentVAE as JGrouped,
                                           group_elbo as jgroup_elbo)
from mlvae_tpu.modules.vanilla_vae import VanillaVAE as JVanillaVAE
from mlvae_tpu.nn import conv as jconv
from mlvae_tpu.nn import dist as JD
from mlvae_tpu.nn.layers import Linear as JLinear
from mlvae_tpu.nn.rnn import GRU as JGRU
from mlvae_tpu.utils.tensor import apply_lens_to_loss as japply_lens

from mlvae_tpu_torch import bench_utils as bu
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.nn import conv

torch.set_num_threads(2)

STEPS = 3
F32_RTOL = 1e-4
AMP_LOSS_RTOL = 1e-3
AMP_PARAM_RTOL = 1e-2


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def _cast(tree, dtype):
    """The JAX Brain's AMP cast of the parameters."""
    return jax.tree_util.tree_map(lambda v: v.astype(dtype), tree)


# -- the JAX compositions, as tests/test_gate_configs.py builds them --------

def _jax_gate(n, batch, amp=False):
    """(params, loss_fn(params, key), draws(key) -> the port's noise)."""
    S = bu.GATE_TEST[n]
    if n == 1:
        feats = jnp.asarray(batch["feats"].numpy())
        vae = JVanillaVAE(fc_sizes=[80, 32, 32], latent_size=8)
        head = JLinear(8, 80)
        params = {"vae": vae.init(jax.random.PRNGKey(0)),
                  "head": head.init(jax.random.PRNGKey(1))}

        def loss_fn(p, rng):
            out = vae.apply(p["vae"], feats, rng=rng)
            recon = head.apply(p["head"], out["sampled_h"])
            return jnp.mean((recon - feats) ** 2) + 1e-3 * jnp.mean(
                out["loss"])

        def draws(key):
            return {"eps": jax.random.normal(jax.random.fold_in(key, 0),
                                             (1, 50, 8))}
    elif n == 2:
        patches = jnp.asarray(batch["patches"].numpy())
        vae = JConvVAE(patch_shape=(16, 40), latent_size=16, channels=(8, 16))
        params = {"vae": vae.init(jax.random.PRNGKey(0))}

        def loss_fn(p, rng):
            out = vae.apply(p["vae"], patches, rng=rng)
            return jnp.mean(out["recon_loss"]) + 1e-3 * jnp.mean(out["loss"])

        def draws(key):
            return {"eps": jax.random.normal(jax.random.fold_in(key, 0),
                                             (8, 16))}
    elif n == 3:
        B, T, C, H, LAT = S["B"], S["T"], S["C"], S["H"], S["LAT"]
        feats = jnp.asarray(batch["feats"].numpy())
        lens = jnp.asarray(batch["lens"].numpy())
        enc = JGRU(C, H, num_layers=1, batch_first=True)
        dec = JGRU(LAT, H, num_layers=1, batch_first=True,
                   bidirectional=True)
        heads = {"mean": JLinear(H, LAT), "log_var": JLinear(H, LAT),
                 "out": JLinear(2 * H, C)}
        params = {
            "enc": enc.init(jax.random.PRNGKey(0)),
            "dec": dec.init(jax.random.PRNGKey(1)),
            **{k: m.init(jax.random.fold_in(jax.random.PRNGKey(2), i))
               for i, (k, m) in enumerate(heads.items())},
        }

        def loss_fn(p, rng):
            x = feats
            if amp:   # Brain.train_step's casts under auto_mix_prec
                p, x = _cast(p, jnp.bfloat16), feats.astype(jnp.bfloat16)
            h, _ = enc.apply(p["enc"], x)
            mean = heads["mean"].apply(p["mean"], h)
            log_var = heads["log_var"].apply(p["log_var"], h)
            z = JD.reparameterize(rng, mean, log_var)
            dh, _ = dec.apply(p["dec"], z)
            recon = heads["out"].apply(p["out"], dh)
            recon, mean, log_var = (v.astype(jnp.float32)
                                    for v in (recon, mean, log_var))
            recon_l = japply_lens((recon - feats) ** 2, lens)
            kld_l = japply_lens(JD.kld_std_normal(mean, log_var), lens)
            return recon_l + 1e-3 * kld_l

        def draws(key):
            return {"eps": jax.random.normal(key, (B, T, LAT))}
    else:
        feats = jnp.asarray(batch["feats"].numpy())
        lens = jnp.asarray(batch["lens"].numpy())
        vae = JGrouped(fc_sizes=[24, 32, 32], frame_latent_size=6,
                       utt_latent_size=4, dec_fc_sizes=[32, 24])
        params = {"vae": vae.init(jax.random.PRNGKey(0))}

        def loss_fn(p, rng):
            out = vae.apply(p["vae"], feats, lens, rng=rng)
            return jgroup_elbo(out, feats, lens, kld_weight=1e-3)

        def draws(key):
            B, T = feats.shape[:2]
            return {"eps_frame": jax.random.normal(
                jax.random.fold_in(key, 0), (B, T, 6)),
                "eps_utt": jax.random.normal(jax.random.fold_in(key, 1),
                                             (B, 4))}
    return params, loss_fn, draws


def _rel(got, want):
    """``||got - want|| / ||want||``."""
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - want)
                 / (np.linalg.norm(want) or 1.0))


def _spy_gru_interpret(monkeypatch):
    real = gp.gru_layer
    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(
        gp, "gru_layer",
        lambda gx, w, b, reverse=False, interpret=False:
        real(gx, w, b, reverse, True))
    # the port on the kernel path alike: at this narrow H a bf16 GRU
    # layer routes to the bf16-carry scan in both packages otherwise
    # (tests/test_torch_rnn_scan.py holds that route)
    from mlvae_tpu_torch.nn import rnn as prnn
    monkeypatch.setattr(prnn, "gru_route", lambda H, dtype: "k5")


@pytest.mark.parametrize("n,amp", [(1, False), (2, False), (3, False),
                                   (4, False), (3, True)])
def test_gate_train_steps_match_jax(n, amp, monkeypatch):
    if amp:
        _spy_gru_interpret(monkeypatch)
    gate = bu.build_gate(n, device="cpu", amp=amp)
    batch = bu.gate_batch(n, device="cpu")
    params, loss_fn, draws = _jax_gate(n, batch, amp)
    gate.load_state_dict(from_jax(params))
    gate.init_optimizer()
    opt = optax.adam(gate.lr)
    state = opt.init(params)

    def step(p, s, rng):
        loss, grads = jax.value_and_grad(loss_fn)(p, rng)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    if not amp:
        step = jax.jit(step)

    loss_tol, param_tol = (AMP_LOSS_RTOL, AMP_PARAM_RTOL) if amp else \
        (F32_RTOL, F32_RTOL)
    for i in range(STEPS):
        key = jax.random.PRNGKey(i)
        noise = {k: _t(v) for k, v in draws(key).items()}
        assert {k: tuple(v.shape) for k, v in noise.items()} == \
            gate.draws(batch)
        params, state, loss_j = step(params, state, key)
        loss = gate.train_step(batch, noise)
        assert abs(float(loss) - float(loss_j)) <= loss_tol * abs(
            float(loss_j)), (i, float(loss), float(loss_j))
        want = from_jax(params)
        for name, p in gate.named_parameters():
            assert p.dtype == torch.float32
            assert _rel(p, want[name]) <= param_tol, (i, name)
    assert all(v.dtype == torch.float32 for v in
               (gate.opt_state["mu"], gate.opt_state["nu"]))


@pytest.mark.parametrize("k,stride,size", [
    (3, 1, (16, 40)), (3, 1, (7, 9)), (3, 2, (16, 40)), (3, 2, (7, 9)),
    (4, 1, (6, 5)), (4, 2, (9, 6))])
def test_conv2d_matches_jax(k, stride, size):
    """Values and the weight's and input's gradients; the SAME padding of
    stride 2 on an even size puts its one padded row after."""
    jmod = jconv.Conv2d(3, 5, k, stride=(stride, stride))
    params = jmod.init(jax.random.PRNGKey(8))
    mod = conv.Conv2d(3, 5, k, stride=stride)
    mod.load_state_dict(from_jax(params))
    rs = np.random.RandomState(9)
    x = rs.randn(2, *size, 3).astype(np.float32)
    y_j = jmod.apply(params, jnp.asarray(x))
    w_out = rs.randn(*y_j.shape).astype(np.float32)
    gp_j, gx_j = jax.grad(
        lambda p, xx: jnp.sum(jmod.apply(p, xx) * w_out), argnums=(0, 1))(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = mod(xt)
    assert tuple(y.shape) == tuple(y_j.shape)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-6)
    (y * torch.from_numpy(w_out)).sum().backward()
    assert _rel(xt.grad, gx_j) <= 1e-5
    for name in ("weight", "bias"):
        assert _rel(getattr(mod, name).grad, gp_j[name]) <= 1e-5, name


def test_same_padding_is_xla_s():
    assert conv.same_padding(16, 3, 2) == (0, 1)
    assert conv.same_padding(7, 3, 2) == (1, 1)
    assert conv.same_padding(16, 3, 1) == (1, 1)
    assert conv.same_padding(6, 4, 1) == (1, 2)


@pytest.mark.parametrize("window,strides", [((2, 2), (2, 2)),
                                            ((3, 2), (1, 2))])
def test_max_pool_matches_jax(window, strides):
    x = np.random.RandomState(10).randn(2, 9, 10, 3).astype(np.float32)
    want = jconv.max_pool(jnp.asarray(x), window, strides)
    got = conv.max_pool(torch.from_numpy(x), window, strides)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rs = np.random.RandomState(11)
    x = jnp.asarray(rs.randn(3, 5, 16) * 2 + 1, jd)
    gamma = rs.randn(16).astype(np.float32)
    beta = rs.randn(16).astype(np.float32)
    want = jconv.layer_norm(x, gamma, beta)
    got = conv.layer_norm(_t(x).to(td), torch.from_numpy(gamma),
                          torch.from_numpy(beta))
    assert got.dtype == td
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else \
        dict(rtol=0, atol=float(2.0 ** -7) * 8)   # one bf16 ulp at |y| < 8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_gate4_padding_invariance():
    """Changing the padded frames of an utterance does not move its
    utterance posterior (the masked pooling)."""
    gate = bu.build_gate(4, device="cpu")
    batch = bu.gate_batch(4, device="cpu")
    noise = {k: torch.zeros(s) for k, s in gate.draws(batch).items()}
    feats2 = batch["feats"].clone()
    feats2[-1, 15:, :] = 99.0   # utterance 5 has 10 valid frames
    with torch.no_grad():
        out = gate.vae(batch["feats"], batch["lens"], **noise)
        out2 = gate.vae(feats2, batch["lens"], **noise)
    np.testing.assert_allclose(out["utt_mean"][-1].numpy(),
                               out2["utt_mean"][-1].numpy(), rtol=1e-6)
    assert not torch.equal(out["recon"][-1], out2["recon"][-1])
