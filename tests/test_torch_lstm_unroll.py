"""The port's K-unrolled LSTM forwards (K7a, K7b) against the JAX package:
the plain versions ``run_fwd_k_ref`` / ``run_fwd_fused_k_ref`` against the
Pallas kernels ``run_fwd_k`` / ``run_fwd_fused_k`` in interpret mode, f32
and bf16, both directions, K in {2, 4}, at the JAX test's shape (B=8,
T=12, H=128, In=128, inputs from ``np.random.RandomState(0)`` as
``tests/test_lstm_unroll_exp.py`` makes them); ``lstm_layer_ref`` in bf16
against ``lstm_pallas._run_fwd``, which needs its rounding of h_{t-1} to
bf16 before the product; that the plain versions do not depend on K; the
wrappers' refusals; and the port's unroll A/B tool on the CPU.

Tolerances, with their reasons: f32 rtol 1e-5 / atol 1e-6 (sums in another
order). bf16: the plain versions round where the Pallas kernels round, but
an f32 sum taken in another order can land on the other side of a bf16
rounding boundary and a flipped h_t feeds every later step: hs and cs
within 4e-3 absolute (one bf16 ulp, 2^-8, at |h| <= 1).
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlvae_tpu.ops import lstm_pallas as lp
from mlvae_tpu.ops import lstm_unroll_exp as lu

from mlvae_tpu_torch.ops import lstm as pl
from mlvae_tpu_torch.ops import lstm_unroll_exp as pu
from mlvae_tpu_torch.tools import bench_lstm_unroll as bench

torch.set_num_threads(2)

B, T, H, IN = 8, 12, 128, 128
F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 4e-3
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _data(dtype):
    """(JAX arrays, torch tensors) of gx, x, w_ih, w_hh in ``dtype`` and the
    f32 bias, the same values on both sides."""
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(0)
    gx = jnp.asarray(rs.randn(T, B, 4 * H).astype(np.float32), jd)
    x = jnp.asarray(rs.randn(T, B, IN).astype(np.float32), jd)
    w_ih = jnp.asarray(rs.randn(4 * H, IN).astype(np.float32) * 0.05, jd)
    w_hh = jnp.asarray(rs.randn(4 * H, H).astype(np.float32) * 0.05, jd)
    bias = jnp.asarray(rs.randn(4 * H).astype(np.float32) * 0.05)
    j = (gx, x, w_ih, w_hh, bias)
    t = tuple(torch.from_numpy(_np(v)).to(td if i < 4 else torch.float32)
              for i, v in enumerate(j))
    return j, t


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.array(jnp.asarray(v, jnp.float32))


def _close(got, want, dtype, name):
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name,
                                   **F32_TOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=BF16_ATOL, err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("K", [2, 4])
def test_run_fwd_k_ref_matches_pallas_kernel(dtype, reverse, K):
    (jgx, _, _, jwh, _), (gx, _, _, wh, _) = _data(dtype)
    hs_j, cs_j = lu.run_fwd_k(jgx, jwh, reverse, K=K, interpret=True)
    hs, cs = pu.run_fwd_k_ref(gx, wh, reverse, K)
    assert hs.dtype == gx.dtype and cs.dtype == torch.float32
    _close(hs, hs_j, dtype, "hs")
    _close(cs, cs_j, dtype, "cs")
    # on CPU tensors the wrapper is the plain version, bit for bit
    hs_w, cs_w = pu.run_fwd_k(gx, wh, reverse, K)
    assert torch.equal(hs_w, hs) and torch.equal(cs_w, cs)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_ref_bf16_matches_pallas_run_fwd(reverse):
    """K1's plain version on bf16 streams rounds h_{t-1} to bf16 before the
    recurrent product, as ``_fwd_kernel`` does. With the same rounding
    points a sum in another order flips few bf16 values over T=12 (none
    here), so at most 2 % of hs may differ at all; an f32 h_{t-1} flips
    about 9 %, each by one ulp, which the 4e-3 tolerance alone admits."""
    (jgx, _, _, jwh, _), (gx, _, _, wh, _) = _data("bf16")
    hs_j, cs_j = lp._run_fwd(jgx, jwh, reverse, interpret=True)
    hs, cs = pl.lstm_layer_ref(gx, wh, reverse)
    _close(hs, hs_j, "bf16", "hs")
    _close(cs, cs_j, "bf16", "cs")
    assert np.mean(_np(hs) != _np(hs_j)) <= 0.02


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("K", [2, 4])
def test_run_fwd_fused_k_ref_matches_pallas_kernel(dtype, reverse, K):
    (_, jx, jwi, jwh, jb), (_, x, wi, wh, b) = _data(dtype)
    hs_j, cs_j = lu.run_fwd_fused_k(jx, jwi, jb, jwh, reverse, K=K,
                                    interpret=True)
    hs, cs = pu.run_fwd_fused_k_ref(x, wi, b, wh, reverse, K)
    assert hs.dtype == x.dtype and cs.dtype == torch.float32
    _close(hs, hs_j, dtype, "hs")
    _close(cs, cs_j, dtype, "cs")
    hs_w, cs_w = pu.run_fwd_fused_k(x, wi, b, wh, reverse, K)
    assert torch.equal(hs_w, hs) and torch.equal(cs_w, cs)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_versions_do_not_depend_on_k(dtype):
    """The JAX contract on the CPU: every K gives the K=1 result, bit for
    bit, in both directions."""
    _, (gx, x, wi, wh, b) = _data(dtype)
    for reverse in (False, True):
        want = pu.run_fwd_k_ref(gx, wh, reverse, 1)
        want_f = pu.run_fwd_fused_k_ref(x, wi, b, wh, reverse, 1)
        for K in (2, 3, 4, 6, 12):
            got = pu.run_fwd_k_ref(gx, wh, reverse, K)
            got_f = pu.run_fwd_fused_k_ref(x, wi, b, wh, reverse, K)
            assert all(torch.equal(a, w) for a, w in zip(got, want)), K
            assert all(torch.equal(a, w) for a, w in zip(got_f, want_f)), K


def test_t_not_a_multiple_of_k_is_refused_on_the_cpu():
    _, (gx, x, wi, wh, b) = _data("f32")
    for K in (5, 0):
        with pytest.raises(ValueError, match="multiple of K"):
            pu.run_fwd_k(gx, wh, False, K)
        with pytest.raises(ValueError, match="multiple of K"):
            pu.run_fwd_k_ref(gx, wh, False, K)
        with pytest.raises(ValueError, match="multiple of K"):
            pu.run_fwd_fused_k(x, wi, b, wh, False, K)
        with pytest.raises(ValueError, match="multiple of K"):
            pu.run_fwd_fused_k_ref(x, wi, b, wh, False, K)


def test_f32_fused_k_is_not_ported():
    """K7b on f32 streams is ported now (the K entry point of K3/K4-fwd's
    f32 build): the check the CUDA path runs first takes f32 streams and
    gives their dtype, and a tensor on neither the CPU nor a card (meta)
    passes the dtype checks and reaches the device check, never the plain
    version."""
    _, (_, x, wi, wh, b) = _data("f32")
    with pytest.raises(ValueError, match="CUDA device"):
        pu.check_fwd_fused_k(x, wi, b, wh, 2)
    m = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        pu.run_fwd_fused_k(torch.empty((4, 2, 16), **m),
                           torch.empty((64, 16), **m),
                           torch.empty((64,), **m),
                           torch.empty((64, 16), **m), False, 2)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that lies neither on the CPU nor on a CUDA device is
    refused, never run by the plain version."""
    m = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pu.run_fwd_k(torch.empty((4, 2, 64), **m), torch.empty((64, 16), **m),
                     False, 2)
    with pytest.raises(ValueError, match="CUDA"):
        pu.run_fwd_fused_k(torch.empty((4, 2, 16), **m),
                           torch.empty((64, 16), **m),
                           torch.empty((64,), device="meta"),
                           torch.empty((64, 16), **m), False, 2)


def test_bench_tool_runs_every_arm_on_the_cpu(capsys):
    assert bench.main(["--device", "cpu", "--shape", "4,8,16,24",
                       "--iters", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert res["device"] == "cpu"
    assert res["shape"] == {"B": 4, "T": 8, "H": 16, "In": 24}
    arms = {(a["arm"], a["dtype"]): a for a in res["arms"]}
    assert set(arms) == {("plain", "f32"), ("plain", "bf16"),
                         ("fused", "bf16"), ("fused", "f32")}
    for key in arms:
        a = arms[key]
        assert set(a["K"]) == {"2", "4", "8"}, key
        assert all(k["max_abs"] == 0.0 and k["ms"] > 0
                   for k in a["K"].values()), key
        assert a["twin_ms"] > 0 and a["library_ms"] > 0 \
            and a["bound_ms"] > 0, key
        assert a["bound_by"] in ("bytes", "operations"), key


def test_bench_bounds_at_the_bench_shape():
    """The unroll bench's bounds (B=128, T=160, H=512, In=512): K7a f32
    42.95 GFLOP at 67 TFLOP/s, K7a bf16 148.9 MB at 3.35 TB/s, K7b 85.9
    GFLOP at 989 TFLOP/s, and at 67 TFLOP/s on f32 streams."""
    Bb, Tb, Hb, Ib = bench.SHAPE
    ms, by = bench.plain_bound(Tb, Bb, Hb, False)
    assert by == "operations" and ms == pytest.approx(0.641, abs=5e-4)
    ms, by = bench.plain_bound(Tb, Bb, Hb, True)
    assert by == "bytes" and ms == pytest.approx(0.0444, abs=5e-5)
    ms, by = bench.fused_bound(Tb, Bb, Ib, Hb)
    assert by == "operations" and ms == pytest.approx(0.0869, abs=5e-5)
    ms, by = bench.fused_bound(Tb, Bb, Ib, Hb, bf16=False)
    assert by == "operations" and ms == pytest.approx(1.282, abs=5e-4)


def test_bench_tool_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--iters", "1"])
