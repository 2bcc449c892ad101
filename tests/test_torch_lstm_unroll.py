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


def test_f32_fused_k_reaches_the_device_check():
    """K7b on f32 streams is ported (the K entry point of K3/K4-fwd's f32
    build): the check the CUDA path runs takes f32 streams, and a tensor
    on neither the CPU nor a card (meta) passes the dtype checks and
    reaches the device check, never the plain version."""
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
        pu.run_fwd_k(torch.empty((4, 2, 512), **m),
                     torch.empty((512, 128), **m), False, 2)
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


# The launch plans of the three redesigned builds (``k7a_plan``,
# ``k7b_plan``), integers only: which shapes fit and which are refused.
# The card holds each build's ``*_plan`` entry point against them
# (chip_smoke.py phase 2).
PLAN_KS = (1, 2, 4, 8)
PLAN_BS = (1, 63, 64, 65, 128, 256, 320)


def _deepest(fits, hi):
    """The largest n in [1, hi] with fits(n), else 0."""
    return next((n for n in range(hi, 0, -1) if fits(n)), 0)


@pytest.mark.parametrize("K", PLAN_KS)
@pytest.mark.parametrize("B", PLAN_BS)
def test_k7a_f32_plan_fits_every_h(K, B):
    """f32 K7a takes every H % 16 == 0 up to 528 at K <= 8 and any B: K1-fwd's
    deepest ring that fits beside the staged gates of the first four batch
    tiles, then two gates buffers where they fit."""
    ntiles = -(-B // 64)
    for H in range(16, 529, 16):
        p = pu.k7a_plan(H, B, K)
        assert (p.build, p.blocks, p.threads) == ("lstm_unroll_fwd", H // 4,
                                                  256)
        assert p.blocks <= 132 and p.smem_bytes <= pu.SMEM_LIMIT
        assert p.tiles == min(ntiles, 4)
        assert p.smem_bytes == pu.k7a_f32_smem_bytes(H, B, K, p.ring, p.bufs)
        assert p.ring == _deepest(lambda n: pu.k7a_f32_smem_bytes(
            H, B, K, n, 1) <= pu.SMEM_LIMIT, 4 * ntiles), (H, B, K)
        assert p.bufs == (2 if pu.k7a_f32_smem_bytes(H, B, K, p.ring, 2)
                          <= pu.SMEM_LIMIT else 1)
    for H in (8, 24, 544, 1024):
        with pytest.raises(ValueError, match="multiple of 16 up to 528"):
            pu.k7a_plan(H, B, K)


@pytest.mark.parametrize("K", PLAN_KS)
@pytest.mark.parametrize("B", PLAN_BS)
def test_k7a_bf16_plan_fits_every_h(K, B):
    """bf16 K7a takes every H % 128 == 0 up to 1024 at K <= 8 and any B: the
    most batch tiles whose gates fit beside the h_{t-1} tile, then two
    buffers where they fit."""
    ntiles = -(-B // 64)
    for H in range(128, 1025, 128):
        p = pu.k7a_plan(H, B, K, bf16=True)
        assert (p.build, p.blocks, p.ring) == ("lstm_unroll_fwd_bf16",
                                               H // 8, H // 128)
        assert p.smem_bytes <= pu.SMEM_LIMIT
        assert p.smem_bytes == pu.k7a_bf16_smem_bytes(H, K, p.tiles, p.bufs)
        assert p.tiles == _deepest(lambda n: pu.k7a_bf16_smem_bytes(
            H, K, n, 1) <= pu.SMEM_LIMIT, ntiles), (H, B, K)
        assert p.bufs == (2 if pu.k7a_bf16_smem_bytes(H, K, p.tiles, 2)
                          <= pu.SMEM_LIMIT else 1)
    for H in (16, 64, 192, 528, 1152):
        with pytest.raises(ValueError, match="H % 128 == 0 up to 1024"):
            pu.k7a_plan(H, B, K, bf16=True)


def _parent_k7b_smem(In, H, B, K):
    """Shared memory of the K7b design before the redesign: the
    pre-activations, K steps' accumulators a batch tile, the weights and
    one 256-column chunk at pitch 264."""
    return (4 * 64 * 16 + 16 * K * -(-B // 64) * 256
            + 2 * (16 * (In + H + 8) + 64 * 264))


@pytest.mark.parametrize("K", PLAN_KS)
@pytest.mark.parametrize("B", PLAN_BS)
@pytest.mark.parametrize("In", [128, 512, 1024])
def test_k7b_plan_fits_every_shape_the_parent_took(K, B, In):
    """K7b keeps every batch tile in one pass with K slots where B <= 256
    and they fit beside a chunk tile a batch tile, else K3/K4-fwd's serial
    schedule; every shape the parent design took still fits."""
    ntiles = -(-B // 64)
    for H in range(16, 529, 16):
        p = pu.k7b_plan(In, H, B, K)
        assert (p.build, p.blocks) == ("lstm_unroll_fused_fwd", H // 4)
        assert p.smem_bytes <= pu.SMEM_LIMIT
        ahead = ntiles <= 4 and pu.k7b_smem_bytes(
            In, H, ntiles, ntiles, K, True) <= pu.SMEM_LIMIT
        assert p.serial == (not ahead), (In, H, B, K)
        if ahead:
            assert (p.bufs, p.tiles) == (K, ntiles)
            assert p.ring == _deepest(lambda n: n >= ntiles and pu.
                                      k7b_smem_bytes(In, H, ntiles, n, K,
                                                     True) <= pu.SMEM_LIMIT,
                                      ntiles * -(-H // 128))
        else:
            assert (p.ring, p.bufs, p.tiles) == (2, 1, 1)
        if _parent_k7b_smem(In, H, B, K) <= pu.SMEM_LIMIT:
            assert p.smem_bytes <= pu.SMEM_LIMIT
    for In, H in ((12, 64), (128, 24), (128, 544)):
        with pytest.raises(ValueError, match="In a multiple of 8"):
            pu.k7b_plan(In, H, B, K)


def test_plans_at_the_unroll_bench_shape():
    """B=128, H=512, In=512: f32 K7a keeps K1-fwd's ring of 5 at K <= 2, 4
    at K=4 and 3 at K=8 beside one gates buffer; bf16 K7a double-buffers
    both tiles' gates at every K; K7b keeps both tiles in one pass with K
    slots and 8, 7 and 5 chunk tiles of h_{t-1} at K 2, 4, 8."""
    assert [(p.ring, p.bufs) for p in (pu.k7a_plan(512, 128, K)
                                       for K in (1, 2, 4, 8))] == [
        (5, 2), (5, 1), (4, 1), (3, 1)]
    assert all((p.ring, p.bufs, p.tiles) == (4, 2, 2) for p in (
        pu.k7a_plan(512, 128, K, bf16=True) for K in (1, 2, 4, 8)))
    assert [(p.ring, p.bufs, p.tiles, p.serial) for p in (
        pu.k7b_plan(512, 512, 128, K) for K in (2, 4, 8))] == [
        (8, 2, 2, False), (7, 4, 2, False), (5, 8, 2, False)]


def test_bf16_k7a_at_h64_is_refused_before_the_device():
    """The JAX dispatch sends no bf16 layer of H % 128 != 0 to a Pallas
    kernel; K7a on bf16 streams refuses H=64 on a meta tensor, naming the
    rule, before any device check; f32 streams take it and reach the
    device check."""
    m = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"H % 128 == 0 .*rnn.py:100-102"):
        pu.run_fwd_k(torch.empty((8, 33, 256), **m),
                     torch.empty((256, 64), **m), False, 2)
    m32 = dict(device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        pu.run_fwd_k(torch.empty((8, 33, 256), **m32),
                     torch.empty((256, 64), **m32), False, 2)
