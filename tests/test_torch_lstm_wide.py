"""K1 above H=528: the kernel contract at LSTM_FC's H=1024 and the launch
plan of the narrow and wide builds.

The port's plain recurrence and plain BPTT (what the wide K1-fwd and
K1-bwd are held to on the card) against the JAX package's Pallas
``lstm_layer`` and its VJP in interpret mode at T=3, B=8, H=1024, both
directions, f32, rtol 1e-5 and atol 1e-6 (sums in another order). Then
``ops.k1_plan`` for every H the launches take: the narrow plan unchanged
up to 528, the wide plan above it, every grid co-resident on an H100 and
every block within its shared memory, H above 1024 refused; and the
plan's constants against the ones ``csrc/lstm_wide.cuh`` compiles with."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax

from mlvae_tpu.ops.lstm_pallas import lstm_layer

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops import k1_plan as P
from mlvae_tpu_torch.ops import lstm as L
from mlvae_tpu_torch.tools import bench_bwd_timeline as btl
from mlvae_tpu_torch.tools import bench_wide_ablation as abl
from mlvae_tpu_torch.tools import bench_fwd_timeline as ftl

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
T, B, H = 3, 8, 1024
CSRC = Path(L.__file__).resolve().parent.parent / "csrc"


def _problem(seed):
    rs = np.random.RandomState(seed)
    return ((rs.randn(T, B, 4 * H) * 0.5).astype(np.float32),
            ((rs.rand(4 * H, H) * 2 - 1) / np.sqrt(H)).astype(np.float32),
            (rs.randn(T, B, H) * 0.1).astype(np.float32),
            (rs.randn(B, H) * 0.1).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_recurrence_matches_pallas_kernel_at_h1024(reverse):
    gx, w, _, _ = _problem(11)
    hs_j, c_last_j = lstm_layer(jnp.asarray(gx), jnp.asarray(w), reverse,
                                True)
    hs, cs = L.lstm_layer_ref(torch.from_numpy(gx), torch.from_numpy(w),
                              reverse)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), RTOL, ATOL)
    np.testing.assert_allclose((cs[0] if reverse else cs[-1]).numpy(),
                               np.asarray(c_last_j), RTOL, ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_bptt_matches_pallas_backward_at_h1024(reverse):
    gx, w, dhs, dc_last = _problem(12)
    _, vjp = jax.vjp(lambda g, ww: lstm_layer(g, ww, reverse, True),
                     jnp.asarray(gx), jnp.asarray(w))
    dgx_j, dw_j = vjp((jnp.asarray(dhs), jnp.asarray(dc_last)))
    t = torch.from_numpy
    hs, cs = L.lstm_layer_ref(t(gx), t(w), reverse)
    dgx, dw = L.lstm_layer_bwd_ref(t(gx), t(w), hs, cs, t(dhs), t(dc_last),
                                   reverse)
    np.testing.assert_allclose(dgx.numpy(), np.asarray(dgx_j), RTOL, ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), RTOL, ATOL)
    # on CPU tensors the wrappers are the plain versions, bit for bit
    dgx_w, dw_w = L.lstm_layer_bwd(t(gx), t(w), hs, cs, t(dhs), t(dc_last),
                                   reverse)
    assert torch.equal(dgx_w, dgx) and torch.equal(dw_w, dw)


BATCHES = (1, 63, 64, 65, 128, 256)


@pytest.mark.parametrize("Bn", BATCHES)
def test_plan_for_every_h_the_launches_take(Bn):
    for Hn in range(16, 1025, 16):
        for plan in (P.k1_fwd_plan(Hn, Bn), P.k1_bwd_plan(Hn, Bn)):
            wide = Hn > 528
            assert plan.variant == ("wide" if wide else "narrow"), Hn
            assert plan.units == (8 if wide else 4)
            assert plan.blocks * plan.units == Hn
            assert plan.blocks <= P.SMS, (Hn, plan)   # all co-resident
            assert plan.threads == 256
            assert 0 < plan.smem_bytes <= P.SMEM_LIMIT, (Hn, plan)
            assert plan.ring >= (2 if wide else 1)


@pytest.mark.parametrize("Bn", BATCHES)
def test_narrow_plan_is_the_narrow_builds_layout(Bn):
    # H <= 528 keeps the layout the narrow kernels compute (the mirrors of
    # tools/bench_*_timeline.py)
    for Hn in range(16, 529, 16):
        f = P.k1_fwd_plan(Hn, Bn)
        assert f.ring == ftl.k1_ring_depth(Hn, Bn) >= 4
        assert f.smem_bytes == ftl.k1_smem_bytes(Hn, f.ring)
        b = P.k1_bwd_plan(Hn, Bn)
        assert b.smem_bytes == btl.k1_bwd_smem_bytes(Hn)
        assert (b.split, b.cols) == btl.k1_bwd_schedule(Bn, Hn)
        assert b.ring == -(-Hn // 32)


@pytest.mark.parametrize("Hn, fwd, bwd", [(1024, 200704, 208896),
                                          (768, 167936, 176128),
                                          (544, 139264, 147456)])
def test_wide_shared_memory(Hn, fwd, bwd):
    # W_hh's 32 rows and two 128 x 68 chunk buffers (which the K slices'
    # partials reuse), and for K1-bwd the dgates (64 x 32), f32
    assert P.k1_fwd_plan(Hn, 64).smem_bytes == fwd \
        == 4 * (32 * Hn + 2 * 128 * 68)
    assert P.k1_bwd_plan(Hn, 64).smem_bytes == bwd == fwd + 4 * 64 * 32


@pytest.mark.parametrize("Hn", [1040, 1536, 2048])
def test_h_above_1024_is_refused_naming_the_roadmap(Hn):
    for plan in (P.k1_fwd_plan, P.k1_bwd_plan):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
            plan(Hn, 64)


@pytest.mark.parametrize("Hn", [0, 8, 520, 1000])
def test_h_off_the_grid_is_refused(Hn):
    for plan in (P.k1_fwd_plan, P.k1_bwd_plan):
        with pytest.raises(ValueError):
            plan(Hn, 64)


def _cuh_constant(name):
    text = (CSRC / "lstm_wide.cuh").read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    return m.group(1).strip()


def test_widest_partials_fit_in_the_ring():
    # the K slices' sums of an 8 x 8 product (eight slices of 64 x 32)
    # reuse the ring, and a K1-bwd chunk of eight batch rows of H fits in
    # one of its buffers
    assert 8 * P.BT * 32 <= P.WIDE_RING * P.CHUNK * P.PITCH
    assert 8 * P.WIDE_MAX_H <= P.CHUNK * P.PITCH


def test_plan_constants_are_the_kernels():
    assert int(_cuh_constant("UNITS")) == P.WIDE_UNITS
    assert int(_cuh_constant("THREADS")) == P.WIDE_THREADS
    assert int(_cuh_constant("CHUNK")) == P.CHUNK
    assert int(_cuh_constant("RING")) == P.WIDE_RING
    assert int(_cuh_constant("BT")) == P.BT
    assert int(_cuh_constant("MAX_H")) == P.WIDE_MAX_H
    assert _cuh_constant("PITCH") == "BT + 4" and P.PITCH == P.BT + 4


@pytest.mark.parametrize("Hn", [640, 1024])
@pytest.mark.parametrize("Bn", [1, 64, 70])
def test_wide_scratch(Hn, Bn):
    gx = torch.zeros((5, Bn, 4 * Hn))
    dc_last = torch.randn((Bn, Hn))
    part, dh_buf, dc_buf, barrier = L.k1_bwd_scratch(gx, dc_last)
    # (slot, writing block, unit group, row, unit): H/8 blocks of 8 units
    assert part.shape == (2, Hn // 8, Bn, Hn)
    assert not dh_buf.any() and torch.equal(dc_buf, dc_last)
    assert barrier.shape == (1,) and not barrier.any()
    slab = L.k1_bwd_hs_slab(torch.zeros((5, Bn, Hn)))
    assert slab.shape == (5, Hn, -(-Bn // 4) * 4)
    assert slab.dtype == torch.float32


def test_wide_kernels_are_built_registered_and_bound():
    for name, kernel, nargs in (("lstm_fwd_wide", L.LSTM_FWD_WIDE, 11),
                                ("lstm_bwd_wide", L.LSTM_BWD_WIDE, 17)):
        assert name in _build.SOURCES and (CSRC / f"{name}.cu").is_file()
        assert kernel in _build.KERNELS and kernel.source == name
        assert len(kernel.argtypes) == nargs
        text = (CSRC / f"{name}.cu").read_text()
        sig = re.search(rf"int mlvae_{name}\(([^)]*)\)", text).group(1)
        assert sig.count(",") + 1 == nargs, name
        assert f"mlvae_{name}_error_string" in text
        assert f"mlvae_{name}_plan" in text


@pytest.mark.parametrize("name", sorted(abl.ABLATIONS))
def test_each_ablation_finds_its_text_once(name):
    src, subs = abl.ABLATIONS[name]
    files = abl.patched(subs)
    assert f"{src}.cu" in files
    changed = {f for f, text in files.items()
               if text != (CSRC / f).read_text()}
    assert changed == {f for f, _, _ in subs}


def test_ablation_tool_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        abl.main([])
