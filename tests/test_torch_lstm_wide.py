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


@pytest.mark.parametrize("Hn, fwd, bwd", [(1024, 229568, 206912),
                                          (768, 196800, 174144),
                                          (544, 168128, 145472)])
def test_wide_shared_memory(Hn, fwd, bwd):
    # K1-fwd: eight warps' rings of three 16 x 64 boxes (which the slices'
    # sums reuse), W_hh's 32 rows, f32, and an mbarrier a box; K1-bwd: four
    # slices' rings of two 64 x 32 boxes, W_hh's rows, the dgates (64 x
    # 32), the reduce's sums (64 x 8), f32, and an mbarrier a box; its
    # dW_hh kernel two stages of 32 rows of both 128-column operands
    assert P.k1_fwd_plan(Hn, 64).smem_bytes == fwd \
        == 4 * (8 * 3 * 16 * 64 + 32 * Hn) + 8 * 8 * 3
    assert P.k1_bwd_plan(Hn, 64).smem_bytes == bwd \
        == 4 * (4 * 2 * 64 * 32 + 32 * Hn + 64 * 32 + 64 * 8) + 8 * 4 * 2
    assert P.k1_dw_plan(Hn, 64, bf16=False).smem_bytes == 4 * 2 * 32 * 256


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


def _cuh_constant(name, fname="lstm_wide.cuh"):
    text = (CSRC / fname).read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    return m.group(1).strip()


def test_widest_partials_fit_in_the_ring():
    # each K slice's sums (4 gates x 8 units x 64 rows at the red pitches)
    # reuse that slice's own ring: K1-fwd's three boxes of 16 x 64, K1-bwd's
    # two of 64 x 32 (the recompute's slices of 32 columns: one 128-byte
    # swizzled box a chunk)
    assert P.RED_SLICE == 4 * (8 * 68 + 8) == 2208
    assert P.RED_SLICE <= P.WIDE_FWD_RING * P.wide_box_floats(False) == 3072
    assert P.RED_SLICE <= P.WIDE_BWD_RING * P.wide_box_floats(True) == 4096
    assert P.CHUNK // P.WIDE_BWD_SLICES * 4 == 128
    assert P.CHUNK // P.WIDE_FWD_SLICES * P.WIDE_FWD_SLICES == P.CHUNK


def _banks(words):
    """The most 4-byte words one bank serves in one pass: ``words`` maps
    each lane of a pass to the f32 words it reads or writes."""
    per_bank = {}
    for ws in words:
        for w in ws:
            per_bank.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in per_bank.values())


def _red(q, u, b):
    return q * P.RED_GATE + u * P.RED_UNIT + b


def test_red_layout_puts_a_warp_on_32_banks():
    """The slices' sums (``red_at`` of ``csrc/lstm_wide.cuh``): the cell's
    reads (lane -> row lane / 4, units 2 (lane % 4) + e, one f32 a gate),
    K1-fwd's float4 writes (a quarter-warp: one gate and unit, rows 4 bg ..
    4 bg + 3 for bg = 0..7) and K1-bwd's f32 writes (lane -> row quad lane
    / 8, rows lane % 8 + 8 j) each meet every bank once a pass."""
    for q in range(4):
        for e in range(2):
            assert _banks([[_red(q, 2 * (ln % 4) + e, ln // 4)]
                           for ln in range(32)]) == 1
    for g in range(4):
        for u in range(8):
            for half in range(2):
                assert _banks([[_red(g, u, 4 * bg + 32 * half + i)
                                for i in range(4)]
                               for bg in range(8)]) == 1
    for warp in range(2):
        for j in range(8):
            for r in range(4):
                words = []
                for ln in range(32):
                    rq = warp * 4 + ln // 8
                    words.append([_red(rq // 2, (rq % 2) * 4 + r,
                                       ln % 8 + 8 * j)])
                assert _banks(words) == 1


def test_plan_constants_are_the_kernels():
    assert int(_cuh_constant("UNITS")) == P.WIDE_UNITS
    assert int(_cuh_constant("THREADS")) == P.WIDE_THREADS
    assert int(_cuh_constant("CHUNK")) == P.CHUNK
    assert int(_cuh_constant("BT")) == P.BT
    assert int(_cuh_constant("MAX_H")) == P.WIDE_MAX_H
    assert _cuh_constant("RED_UNIT") == "BT + 4" and P.RED_UNIT == P.BT + 4
    assert _cuh_constant("RED_GATE") == "UNITS * RED_UNIT + 8"
    fwd, bwd = "lstm_fwd_wide.cu", "lstm_bwd_wide.cu"
    assert int(_cuh_constant("KS", fwd)) == P.WIDE_FWD_SLICES
    assert int(_cuh_constant("RING", fwd)) == P.WIDE_FWD_RING
    assert _cuh_constant("BOXK", fwd) == "CHUNK / KS"
    assert int(_cuh_constant("KS", bwd)) == P.WIDE_BWD_SLICES
    assert int(_cuh_constant("RING", bwd)) == P.WIDE_BWD_RING
    assert _cuh_constant("BOXC", bwd) == "CHUNK / KS"
    assert int(_cuh_constant("DW_TILE", bwd)) == P.WIDE_DW_TILE
    assert int(_cuh_constant("DW_BK", bwd)) == P.WIDE_DW_BK
    assert int(_cuh_constant("DW_STAGES", bwd)) == P.WIDE_DW_STAGES


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
    # h_{t-1} comes from hs itself by the TMA: no transposed copy of hs
    assert part.dtype == dh_buf.dtype == torch.float32
    assert not hasattr(L, "k1_bwd_hs_slab")


def test_wide_kernels_are_built_registered_and_bound():
    for name, kernel, nargs in (("lstm_fwd_wide", L.LSTM_FWD_WIDE, 11),
                                ("lstm_bwd_wide", L.LSTM_BWD_WIDE, 15)):
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


def test_dw_kernel_is_registered_and_bound():
    k = L.LSTM_DW_WIDE
    assert k in _build.KERNELS and k is not L.LSTM_DW_WIDE_BF16
    assert (k.name, k.source, k.symbol) == ("lstm_dw_wide", "lstm_bwd_wide",
                                            "mlvae_lstm_dw_wide")
    text = (CSRC / "lstm_bwd_wide.cu").read_text()
    sig = re.search(r"int mlvae_lstm_dw_wide\(([^)]*)\)", text).group(1)
    assert sig.count(",") + 1 == len(k.argtypes) == 8
    assert "mlvae_lstm_dw_wide_plan" in text


@pytest.mark.parametrize("Bn", BATCHES)
def test_dw_plan_for_every_wide_h(Bn):
    # 128 x 128 tiles of dW_hh (4H x H), the ragged edge rounded up; two
    # blocks an SM
    for Hn in range(544, 1025, 16):
        w = P.k1_dw_plan(Hn, Bn, bf16=False)
        assert w.variant == "dw" and w.threads == 256
        assert w.blocks == -(-Hn // 128) * -(-4 * Hn // 128)
        assert w.ring == 2 and 2 * w.smem_bytes <= P.SMEM_LIMIT
    # the narrow K1-bwd forms dW_hh itself
    with pytest.raises(ValueError, match="narrow"):
        P.k1_dw_plan(512, Bn, bf16=False)


def _meta(shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("Tn", [1, 2, 9])
@pytest.mark.parametrize("Bn", [64, 70])
def test_f32_wide_backward_launches_the_recurrence_then_dw(monkeypatch, Tn,
                                                           Bn):
    """Off the CPU the f32 wide backward launches its recurrence (15
    arguments: no transposed copy of hs), then the dW_hh kernel over dgx
    and hs, which a T=1 layer (h_{t-1} = 0 at its only step) does
    without; each counts its own launches."""
    calls = []
    for k in (L.LSTM_BWD_WIDE, L.LSTM_DW_WIDE, L.LSTM_DW_WIDE_BF16):
        monkeypatch.setattr(
            k, "_fn", lambda *a, _n=k.name: calls.append((_n, len(a))) or 0)
        monkeypatch.setattr(k, "launches", 0)
    monkeypatch.setattr(L, "_check_cuda", lambda name, tensors: None)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    Hn = 1024
    dgx, dw = L.lstm_layer_bwd(_meta((Tn, Bn, 4 * Hn)), _meta((4 * Hn, Hn)),
                               _meta((Tn, Bn, Hn)), _meta((Tn, Bn, Hn)),
                               _meta((Tn, Bn, Hn)), _meta((Bn, Hn)))
    assert dgx.shape == (Tn, Bn, 4 * Hn) and dw.shape == (4 * Hn, Hn)
    want = [("lstm_bwd_wide", 15)] + [("lstm_dw_wide", 8)] * (Tn > 1)
    assert calls == want
    assert L.LSTM_BWD_WIDE.launches == 1
    assert L.LSTM_DW_WIDE.launches == (Tn > 1)
    assert L.LSTM_DW_WIDE_BF16.launches == 0


@pytest.mark.parametrize("Tn, Bn, Hn", [(5, 3, 640), (2, 8, 544),
                                        (1, 4, 640)])
@pytest.mark.parametrize("reverse", [False, True])
def test_f32_dw_plain_version_is_the_plain_bptts_dw(Tn, Bn, Hn, reverse):
    """``wide_dw_ref``, the plain version of the f32 dW_hh kernel, on the
    plain BPTT's dgx and hs gives its dW_hh: one product over every step
    and row against a sum of per-step products, f32 sums in another order
    (1e-5 of the largest entry)."""
    rs = np.random.RandomState(21)
    t = torch.from_numpy
    gx = t((rs.randn(Tn, Bn, 4 * Hn) * 0.5).astype(np.float32))
    w = t(((rs.rand(4 * Hn, Hn) * 2 - 1) / np.sqrt(Hn)).astype(np.float32))
    dhs = t((rs.randn(Tn, Bn, Hn) * 0.1).astype(np.float32))
    dc_last = t((rs.randn(Bn, Hn) * 0.1).astype(np.float32))
    hs, cs = L.lstm_layer_ref(gx, w, reverse)
    dgx, dw = L.lstm_layer_bwd_ref(gx, w, hs, cs, dhs, dc_last, reverse)
    got = L.wide_dw_ref(dgx, hs, reverse)
    assert got.dtype == torch.float32 and got.shape == dw.shape
    if Tn == 1:
        assert not got.any() and not dw.any()
    else:
        assert float((got - dw).abs().max()) <= 1e-5 * float(dw.abs().max())


def test_smem_probe_needs_cuda(monkeypatch):
    from mlvae_tpu_torch.tools import bench_smem_reads as probe
    assert len(probe.PATTERNS) == 5 and "mlvae_smem_probe" in probe.SOURCE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.main([])
