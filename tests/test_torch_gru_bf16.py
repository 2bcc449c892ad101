"""K5 on bf16 streams (``csrc/gru_fwd_bf16.cu``, ``csrc/gru_bwd_bf16.cu``),
on the CPU: the sources' registration and bindings, the f32 sources left
f32 only, ``ops.gru.k5_plan`` (which build takes each H and dtype, its
grid and shared memory against the sources' constants; every H the parent
build took), the wrappers' dispatch (bf16 layers to the new builds, K5-bwd
as the recurrence and then its dW_hh kernel, f32 layers to the f32
builds), the plain BPTT's bf16(dgh) (its r and z columns are dgx's bit for
bit, its n column is not), and the plain version of the dW_hh kernel,
which forms dW_hh after the recurrence from [dgx's r and z columns | dgn]
and hs shifted by a step.

Tolerances, with their reasons. ``gru_dw_ref`` fed the plain BPTT's own
operands sums the same f32 products over (T-1)*B terms in another order:
within 1e-5 of dW_hh's largest entry. Against the Pallas backward
(interpret mode) both sides take the Pallas forward's hs; the plain BPTT
rounds where the Pallas kernel rounds, but an f32 sum in another order
can cross a bf16 rounding boundary of a dgh: within 1e-2 of the largest
entry, as ``tests/test_torch_gru.py`` holds the bf16 gradients.
The kernels themselves run on the card (``chip_smoke.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlvae_tpu.ops.gru_pallas as gp

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops import gru as G
from mlvae_tpu_torch.tools import bench_bwd_timeline as btl
from mlvae_tpu_torch.tools import bench_fwd_timeline as ftl

torch.set_num_threads(2)

CSRC = Path(G.__file__).resolve().parent.parent / "csrc"
REF_RTOL = 1e-5       # the same f32 products summed in another order
PALLAS_RTOL = 1e-2    # a dgh one bf16 ulp off in a sum of (T-1)*B terms
PARENT_H = range(16, 529, 16)   # every H the parent's bf16 build took


def _constant(fname, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  (CSRC / fname).read_text())
    return m.group(1).strip()


def _signature(src, symbol):
    text = (CSRC / f"{src}.cu").read_text()
    return re.search(rf"int {symbol}\(([^)]*)\)", text).group(1)


# ---------------------------------------------------------------------------
# sources, registration and bindings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel, src, symbol", [
    (G.GRU_FWD_BF16, "gru_fwd_bf16", "mlvae_gru_fwd_bf16"),
    (G.GRU_BWD_BF16, "gru_bwd_bf16", "mlvae_gru_bwd_bf16"),
    (G.GRU_DW_BF16, "gru_bwd_bf16", "mlvae_gru_dw_bf16"),
])
def test_bf16_builds_are_sources_and_bind_their_entry_points(kernel, src,
                                                             symbol):
    assert src in _build.SOURCES and (CSRC / f"{src}.cu").is_file()
    assert kernel in _build.KERNELS
    assert (kernel.source, kernel.symbol) == (src, symbol)
    sig = _signature(src, symbol)
    assert sig.count(",") + 1 == len(kernel.argtypes), symbol
    text = (CSRC / f"{src}.cu").read_text()
    assert f"int {symbol}_plan(" in text
    assert f"mlvae_{src}_error_string" in text
    assert '#include "gru_mma.cuh"' in text
    # the library of the source, not of an f32 build
    assert _build._lib_path(kernel.source).name.startswith(f"lib{src}-")
    names = [k.name for k in _build.KERNELS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("kernel, src", [(G.GRU_FWD, "gru_fwd"),
                                         (G.GRU_BWD, "gru_bwd")])
def test_f32_sources_keep_only_f32_entry_points(kernel, src):
    assert (kernel.source, kernel.symbol) == (src, f"mlvae_{src}")
    sig = _signature(src, f"mlvae_{src}")
    assert sig.count(",") + 1 == len(kernel.argtypes)
    assert "bf16" not in sig and "void*" not in sig.replace(" ", "")
    text = (CSRC / f"{src}.cu").read_text()
    # the f32 entry point, its launch plan and, under the timing define
    # only, the timing build's entry point in its place
    entries = re.findall(r"int (mlvae_\w+)\(", text)
    assert sorted(set(entries)) == sorted(entries)
    assert set(entries) <= {f"mlvae_{src}", f"mlvae_{src}_plan",
                            f"mlvae_{src}_timeline"}
    assert f"mlvae_{src}" in entries
    timed = f"{src}_timeline"
    define = _build.timeline_define(timed)[2:]
    assert re.search(rf"#ifdef {define}\nint mlvae_{timed}\(\n#else\n"
                     rf"int mlvae_{src}\(\n#endif", text)
    # plain f32 code: no template over the stream type, no bf16
    for f in (f"{src}.cu", "gru_common.cuh"):
        assert not re.search(r"\bbf16\s*\*|__nv_bfloat16|template <typename|"
                             r"hs32", (CSRC / f).read_text()), f


def test_shared_pieces_are_included_not_copied():
    """The mma, ldmatrix and TMA pieces live in one header that both the
    LSTM and the GRU builds include."""
    shared = ("mma16816", "ldsm_x4", "tma_half", "tensor_map", "swz_at")
    defs = {name: [f.name for f in CSRC.glob("*.cu*")
                   if re.search(rf"\b(void|cudaError_t|bf16\*)\s+{name}\(|"
                                rf"const bf16\* {name}\(",
                                f.read_text())] for name in shared}
    assert all(v == ["mma_tma.cuh"] for v in defs.values()), defs
    assert '#include "mma_tma.cuh"' in (CSRC / "gru_mma.cuh").read_text()
    assert '#include "mma_tma.cuh"' in (
        CSRC / "lstm_fused_common.cuh").read_text()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", PARENT_H)
def test_plan_takes_every_h_the_parent_took(H):
    f32 = [G.k5_plan(d, H, False) for d in ("fwd", "bwd")]
    assert all(p.build == "f32" and p.blocks == H // 4 for p in f32)
    for plan in (G.k5_plan(d, H, True) for d in ("fwd", "bwd")):
        # two blocks of 32 rows on each group of eight units: the parent's
        # grid, H/4 blocks
        assert plan.build == "bf16" and plan.rows == 32
        assert plan.blocks == H // 8 * 2 == H // 4 <= G.SMS
        assert plan.threads == 256
        assert 0 < plan.smem_bytes <= G.SMEM_LIMIT, plan
        assert plan.boxes == -(-H // 64)
    dw = G.k5_plan("dw", H, True)
    assert dw.blocks == -(-H // 128) * (-(-2 * H // 64) - (-H // 64))
    assert 2 * dw.smem_bytes <= G.SMEM_LIMIT       # two blocks an SM


@pytest.mark.parametrize("H, error", [(8, ValueError), (0, ValueError),
                                      (520 + 4, ValueError),
                                      (544, NotImplementedError),
                                      (1024, NotImplementedError)])
@pytest.mark.parametrize("bf16", [False, True])
def test_plan_refuses_what_no_build_takes(H, error, bf16):
    with pytest.raises(error):
        G.k5_plan("fwd", H, bf16)
    with pytest.raises(error):
        G.k5_plan("bwd", H, bf16)


def test_plan_refuses_unknown_directions():
    with pytest.raises(ValueError):
        G.k5_plan("dw", 512, False)        # the f32 backward forms dW_hh
    with pytest.raises(ValueError):
        G.k5_plan("up", 512, True)


@pytest.mark.parametrize("H, fwd, bwd", [(512, 45120, 110784),
                                         (208, 28704, 94368),
                                         (528, 49224, 114888)])
def test_bf16_shared_memory(H, fwd, bwd):
    # K5-fwd: the h_{t-1} tile (64-column boxes of 32 rows), an mbarrier a
    # box, the K parts' sums (8 warps x 3 gates x 2 row halves x 32 lanes
    # of float2). K5-bwd: the tile and the ring of sixteen boxes, an
    # mbarrier each, and the sums, which the exchange's (8 warps x 2
    # m-tiles x 2 x 32 float2) reuse
    nb, box = -(-H // 64), 32 * 64 * 2
    parts = 8 * 3 * 2 * 32 * 8
    assert G.k5_plan("fwd", H, True).smem_bytes == fwd \
        == nb * (box + 8) + parts
    assert G.k5_plan("bwd", H, True).smem_bytes == bwd \
        == (nb + 16) * (box + 8) + parts


def test_plan_constants_are_the_kernels():
    assert int(_constant("gru_mma.cuh", "UNITS")) == G.BF16_UNITS
    assert int(_constant("gru_mma.cuh", "GATES")) == 3
    assert int(_constant("gru_mma.cuh", "THREADS")) == G.THREADS
    assert int(_constant("gru_mma.cuh", "BT")) == G.BT
    assert int(_constant("gru_mma.cuh", "MAX_H")) == G.K5_MAX_H
    assert _constant("gru_mma.cuh", "BOX") == "fused::HALF"
    assert int(_constant("mma_tma.cuh", "HALF")) == G.BOX
    assert int(_constant("gru_common.cuh", "UNITS")) == G.F32_UNITS
    assert int(_constant("gru_bwd_bf16.cu", "XBUFS")) == G.XBUFS
    assert _constant("gru_bwd_bf16.cu", "DW_M") == "BOX"
    assert (int(_constant("gru_bwd_bf16.cu", "DW_N")),
            int(_constant("gru_bwd_bf16.cu", "DW_BK")),
            int(_constant("gru_bwd_bf16.cu", "DW_STAGES"))) == (
        G.DW_N, G.DW_BK, G.DW_STAGES)
    assert int(_constant("gru_mma.cuh", "RB")) == G.BF16_ROWS == 32


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, device="meta", dtype=dtype)


def _k5_args(T, B, H, dt):
    f = torch.float32
    return (_meta((T, B, 3 * H), dt), _meta((3 * H, H), dt),
            _meta((3 * H,), f), _meta((T, B, H), dt),
            _meta((T, B, H), f) if dt == torch.bfloat16 else None,
            _meta((T, B, H), dt))


@pytest.fixture
def recorded(monkeypatch):
    """Every K5 kernel's entry point replaced by a recorder that accepts
    the launch (no card here): (kernel name, arguments) in launch order;
    the device check and the stream lookup pass meta tensors."""
    calls = []
    for k in (G.GRU_FWD, G.GRU_BWD, G.GRU_FWD_BF16, G.GRU_BWD_BF16,
              G.GRU_DW_BF16):
        monkeypatch.setattr(
            k, "_fn", lambda *a, _n=k.name: calls.append((_n, a)) or 0)
        monkeypatch.setattr(k, "launches", 0)
    monkeypatch.setattr(G, "_check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    return calls


@pytest.mark.parametrize("H", [208, 512])
@pytest.mark.parametrize("T", [1, 2, 9])
def test_bf16_layers_take_the_new_builds(recorded, H, T):
    gx, w, b, hs, hs32, dhs = _k5_args(T, 70, H, torch.bfloat16)
    out, out32 = G.gru_layer_fwd(gx, w, b)
    assert out.dtype == torch.bfloat16 and out32.dtype == torch.float32
    dgx, dw, db = G.gru_layer_bwd(gx, w, b, hs, hs32, dhs)
    assert dgx.dtype == torch.bfloat16
    assert dw.dtype == db.dtype == torch.float32
    # the recurrence, then dW_hh over its dgx and dgn, which a T=1 layer
    # (whose only step has h_{t-1} = 0) does without
    want = [("gru_fwd_bf16", 11), ("gru_bwd_bf16", 16)]
    if T > 1:
        want.append(("gru_dw_bf16", 9))
    assert [(n, len(a)) for n, a in recorded] == want
    # T, B, H, reverse
    assert recorded[0][1][6:10] == (T, 70, H, 0)
    assert recorded[1][1][11:15] == (T, 70, H, 0)
    assert G.GRU_FWD_BF16.launches == G.GRU_BWD_BF16.launches == 1
    assert G.GRU_DW_BF16.launches == (T > 1)
    assert G.GRU_FWD.launches == G.GRU_BWD.launches == 0


@pytest.mark.parametrize("H", [16, 512, 528])
def test_f32_layers_keep_the_f32_builds(recorded, H):
    gx, w, b, hs, hs32, dhs = _k5_args(3, 8, H, torch.float32)
    out, out32 = G.gru_layer_fwd(gx, w, b, True)
    assert out32 is None
    G.gru_layer_bwd(gx, w, b, hs, hs32, dhs, True)
    # the forward stages h_{t-1} from hs itself: no h buffer among its
    # pointers
    assert [(n, len(a)) for n, a in recorded] == [("gru_fwd", 10),
                                                  ("gru_bwd", 16)]
    assert recorded[0][1][5:9] == (3, 8, H, 1)
    assert recorded[1][1][11:15] == (3, 8, H, 1)


@pytest.mark.parametrize("bf16", [False, True])
def test_wide_layers_are_refused_before_any_launch(recorded, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    gx, w, b, hs, hs32, dhs = _k5_args(3, 8, 544, dt)
    with pytest.raises(NotImplementedError, match="H=544"):
        G.gru_layer_fwd(gx, w, b)
    with pytest.raises(NotImplementedError, match="H=544"):
        G.gru_layer_bwd(gx, w, b, hs, hs32, dhs)
    assert recorded == []


def test_timing_builds_bind_the_new_sources():
    fwd, bwd = ftl.TIMED["gru_fwd_bf16"], btl.TIMED["gru_bwd_bf16"]
    assert (fwd.source, fwd.symbol) == ("gru_fwd_bf16_timeline",
                                        "mlvae_gru_fwd_bf16_timeline")
    assert (bwd.source, bwd.symbol) == ("gru_bwd_bf16_timeline",
                                        "mlvae_gru_bwd_bf16_timeline")
    assert len(fwd.argtypes) == len(G.GRU_FWD_BF16.argtypes) + 1
    assert len(bwd.argtypes) == len(G.GRU_BWD_BF16.argtypes) + 1
    assert _build.timeline_define(fwd.source) == _build.FWD_TIMELINE_DEFINE
    assert _build.timeline_define(bwd.source) == \
        _build.K1_BWD_TIMELINE_DEFINE


# ---------------------------------------------------------------------------
# bf16(dgh) and the plain dW_hh
# ---------------------------------------------------------------------------

def _problem(seed, T, B, H):
    rs = np.random.RandomState(seed)
    bf = torch.bfloat16
    gx = torch.from_numpy((rs.randn(T, B, 3 * H) * 0.5).astype(
        np.float32)).to(bf)
    w = torch.from_numpy(((rs.rand(3 * H, H) * 2 - 1) * 2 / np.sqrt(H))
                         .astype(np.float32)).to(bf)
    b = torch.from_numpy(((rs.rand(3 * H) * 2 - 1) / np.sqrt(H)).astype(
        np.float32))
    dhs = torch.from_numpy((rs.randn(T, B, H) * 0.1).astype(np.float32)).to(bf)
    return gx, w, b, dhs


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T, B, H", [(12, 16, 128), (5, 3, 208)])
def test_dgh_rz_columns_are_dgx_and_its_n_column_is_not(T, B, H, reverse):
    gx, w, b, dhs = _problem(41, T, B, H)
    hs, hs32 = G.gru_layer_ref(gx, w, b, reverse)
    dgx, dw, db, dgh = G.gru_layer_bwd_ref(gx, w, b, hs, hs32, dhs, reverse,
                                           with_dgh=True)
    assert dgh.dtype == torch.bfloat16 and dgh.shape == dgx.shape
    assert torch.equal(dgh[..., :2 * H], dgx[..., :2 * H])
    # bf16(dn' r) against bf16(dn'): they differ wherever r rounds away
    assert (dgh[..., 2 * H:] != dgx[..., 2 * H:]).float().mean() > 0.5
    # with_dgh leaves the other outputs as they were
    want = G.gru_layer_bwd_ref(gx, w, b, hs, hs32, dhs, reverse)
    assert all(torch.equal(a, c) for a, c in zip((dgx, dw, db), want))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T, B, H", [(12, 16, 128), (5, 3, 208), (2, 8, 64),
                                     (1, 4, 32)])
def test_dw_plain_version_is_the_plain_bptts_dw(T, B, H, reverse):
    gx, w, b, dhs = _problem(42, T, B, H)
    hs, hs32 = G.gru_layer_ref(gx, w, b, reverse)
    dgx, dw, _, dgh = G.gru_layer_bwd_ref(gx, w, b, hs, hs32, dhs, reverse,
                                          with_dgh=True)
    got = G.gru_dw_ref(dgx, dgh[..., 2 * H:], hs, reverse)
    assert got.dtype == torch.float32 and got.shape == dw.shape
    if T == 1:
        assert not got.any() and not dw.any()
    else:
        assert float((got - dw).abs().max()) <= REF_RTOL * float(
            dw.abs().max())


@pytest.mark.parametrize("reverse", [False, True])
def test_dw_plain_version_matches_the_pallas_backward(reverse):
    T, B, H = 12, 8, 48
    gx, w, b, dhs = _problem(43, T, B, H)

    def jx(t, dtype=jnp.bfloat16):
        return jnp.asarray(t.float().numpy(), dtype)

    hs_j, hs32_j = gp._run_fwd(jx(gx), jx(w), jx(b, jnp.float32), reverse,
                               True)
    _, dw_j, _ = gp._run_bwd(jx(gx), hs_j, hs32_j, jx(dhs), jx(w),
                             jx(b, jnp.float32), reverse, True)

    def tx(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)

    hs = tx(hs_j, torch.bfloat16)
    dgx, _, _, dgh = G.gru_layer_bwd_ref(gx, w, b, hs, tx(hs32_j), dhs,
                                         reverse, with_dgh=True)
    got = G.gru_dw_ref(dgx, dgh[..., 2 * H:], hs, reverse)
    want = tx(dw_j).t()
    assert float((got - want).abs().max()) <= PALLAS_RTOL * float(
        want.abs().max())
