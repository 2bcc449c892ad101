"""The wide K1 builds on bf16 streams (``csrc/lstm_fwd_wide_bf16.cu``,
``csrc/lstm_bwd_wide_bf16.cu``), on the CPU: their launch plans against
the constants and formulas the sources compile with, their registration
and bindings, the wrappers' dispatch (bf16 wide layers to the new builds,
f32 ones to the f32 builds, a bf16 wide H that is not a multiple of 128
refused), and the plain version of K1-bwd's dW_hh kernel, which forms
dW_hh after the recurrence from dgx and hs shifted by a step.

Tolerances, with their reasons. ``wide_dw_ref`` fed the plain BPTT's own
dgx and hs takes the same bf16 dgates and h_{t-1} that the plain BPTT's
product takes, and sums the same f32 products over (T-1)*B terms in
another order: within 1e-5 of dW_hh's largest entry. Fed the Pallas
backward's dgx and hs (interpret mode), it holds dW_hh to the Pallas
kernel's, which comes back rounded once to W_hh's bf16: the f32 sums
differ in order only, so at most one bf16 ulp (2^-8 of an entry) and in
at most 1 % of the entries.
The kernels themselves run on the card (``chip_smoke.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlvae_tpu.ops.lstm_pallas as lp

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops import k1_plan as P
from mlvae_tpu_torch.ops import lstm as L

torch.set_num_threads(2)

CSRC = Path(L.__file__).resolve().parent.parent / "csrc"
WIDE_BF16_H = (640, 768, 896, 1024)   # H % 128 == 0 above 528
REF_RTOL = 1e-5      # the same f32 products summed in another order
ULP = 2.0 ** -8      # one bf16 ulp, relative
FLIP_SHARE = 0.01    # dW_hh entries whose bf16 rounding may flip


def _constant(fname, name):
    text = (CSRC / fname).read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    return m.group(1).strip()


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Hn", WIDE_BF16_H)
@pytest.mark.parametrize("Bn", [1, 64, 65, 70, 128, 256])
def test_bf16_plans_for_every_h_the_builds_take(Hn, Bn):
    f = P.k1_fwd_plan(Hn, Bn, bf16=True)
    b = P.k1_bwd_plan(Hn, Bn, bf16=True)
    w = P.k1_dw_plan(Hn, Bn)
    for plan in (f, b):
        assert plan.variant == "wide_bf16"
        assert plan.units == 8 and plan.blocks * 8 == Hn
        assert plan.blocks <= P.SMS             # all co-resident
        assert plan.threads == 256
        assert 0 < plan.smem_bytes <= P.SMEM_LIMIT, plan
    # the h_{t-1} tile: a 128-column slice a warp; the ring two buffers a
    # warp in the tile's memory
    assert f.ring == Hn // 128 <= 8
    assert b.ring == 16 and b.split == (Bn <= 64)
    assert b.ring * 64 * P.XCHUNK * 2 == 8 * P.SLICE_BYTES
    assert w.variant == "dw_bf16" and w.threads == 256
    assert w.blocks == (Hn // 128) * (4 * Hn // 128)
    assert w.ring == 3 and 2 * w.smem_bytes <= P.SMEM_LIMIT  # two an SM
    # the f32 plans stay what they were
    assert P.k1_fwd_plan(Hn, Bn).variant == "wide"
    assert P.k1_bwd_plan(Hn, Bn).variant == "wide"


@pytest.mark.parametrize("Hn, fwd, bwd", [(1024, 131136, 213312),
                                          (640, 81960, 188712)])
def test_bf16_shared_memory(Hn, fwd, bwd):
    # K1-fwd: the h_{t-1} tile (H/128 slices of 64 x 128 bf16) and an
    # mbarrier a slice. K1-bwd: the 128 KB tile as the ring of sixteen 8 KB
    # dgates chunks, the warps' dh sums (8 x 64 x 8 f32), W_hh's columns of
    # the block's units (8 x (4H + 8) bf16), an mbarrier a slice and a ring
    # buffer
    nk = Hn // 128
    assert P.k1_fwd_plan(Hn, 64, bf16=True).smem_bytes == fwd \
        == nk * (64 * 128 * 2 + 8)
    assert P.k1_bwd_plan(Hn, 64, bf16=True).smem_bytes == bwd \
        == 8 * 16384 + 8 * 64 * 8 * 4 + 8 * (4 * Hn + 8) * 2 + 8 * (nk + 16)
    assert P.k1_dw_plan(Hn, 64).smem_bytes == 3 * (2 * 64 * 128 * 2 + 8)


def test_bf16_plan_constants_are_the_kernels():
    assert int(_constant("lstm_wide_mma.cuh", "UNITS")) == P.WIDE_UNITS
    assert int(_constant("lstm_wide_mma.cuh", "THREADS")) == P.WIDE_THREADS
    assert int(_constant("lstm_wide_mma.cuh", "BT")) == P.BT
    assert int(_constant("lstm_wide_mma.cuh", "KSLICE")) == P.SLICE
    assert int(_constant("lstm_wide_mma.cuh", "MAX_H")) == P.WIDE_MAX_H
    assert _constant("lstm_wide_mma.cuh", "WARPS") == "THREADS / 32"
    assert _constant("lstm_bwd_wide_bf16.cu", "RING") == "WARPS * XBUFS"
    assert P.BF16_RING == int(_constant("lstm_bwd_wide_bf16.cu", "XBUFS")) \
        * P.WIDE_THREADS // 32
    assert int(_constant("lstm_bwd_wide_bf16.cu", "XCHUNK")) == P.XCHUNK
    assert int(_constant("lstm_bwd_wide_bf16.cu", "DW_TILE")) == P.DW_TILE
    assert int(_constant("lstm_bwd_wide_bf16.cu", "DW_BK")) == P.DW_BK
    assert int(_constant("lstm_bwd_wide_bf16.cu", "DW_STAGES")) \
        == P.DW_STAGES
    # the slices of h_{t-1} are lstm_fused_tma.cuh's chunk tiles
    assert int(_constant("lstm_fused_tma.cuh", "KCB")) == P.SLICE


@pytest.mark.parametrize("Hn", [544, 576, 704, 1008])
def test_bf16_wide_h_off_the_lane_names_the_scan(Hn):
    for plan in (P.k1_fwd_plan, P.k1_bwd_plan):
        with pytest.raises(ValueError, match="lstm_scan"):
            plan(Hn, 64, bf16=True)
        assert plan(Hn, 64).variant == "wide"   # f32 keeps its build
    with pytest.raises(ValueError, match="lstm_scan"):
        P.k1_dw_plan(Hn, 64)


@pytest.mark.parametrize("Hn", [128, 256, 512, 528])
def test_bf16_narrow_h_names_queue_2(Hn):
    """bf16 streams at H <= 528 no longer wait in queue 2: the tensor-core
    build takes every H % 128 == 0 (the JAX kernel's whole bf16 contract),
    and another H has no build (``nn.rnn`` runs it as ``lstm_scan``)."""
    for plan in (P.k1_fwd_plan, P.k1_bwd_plan):
        if Hn % 128:
            with pytest.raises(ValueError, match="lstm_scan"):
                plan(Hn, 64, bf16=True)
        else:
            assert plan(Hn, 64, bf16=True).variant == "wide_bf16"


# ---------------------------------------------------------------------------
# registration and bindings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel, src, symbol", [
    (L.LSTM_FWD_WIDE_BF16, "lstm_fwd_wide_bf16", "mlvae_lstm_fwd_wide_bf16"),
    (L.LSTM_BWD_WIDE_BF16, "lstm_bwd_wide_bf16", "mlvae_lstm_bwd_wide_bf16"),
    (L.LSTM_DW_WIDE_BF16, "lstm_bwd_wide_bf16", "mlvae_lstm_dw_wide_bf16"),
])
def test_bf16_builds_are_sources_and_bind_their_entry_points(kernel, src,
                                                             symbol):
    assert src in _build.SOURCES and (CSRC / f"{src}.cu").is_file()
    assert kernel in _build.KERNELS
    assert (kernel.source, kernel.symbol) == (src, symbol)
    text = (CSRC / f"{src}.cu").read_text()
    sig = re.search(rf"int {symbol}\(([^)]*)\)", text).group(1)
    assert sig.count(",") + 1 == len(kernel.argtypes), symbol
    assert f"int {symbol}_plan(" in text
    assert f"mlvae_{src}_error_string" in text
    assert '#include "lstm_wide_mma.cuh"' in text
    # the library of the source, not of an f32 build
    assert _build._lib_path(kernel.source).name.startswith(f"lib{src}-")


def test_f32_wide_sources_keep_only_f32_entry_points():
    for src in ("lstm_fwd_wide", "lstm_bwd_wide"):
        text = (CSRC / f"{src}.cu").read_text()
        assert f"int mlvae_{src}(" in text and f"int mlvae_{src}_plan(" in text
        assert "_bf16" not in "".join(re.findall(r"int mlvae_\w+\(", text))
        # plain f32 code, no template over the stream type
        assert not re.search(r"\bbf16\s*\*|__nv_bfloat16|template <typename",
                             text)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, device="meta", dtype=dtype)


def _k1_args(T, B, H, dt):
    f = torch.float32
    return (_meta((T, B, 4 * H), dt), _meta((4 * H, H), dt),
            _meta((T, B, H), dt), _meta((T, B, H), f), _meta((T, B, H), dt),
            _meta((B, H), f))


@pytest.fixture
def recorded(monkeypatch):
    """Every K1 kernel's entry point replaced by a recorder that accepts
    the launch (no card here): (kernel name, argument count) in launch
    order; the device check and the stream lookup pass meta tensors."""
    calls = []
    for k in (L.LSTM_FWD, L.LSTM_BWD, L.LSTM_FWD_WIDE, L.LSTM_BWD_WIDE,
              L.LSTM_DW_WIDE, L.LSTM_FWD_WIDE_BF16, L.LSTM_BWD_WIDE_BF16,
              L.LSTM_DW_WIDE_BF16):
        monkeypatch.setattr(
            k, "_fn", lambda *a, _n=k.name: calls.append((_n, len(a))) or 0)
        monkeypatch.setattr(k, "launches", 0)
    monkeypatch.setattr(L, "_check_cuda", lambda name, tensors: None)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    return calls


@pytest.mark.parametrize("Hn", [640, 1024])
@pytest.mark.parametrize("Tn", [1, 2, 9])
def test_bf16_wide_layers_take_the_new_builds(recorded, Hn, Tn):
    args = _k1_args(Tn, 70, Hn, torch.bfloat16)
    hs, cs = L.lstm_layer_fwd(*args[:2])
    assert hs.dtype == torch.bfloat16 and cs.dtype == torch.float32
    dgx, dw = L.lstm_layer_bwd(*args)
    assert dgx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    # the recurrence, then dW_hh over its dgx, which a T=1 layer (whose
    # only step has h_{t-1} = 0) does without
    want = [("lstm_fwd_wide_bf16", 10), ("lstm_bwd_wide_bf16", 14)]
    if Tn > 1:
        want.append(("lstm_dw_wide_bf16", 8))
    assert recorded == want
    assert L.LSTM_FWD_WIDE_BF16.launches == 1
    assert L.LSTM_DW_WIDE_BF16.launches == (Tn > 1)


@pytest.mark.parametrize("Hn", [544, 640, 1024])
def test_f32_wide_layers_keep_the_f32_builds(recorded, Hn):
    args = _k1_args(3, 8, Hn, torch.float32)
    L.lstm_layer_fwd(*args[:2])
    L.lstm_layer_bwd(*args)
    # the f32 recurrence, then its own dW_hh kernel
    assert recorded == [("lstm_fwd_wide", 11), ("lstm_bwd_wide", 15),
                        ("lstm_dw_wide", 8)]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("Hn", [544, 656, 1008])
def test_bf16_wide_h_off_the_lane_is_refused(recorded, direction, Hn):
    args = _k1_args(3, 8, Hn, torch.bfloat16)
    with pytest.raises(ValueError, match="lstm_scan"):
        if direction == "fwd":
            L.lstm_layer_fwd(*args[:2])
        else:
            L.lstm_layer_bwd(*args)
    assert recorded == []


# ---------------------------------------------------------------------------
# dW_hh out of the recurrence: its plain version
# ---------------------------------------------------------------------------

def _problem(seed, T, B, H):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy((rs.randn(T, B, 4 * H) * 0.5).astype(
                np.float32)).to(torch.bfloat16),
            torch.from_numpy(((rs.rand(4 * H, H) * 2 - 1) * 2 / np.sqrt(H))
                             .astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy((rs.randn(T, B, H) * 0.1).astype(
                np.float32)).to(torch.bfloat16),
            torch.from_numpy((rs.randn(B, H) * 0.1).astype(np.float32)))


@pytest.mark.parametrize("T, B, H", [(12, 16, 128), (5, 3, 640),
                                     (2, 8, 128), (1, 4, 128)])
@pytest.mark.parametrize("reverse", [False, True])
def test_dw_plain_version_is_the_plain_bptts_dw(T, B, H, reverse):
    gx, w, dhs, dc_last = _problem(31, T, B, H)
    hs, cs = L.lstm_layer_ref(gx, w, reverse)
    dgx, dw = L.lstm_layer_bwd_ref(gx, w, hs, cs, dhs, dc_last, reverse)
    got = L.wide_dw_ref(dgx, hs, reverse)
    assert got.dtype == torch.float32 and got.shape == dw.shape
    scale = float(dw.abs().max())
    if T == 1:
        assert not got.any() and not dw.any()
    else:
        assert float((got - dw).abs().max()) <= REF_RTOL * scale


@pytest.mark.parametrize("reverse", [False, True])
def test_dw_plain_version_matches_the_pallas_backward(reverse):
    T, B, H = 12, 16, 128
    gx, w, dhs, dc_last = _problem(32, T, B, H)

    def jx(t, dtype=jnp.bfloat16):
        return jnp.asarray(t.float().numpy(), dtype)

    jgx, jw = jx(gx), jx(w)
    hs_j, cs_j = lp._run_fwd(jgx, jw, reverse, True)
    dgx_j, dw_j = lp._run_bwd(jgx, hs_j, cs_j, jx(dhs),
                              jx(dc_last, jnp.float32), jw, reverse, True)
    assert dgx_j.dtype == dw_j.dtype == jnp.bfloat16

    def tx(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32)))

    got = L.wide_dw_ref(tx(dgx_j).to(torch.bfloat16),
                        tx(hs_j).to(torch.bfloat16), reverse)
    want = tx(dw_j)
    diff = (got.to(torch.bfloat16).float() - want).abs()
    assert float(diff.max()) <= ULP * float(want.abs().max())
    assert float((diff > 0).float().mean()) <= FLIP_SHARE
