"""The LSTM forwards' step timeline (``tools/bench_fwd_timeline.py``), their
timing builds and their host-side layouts, on the CPU: no normal build
carries the forward timing define, the timing builds have library paths of
their own, the phase split reads the timeline as the kernels write it, the
shared-memory budgets pick each schedule at the main path's shapes and keep
every shape the single-copy designs took, and the TMA descriptors' boxes
and strides hold for ragged batches. The kernels themselves run on the
card (``chip_smoke.py``)."""
import ctypes

import pytest
import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops import lstm as L
from mlvae_tpu_torch.tools import bench_fwd_timeline as ftl


@pytest.mark.parametrize("name", _build.SOURCES)
def test_normal_builds_have_no_forward_timing_define(name):
    assert _build.FWD_TIMELINE_DEFINE not in _build._flags(name)


@pytest.mark.parametrize("src", _build.FWD_TIMED)
def test_forward_timing_builds_have_their_own_library(src):
    name = f"{src}_timeline"
    assert _build.source_of(name) == src
    assert _build.timeline_define(name) == _build.FWD_TIMELINE_DEFINE
    assert _build._flags(name) == _build._flags(src) + [
        _build.FWD_TIMELINE_DEFINE]
    assert _build.TIMELINE_DEFINE not in _build._flags(name)
    timed, normal = _build._lib_path(name), _build._lib_path(src)
    assert timed != normal
    assert timed.name.startswith(f"lib{name}-")


def test_forward_timed_kernels_are_not_counted_on_any_path():
    assert all(k not in _build.KERNELS for k in ftl.TIMED.values())
    assert {k.source for k in ftl.TIMED.values()} == {
        f"{s}_timeline" for s in _build.FWD_TIMED}
    assert {k.symbol for k in ftl.TIMED.values()} == {
        "mlvae_lstm_fwd_timeline", "mlvae_lstm_fused_fwd_timeline",
        "mlvae_lstm_fwd_wide_bf16_timeline", "mlvae_gru_fwd_bf16_timeline",
        "mlvae_gru_fwd_timeline", "mlvae_lstm_fwd_wide_timeline",
        "mlvae_lstm_unroll_fwd_timeline",
        "mlvae_lstm_unroll_fwd_bf16_timeline",
        "mlvae_lstm_unroll_fused_fwd_timeline",
        "mlvae_lstm_fused_fwd_f32_timeline",
        "mlvae_lstm_unroll_fused_fwd_f32_timeline"}


def test_unroll_rows_pair_each_k7_build_with_its_twin():
    """The K7 rows run at the unroll A/B's shape, each K7 build beside the
    one-step twin it must equal bit for bit, every twin a timed build."""
    assert ftl.UNROLL_TWINS == {"lstm_unroll_fwd": "lstm_fwd",
                                "lstm_unroll_fwd_bf16": "lstm_fwd_wide_bf16",
                                "lstm_unroll_fused_fwd": "lstm_fused_fwd"}
    assert set(ftl.UNROLL_TWINS) | set(ftl.UNROLL_TWINS.values()) <= set(
        _build.FWD_TIMED)
    assert (ftl.UNROLL_B, ftl.H, ftl.UNROLL_IN, ftl.T) == (128, 512, 512, 160)
    assert ftl.UNROLL_KS == (2, 4, 8)


def _timeline(T=4, blocks=3):
    """A timeline as the kernels write it: step s of block k starts at
    10 ms * (s + 10 k) and ends 9 + k us later; input 1 us, stage 2,
    product 3, cell 1.5, barrier 0.5 + k, off-chain 4 (ns sums)."""
    tl = torch.zeros((T, blocks, ftl.SLOTS), dtype=torch.int64)
    for s in range(T):
        for k in range(blocks):
            t0 = 10_000_000 * (s + 10 * k)
            tl[s, k] = torch.tensor([t0, t0 + 9000 + 1000 * k, 1000, 2000,
                                     3000, 1500, 500 + 1000 * k, 4000])
    return tl


def test_phase_split_reads_the_timeline():
    split = ftl.phase_split(_timeline())
    assert set(split) == {*ftl.PHASES, "step"}
    for name, us in (("input", 1.0), ("stage", 2.0), ("product", 3.0),
                     ("cell", 1.5), ("offchain", 4.0)):
        assert split[name] == pytest.approx(
            {"min": us, "median": us, "max": us}), name
    assert split["barrier"] == pytest.approx(
        {"min": 0.5, "median": 1.5, "max": 2.5})
    assert split["step"] == pytest.approx(
        {"min": 9.0, "median": 10.0, "max": 11.0})


def test_phase_split_averages_over_the_steps():
    tl = _timeline(T=2, blocks=1)
    tl[1, 0, 3] = 6000          # step 1 stages 6 us: the mean is 4
    assert ftl.phase_split(tl)["stage"]["median"] == pytest.approx(4.0)


# (In, B) -> (ahead, nhb, bytes) at H=512: B <= 256 keeps every batch tile
# in one pass; B=320 (five tiles) takes the serial schedule
@pytest.mark.parametrize("In, B, ahead, nhb, nbytes", [
    (128, 1, True, 4, 98304 + 12288 + 20736 + 48),
    (512, 64, True, 4, 98304 + 12288 + 33024 + 48),
    (1024, 64, True, 4, 98304 + 12288 + 49408 + 48),
    (128, 63, True, 4, None), (512, 65, True, 8, 163840 + 24576 + 33024 + 80),
    (1024, 65, True, 7, 147456 + 24576 + 49408 + 72),
    (128, 256, True, 7, None),
    (512, 256, True, 7, 147456 + 49152 + 33024 + 72),
    (1024, 256, True, 6, 131072 + 49152 + 49408 + 64),
    (128, 320, False, 2, None),
    (512, 320, False, 2, 32768 + 4096 + 33024 + 32),
    (1024, 320, False, 2, 32768 + 4096 + 49408 + 32),
    (512, 1, True, 4, None), (1024, 1, True, 4, None),
    (128, 64, True, 4, None), (128, 65, True, 8, None),
    (512, 63, True, 4, None), (1024, 63, True, 4, None),
])
def test_fused_fwd_budget_picks_the_schedule(In, B, ahead, nhb, nbytes):
    assert ftl.fused_fwd_schedule(In, 512, B) == (ahead, nhb)
    nt = -(-B // 64) if ahead else 1
    got = ftl.fused_fwd_smem_bytes(In, 512, nt, nhb, ahead)
    assert got <= ftl.SMEM_LIMIT
    if nbytes is not None:
        assert got == nbytes
    if ahead and nhb < nt * 4:  # one more chunk tile would not fit
        assert ftl.fused_fwd_smem_bytes(In, 512, nt, nhb + 1, True) > \
            ftl.SMEM_LIMIT


def _parent_fused_fwd_smem(In, H):
    """Shared memory of the single-group K3/K4-fwd: pre-activations, the
    weights and one 256-column chunk at pitch 264."""
    return 4 * 64 * 16 + 2 * (16 * (In + H + 8) + 64 * 264)


def test_fused_fwd_takes_every_shape_the_single_group_design_took():
    for H in range(16, 529, 16):
        for In in range(8, 6081, 8):
            if _parent_fused_fwd_smem(In, H) > ftl.SMEM_LIMIT:
                continue
            for B in (1, 64, 257):
                assert ftl.fused_fwd_schedule(In, H, B) is not None, \
                    (In, H, B)


@pytest.mark.parametrize("B, nq", [(1, 4), (63, 4), (64, 4), (65, 5),
                                   (128, 5), (256, 5), (320, 5)])
def test_k1_ring_depth(B, nq):
    assert ftl.k1_ring_depth(512, B) == nq
    assert ftl.k1_smem_bytes(512, nq) <= ftl.SMEM_LIMIT
    if nq < 4 * -(-B // 64):
        assert ftl.k1_smem_bytes(512, nq + 1) > ftl.SMEM_LIMIT


def test_k1_fits_every_h_the_single_copy_design_took():
    # H <= 528 (every block resident on 132 SMs), H % 16
    for H in range(16, 529, 16):
        for B in (1, 64, 128, 1000):
            assert ftl.k1_ring_depth(H, B) >= 4, (H, B)
    assert ftl.k1_smem_bytes(512, 4) == 131072 + 32768 + 16384 + 128


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 63, 64, 65, 127, 128, 200,
                               256, 257, 320])
def test_k1_tensor_map_for_ragged_batches(B):
    dims, strides, box = ftl.k1_tensor_map(B, 512)
    Bp = L.hbuf_pitch(B)
    assert Bp % 4 == 0 and B <= Bp < B + 4
    assert dims == (B, 512, 2)              # zeros past B, not past Bp
    assert all(st % 16 == 0 for st in strides)
    assert strides == (4 * Bp, 4 * Bp * 512)
    assert box == (64, 32, 1) and box[0] * 4 % 16 == 0
    # four copies a K slice cover its H/4 rows; one a 64-row batch tile
    assert 4 * box[1] == 512 // 4
    assert -(-B // box[0]) == -(-B // 64)


@pytest.mark.parametrize("In, B", [(128, 1), (512, 63), (1024, 65),
                                   (136, 33), (8, 9), (512, 320)])
def test_fused_chunk_map_for_ragged_batches(In, B):
    dims, strides, box = ftl.fused_chunk_map(In, B, 160)
    assert dims == (In, B, 160)
    assert all(st % 16 == 0 for st in strides)
    assert box == (64, 64, 1) and box[0] * 2 == 128   # one swizzle span
    # chunks of 128 columns and 64-row tiles cover x_t, zero-filled past
    # In and B
    assert -(-In // 128) * 128 >= In and -(-B // 64) * 64 >= B


def test_tool_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ftl.main([])


def test_f32_rows_read_the_f32_design_phases():
    """The f32 K3/K4-fwd and K7b rows name the timeline's slots after their
    design: the recurrence's wait for its item's input products, stage,
    product, cell and barrier on thread 0's chain, and the producer's
    input products (slot 7, its waits for a free slot left out). They run
    at MD_VAE's K3 and K4 widths (B=64) and, for K7b, at the unroll A/B's
    shape with K=2, both entries from the one timing build."""
    split = ftl.phase_split(_timeline(), ftl.F32_PHASES)
    assert set(split) == {"slot_wait", "stage", "product", "cell",
                          "barrier", "producer", "step"}
    for name, us in (("slot_wait", 1.0), ("stage", 2.0), ("product", 3.0),
                     ("cell", 1.5), ("producer", 4.0)):
        assert split[name] == pytest.approx(
            {"min": us, "median": us, "max": us}), name
    assert split["barrier"]["median"] == pytest.approx(1.5)
    assert {v: k for k, v in ftl.F32_PHASES.items()} == {
        2: "slot_wait", 3: "stage", 4: "product", 5: "cell", 6: "barrier",
        7: "producer"}
    assert ftl.F32_CASES == ((128, 64), (512, 64))
    assert (ftl.F32_UNROLL_K, ftl.UNROLL_B, ftl.UNROLL_IN) == (2, 128, 512)
    fwd, k7b = (ftl.TIMED["lstm_fused_fwd_f32"],
                ftl.TIMED["lstm_unroll_fused_fwd_f32"])
    assert fwd.source == k7b.source == "lstm_fused_fwd_f32_timeline"
    assert (fwd.symbol, k7b.symbol) == (
        "mlvae_lstm_fused_fwd_f32_timeline",
        "mlvae_lstm_unroll_fused_fwd_f32_timeline")
    # the normal entries' arguments, then the timeline before the stream
    assert fwd.argtypes == L.LSTM_FUSED_FWD_F32.argtypes[:-1] + [
        ctypes.c_void_p, ctypes.c_void_p]
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    assert k7b.argtypes == LU.LSTM_UNROLL_FUSED_FWD_F32.argtypes[:-1] + [
        ctypes.c_void_p, ctypes.c_void_p]
