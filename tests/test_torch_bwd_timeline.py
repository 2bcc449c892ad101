"""The LSTM backwards' step timeline (``tools/bench_bwd_timeline.py``) and
its builds, on the CPU: no normal build carries a timing define, the
timing builds (K3-bwd, K4-bwd and K1-bwd's own) have library paths of
their own, the phase splits read the stamps as the kernels write them, and
the tool's shared-memory budget chooses the kernel's schedule. The kernels
themselves run on the card (``chip_smoke.py``)."""
import re

import pytest
import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops import lstm as L
from mlvae_tpu_torch.tools import bench_bwd_timeline as btl
from mlvae_tpu_torch.tools import bench_fwd_timeline as ftl


@pytest.mark.parametrize("name", _build.SOURCES)
def test_normal_builds_have_no_timing_define(name):
    assert _build.TIMELINE_DEFINE not in _build._flags(name)
    timing = {_build.timeline_define(v) for v in _build.VARIANTS}
    assert len(timing) == 3 and not timing & set(_build._flags(name))
    assert _build.source_of(name) == name


@pytest.mark.parametrize("name", sorted(_build.VARIANTS))
def test_timing_builds_have_their_own_library(name):
    src = _build.source_of(name)
    assert src in _build.SOURCES and src != name
    assert _build.timeline_define(name) in _build._flags(name)
    assert _build._flags(name)[:len(_build._flags(src))] == _build._flags(src)
    timed, normal = _build._lib_path(name), _build._lib_path(src)
    assert timed != normal
    assert timed.name.startswith(f"lib{name}-")
    assert normal.name.startswith(f"lib{src}-")


def test_timed_kernels_are_not_counted_on_any_path():
    timed = [*btl.TIMED.values(), *btl.ABLATED.values()]
    assert all(k not in _build.KERNELS for k in timed)
    bwd = {v for v in _build.VARIANTS
           if _build.source_of(v) not in _build.FWD_TIMED}
    assert {k.source for k in timed} == bwd
    # one timed entry a variant, but the f32 K3-bwd / K4-bwd timing build
    # holds both entries
    assert len(timed) == len(bwd) + 1
    for name, normal in (("lstm_fused_bwd_f32", L.LSTM_FUSED_BWD_F32),
                         ("lstm_semi_bwd_f32", L.LSTM_SEMI_BWD_F32)):
        k = btl.TIMED[name]
        assert (k.source, k.symbol) == (btl.F32_TIMED_SRC,
                                        f"mlvae_{name}_timeline")
        assert _build.timeline_define(k.source) == _build.TIMELINE_DEFINE
        assert normal in _build.KERNELS
        assert normal.source == _build.source_of(k.source)
        assert k.argtypes[:-2] == normal.argtypes[:-1]
        assert len(k.argtypes) == len(normal.argtypes) + 1
    # K1-bwd's timing build: its own define and entry, never LSTM_BWD
    k1 = btl.TIMED["lstm_bwd"]
    assert (k1.source, k1.symbol) == ("lstm_bwd_timeline",
                                      "mlvae_lstm_bwd_timeline")
    assert _build.timeline_define(k1.source) == \
        _build.K1_BWD_TIMELINE_DEFINE
    assert _build.TIMELINE_DEFINE not in _build._flags(k1.source)
    assert L.LSTM_BWD in _build.KERNELS and L.LSTM_BWD.source == "lstm_bwd"
    assert len(k1.argtypes) == len(L.LSTM_BWD.argtypes) + 1


def _stamps(T=4, blocks=3):
    """Stamps as the kernel writes them: step s of block k starts at
    10 ms * (s + 10 k); dgates 2 us, dW 3, recompute 4 (warps 4-7), wait 1,
    exchange 5 (warps 0-3), join at the later group + 0.5 us; block k's
    exchange takes k us more."""
    st = torch.zeros((T, blocks, btl.STAMPS), dtype=torch.int64)
    for s in range(T):
        for k in range(blocks):
            t0 = 10_000_000 * (s + 10 * k)
            arrive = t0 + 2000
            w_end = arrive + 3000 + 4000
            x_end = arrive + 1000 + 5000 + 1000 * k
            st[s, k] = torch.tensor([t0, arrive, arrive + 3000, w_end,
                                     arrive + 1000, x_end,
                                     max(w_end, x_end) + 500])
    return st


def test_phase_split_reads_the_stamps():
    split = btl.phase_split(_stamps())
    assert set(split) == set(btl.PHASES)
    for name, us in (("dgates", 2.0), ("dW", 3.0), ("recompute", 4.0),
                     ("wait", 1.0), ("warps_4_7", 7.0)):
        assert split[name] == pytest.approx(
            {"min": us, "median": us, "max": us}), name
    assert split["exchange"] == pytest.approx(
        {"min": 5.0, "median": 6.0, "max": 7.0})
    assert split["warps_0_3"] == pytest.approx(
        {"min": 6.0, "median": 7.0, "max": 8.0})
    # the join follows the later group: 7.5, 7.5, 8.5 us after the arrival
    assert split["step"] == pytest.approx(
        {"min": 9.5, "median": 9.5, "max": 10.5})



def _tl_slots(text):
    """The TL_<PHASE> = slot names a source or header gives."""
    return {m.group(1).lower(): int(m.group(2))
            for m in re.finditer(r"\bTL_([A-Z_]+) = (\d+)", text)}


@pytest.mark.parametrize("src, phases", [("lstm_bwd", btl.K1_PHASES),
                                         ("lstm_bwd_wide_bf16",
                                          btl.WIDE_PHASES),
                                         ("gru_bwd", btl.K1_PHASES),
                                         ("lstm_bwd_wide", btl.K1_PHASES),
                                         ("lstm_fused_bwd_f32",
                                          btl.K1_PHASES)])
def test_k1_bwd_sources_share_the_timeline_clock(src, phases):
    """The K1-bwd timing builds (narrow; wide, f32 and bf16) and the f32
    K5-bwd's take the clock and macros from bwd_timeline.cuh and name only
    their own two slots; together they are the phases the tool reads."""
    header = (_build.CSRC / "bwd_timeline.cuh").read_text()
    text = (_build.CSRC / f"{src}.cu").read_text()
    assert '#include "bwd_timeline.cuh"' in text
    for own in ("tl_now", "struct TlClock", "#define TL_MARK", "TL_SLOTS ="):
        assert own in header and own not in text, own
    shared, named = _tl_slots(header), _tl_slots(text)
    assert shared.pop("slots") == btl.K1_SLOTS
    assert set(named.values()) == {5, 7} and not set(shared) & set(named)
    assert {**shared, **named} == phases

def _k1_timeline(T=4, blocks=3):
    """K1-bwd's timeline as thread 0 writes it: step s of block k starts at
    10 ms * (s + 10 k) and ends 20 + k us later; stage 1 us, recompute 4,
    cell 2, partial_dw 8, wait 0.5 + k, reduce 1.5, barrier 5.75 + k,
    loads 0.25 (ns sums)."""
    tl = torch.zeros((T, blocks, btl.K1_SLOTS), dtype=torch.int64)
    for s in range(T):
        for k in range(blocks):
            t0 = 10_000_000 * (s + 10 * k)
            tl[s, k] = torch.tensor([t0, t0 + 20000 + 1000 * k, 1000, 4000,
                                     2000, 8000, 500 + 1000 * k, 1500,
                                     5750 + 1000 * k, 250])
    return tl


def test_k1_phase_split_reads_the_timeline():
    split = ftl.phase_split(_k1_timeline(), btl.K1_PHASES)
    assert set(split) == {*btl.K1_PHASES, "step"}
    for name, us in (("stage", 1.0), ("recompute", 4.0), ("cell", 2.0),
                     ("partial_dw", 8.0), ("reduce", 1.5), ("loads", 0.25)):
        assert split[name] == pytest.approx(
            {"min": us, "median": us, "max": us}), name
    assert split["wait"] == pytest.approx(
        {"min": 0.5, "median": 1.5, "max": 2.5})
    assert split["barrier"] == pytest.approx(
        {"min": 5.75, "median": 6.75, "max": 7.75})
    assert split["step"] == pytest.approx(
        {"min": 20.0, "median": 21.0, "max": 22.0})


@pytest.mark.parametrize("schedule", ["split", "exchange"])
def test_f32_bwd_phase_split_reads_the_timeline(schedule):
    """The f32 K3-bwd / K4-bwd rows read K1-bwd's slots in both schedules:
    the exchange schedule leaves stage and loads 0 (its copies lie in its
    recompute and dW), and K4's step 0 (no pass, no barrier) leaves its
    pass, wait and reduce 0. The tool's rows reach each schedule where the
    plan takes it (K3 at In=128 and K4 at In=512 split-K, K3 at In=256 the
    exchange schedule), never by force."""
    tl = _k1_timeline(T=2, blocks=3)
    if schedule == "exchange":
        tl[..., btl.K1_PHASES["stage"]] = 0
        tl[..., btl.K1_PHASES["loads"]] = 0
    for slot in ("partial_dw", "wait", "reduce", "barrier"):
        tl[0, :, btl.K1_PHASES[slot]] = 0
    split = ftl.phase_split(tl, btl.K1_PHASES)
    assert set(split) == {*btl.K1_PHASES, "step"}
    # the tool times this schedule where the plan takes it, at every batch
    want = {"split": L.F32_SPLIT, "exchange": L.F32_EXCHANGE}[schedule]
    assert btl.F32_SCHEDULE_NAMES[want] == schedule
    kinds = {"lstm_fused_bwd_f32": "bwd", "lstm_semi_bwd_f32": "semi"}
    for B in btl.BATCHES:
        assert [In for name, In in btl.F32_CASES if L.fused_f32_bwd_plan(
            kinds[name], In, btl.H, B).schedule == want] == (
                [128, 512] if schedule == "split" else [256])
    assert split["partial_dw"]["median"] == pytest.approx(4.0)
    assert split["reduce"]["median"] == pytest.approx(0.75)
    assert split["wait"] == pytest.approx(
        {"min": 0.25, "median": 0.75, "max": 1.25})
    assert split["stage"]["median"] == pytest.approx(
        0.0 if schedule == "exchange" else 1.0)
    assert split["step"] == pytest.approx(
        {"min": 20.0, "median": 21.0, "max": 22.0})


@pytest.mark.parametrize("kernel", ["LSTM_FUSED_BWD_F32",
                                    "LSTM_SEMI_BWD_F32"])
def test_f32_bwd_entries_take_the_size_of_their_scratch(kernel):
    """The f32 backwards' C entries take the floats of their ``work``
    scratch (so that they refuse a smaller one) after ``reverse``, as a
    64-bit int, and no schedule: the C code chooses it."""
    k = getattr(L, kernel)
    text = (_build.CSRC / "lstm_fused_bwd_f32.cu").read_text()
    sig = re.search(rf"int {k.symbol}\(\n#endif\n([^)]*)\)", text).group(1)
    params = [p.strip() for p in sig.replace("TL_ARG", "").split(",")]
    assert len(params) == len(k.argtypes)
    assert params[-3:-1] == ["int reverse", "long long work_size"]
    assert k.argtypes[-2] is L._LL and "schedule" not in sig


def test_k1_phase_split_means_over_steps_then_blocks():
    tl = _k1_timeline(T=2, blocks=1)
    tl[1, 0, btl.K1_PHASES["stage"]] = 3000   # 1 us, then 3 us
    tl[0, 0, btl.K1_PHASES["partial_dw"]] = 0  # step 0: no pass
    split = ftl.phase_split(tl, btl.K1_PHASES)
    assert split["stage"]["median"] == pytest.approx(2.0)
    assert split["partial_dw"]["median"] == pytest.approx(4.0)


@pytest.mark.parametrize("H", [512, 64])
@pytest.mark.parametrize("B", [1, 64, 65, 256])
def test_k1_bwd_scratch_shapes(B, H):
    gx = torch.zeros((3, B, 4 * H))
    dc_last = torch.randn((B, H))
    part, dh_buf, dc_buf, barrier = L.k1_bwd_scratch(gx, dc_last)
    assert part.shape == (2, H // 4, B, H) and part.dtype == torch.float32
    assert dh_buf.shape == (B, H) and not dh_buf.any()
    assert torch.equal(dc_buf, dc_last) and dc_buf is not dc_last
    assert barrier.shape == (1,) and barrier.dtype == torch.int32
    assert not barrier.any()


@pytest.mark.parametrize("H, nbytes", [(512, 184448), (64, 40976)])
@pytest.mark.parametrize("B", [1, 64, 65, 256])
def test_k1_bwd_shared_memory_and_schedule(B, H, nbytes):
    # the tile (H/32 boxes of 64 x 32 f32), W_hh's rows, red_s, dg_s and an
    # mbarrier a box, whatever B; one tile splits its barrier
    assert btl.k1_bwd_smem_bytes(H) == nbytes
    assert btl.k1_bwd_smem_bytes(H) <= 232448
    split, cols = btl.k1_bwd_schedule(B, H)
    assert split is (B <= 64) and cols == 2


@pytest.mark.parametrize("H, cols", [(16, 2), (512, 2), (528, 3)])
def test_k1_bwd_columns_a_thread_cover_h(H, cols):
    # 256 threads hold W_hh's and dW_hh's rows for KP columns each
    assert btl.k1_bwd_schedule(64, H) == (True, cols)
    assert btl.k1_bwd_schedule(65, H) == (False, cols)
    assert 256 * (cols - 1) < H <= 256 * cols or cols == 2


def test_k1_bwd_fits_every_shape_the_launch_takes():
    for H in range(16, 529, 16):
        assert btl.k1_bwd_smem_bytes(H) <= 232448, H


@pytest.mark.parametrize("B", [1, 63, 64, 65, 70, 200, 256])
@pytest.mark.parametrize("H", [512, 64, 16])
def test_k1_bwd_tensor_map_strides_and_box(B, H):
    dims, strides, box = btl.k1_bwd_tensor_map(160, B, H)
    assert dims == (H, B, 160)
    # the TMA wants 16-byte strides and a box row of at most the 128-byte
    # swizzle's span; rows past B and columns past H arrive as zeros
    assert all(st % 16 == 0 for st in strides)
    assert strides == (4 * H, 4 * H * B)
    assert box == (32, 64, 1) and box[0] * 4 == 128
    assert -(-H // box[0]) * box[0] * box[1] * 4 <= \
        btl.k1_bwd_smem_bytes(H)


def test_phase_split_counts_an_unwritten_stamp_as_its_phase_start():
    st = _stamps(T=2, blocks=1)
    st[0, 0, 4] = 0     # K4's step 0: no wait, no exchange
    st[0, 0, 5] = 0
    split = btl.phase_split(st)
    assert split["wait"]["median"] == pytest.approx(0.5)      # (0 + 1) / 2
    assert split["exchange"]["median"] == pytest.approx(2.5)  # (0 + 5) / 2


@pytest.mark.parametrize("semi, In, B, nbytes, ahead", [
    (False, 512, 64, 203936, True),     # K3 on the AMP step
    (True, 1024, 64, 171104, True),     # K4 on the AMP step
    (False, 512, 256, 223136, True),    # the JAX bench's B: four tiles
    (True, 1024, 256, 190304, True),
    (False, 512, 320, 171168, False),   # five tiles: the serial schedule
    (False, 128, 64, None, True),
])
def test_shared_memory_budget_chooses_the_schedule(semi, In, B, nbytes,
                                                   ahead):
    if nbytes is not None:
        assert btl.bwd_smem_bytes(semi, In, 512, B, ahead) == nbytes
    assert btl.keeps_tiles(semi, In, 512, B) is ahead


def _one_chunk_tile_smem(semi, In, H):
    """Shared memory of the plainest layout of the same walk: one batch
    tile, one 256-column chunk tile, a separate f32 dgates scratch and dW at
    pitch Kp. The kernels took every shape that fits it, and must go on
    taking them."""
    passes = 0 if semi else -(-(In // 4) // (H // 4))
    Kp = H if semi else In + H
    return (4 * (16 * Kp + 2 * 64 * 16)
            + 2 * (16 * (In + H + 8) + 64 * 264 + 16 * 72
                   + (4 * passes + 4) * (4 * H + 8)))


@pytest.mark.parametrize("semi", [False, True], ids=["K3", "K4"])
def test_serial_schedule_fits_wherever_one_chunk_tile_fits(semi):
    for H in range(16, 529, 16):
        for In in range(8, 4097, 8):
            if not semi and -(-(In // 4) // (H // 4)) > 4:
                continue   # K3-bwd refuses In > 4H
            if _one_chunk_tile_smem(semi, In, H) <= 232448:
                assert btl.bwd_smem_bytes(semi, In, H, 64, False) <= \
                    _one_chunk_tile_smem(semi, In, H), (In, H)


def test_tool_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        btl.main([])
