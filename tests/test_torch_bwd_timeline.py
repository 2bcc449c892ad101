"""The fused backwards' step timeline (``tools/bench_bwd_timeline.py``) and
its builds, on the CPU: no normal build carries the timing define, the
timing builds have library paths of their own, the phase split reads the
stamps as the kernel writes them, and the tool's shared-memory budget
chooses the kernel's schedule. The kernels themselves run on the card
(``chip_smoke.py``)."""
import pytest
import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.tools import bench_bwd_timeline as btl


@pytest.mark.parametrize("name", _build.SOURCES)
def test_normal_builds_have_no_timing_define(name):
    assert _build.TIMELINE_DEFINE not in _build._flags(name)
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
    assert len(timed) == len(bwd)


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
