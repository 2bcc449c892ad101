"""The launch plan of the LSTM recurrence kernels K1-fwd and K1-bwd.

For a hidden width H and a batch B, ``k1_fwd_plan`` and ``k1_bwd_plan``
say which build runs and how it is laid out: the variant, the hidden units
a block owns, the blocks of the cooperative grid, the threads a block, its
dynamic shared memory in bytes and how deep its ring of staged h_{t-1}
copies is. The launch code in ``csrc/`` computes the same numbers; the
``*_plan`` entry points of the wide builds return theirs, and
``chip_smoke.py`` holds them against these.

- ``narrow`` (H <= 528; ``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``; f32
  streams only): four units a block, so H/4 blocks, every one resident on
  its own SM of an H100's 132. K1-fwd's ring holds ``ring`` TMA copies of
  H/16 x 64 floats per K slice; K1-bwd stages all of h_{t-1} for 64 batch
  rows at once and holds W_hh's and dW_hh's rows for ``cols`` columns of H
  a thread.
- ``wide`` (528 < H <= 1024; ``csrc/lstm_fwd_wide.cu``,
  ``csrc/lstm_bwd_wide.cu``): eight units a block, so H/8 <= 128 blocks,
  W_hh's 32 rows of the block in shared memory (128 KB at H=1024), and
  h_{t-1} staged in chunks of ``CHUNK`` rows of k x 64 batch columns
  through a ring of ``WIDE_RING`` buffers (``cp.async``), since all of it
  (256 KB at B=64) does not fit beside W_hh. Its bf16-stream entry points
  keep the same layout (W_hh and h_{t-1} widened to f32 in shared
  memory), so the plan holds for both stream dtypes.

No recipe of the repo has an LSTM on K1 wider than 1024; a wider H is
refused (``ROADMAP.md`` queue 2, "Still to port").

Only integers here: the CPU tests import it.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

SMEM_LIMIT = 232448   # an H100 block's dynamic shared memory, bytes
SMS = 132             # an H100 SXM's streaming multiprocessors
BT = 64               # batch rows a tile
NARROW_MAX_H = 528    # H/4 blocks, one an SM
WIDE_MAX_H = 1024     # the widest LSTM on K1 of any recipe (LSTM_FC)

# the narrow builds (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu)
NARROW_UNITS = 4
NARROW_THREADS = 256
# the wide builds (csrc/lstm_wide.cuh)
WIDE_UNITS = 8
WIDE_THREADS = 256
CHUNK = 128           # rows of k in one staged chunk of h_{t-1}
WIDE_RING = 2         # chunk buffers
PITCH = BT + 4        # floats a staged row: 16-byte rows, no bank conflicts


@dataclass(frozen=True)
class K1Plan:
    variant: str      # "narrow" or "wide"
    units: int        # hidden units a block owns
    blocks: int       # the cooperative grid, H / units
    threads: int      # a block
    smem_bytes: int   # dynamic shared memory a block
    ring: int         # staged copies of h_{t-1} in flight (see above)
    cols: int = 0     # narrow K1-bwd: columns of H a thread holds rows for
    split: bool = False  # narrow K1-bwd: the split barrier (B <= 64)


def _check(H: int, B: int) -> None:
    if H < 16 or H % 16 or B < 1:
        raise ValueError(f"K1: H={H} must be a positive multiple of 16 "
                         f"and B={B} positive")
    if H > WIDE_MAX_H:
        raise NotImplementedError(
            f"K1: H={H} is above {WIDE_MAX_H}, the widest the port's K1 "
            "kernels take; wider LSTMs are ROADMAP.md queue 2, 'Still to "
            "port'")


def narrow_fwd_smem_bytes(H: int, nq: int) -> int:
    """``smem_bytes`` of ``csrc/lstm_fwd.cu``: a ring of nq copies of
    H/16 x 64 f32 for each of the four K slices, W_hh's 16 rows, the
    split-K partials and the ring's mbarriers."""
    return 4 * (4 * nq * (H // 16) * BT + 4 * H * 4 + 4 * BT * 16) + 8 * 4 * nq


def narrow_fwd_ring_depth(H: int, B: int) -> int:
    """``ring_depth`` of ``csrc/lstm_fwd.cu``: every copy of a step (4 a
    batch tile) where they fit, else the most that fit; 0 if none does."""
    for nq in range(4 * -(-B // BT), 0, -1):
        if narrow_fwd_smem_bytes(H, nq) <= SMEM_LIMIT:
            return nq
    return 0


def narrow_bwd_smem_bytes(H: int) -> int:
    """``smem_bytes`` of ``csrc/lstm_bwd.cu``: the h_{t-1} tile of 64 rows
    in boxes of 32 columns, W_hh's 16 rows, the split-K pre-activations,
    the dgates, f32, and an mbarrier a box. It does not depend on B."""
    nbox = -(-H // 32)
    return 4 * (nbox * 64 * 32 + 16 * H + 4 * 64 * 16 + 64 * 16) + 8 * nbox


def wide_fwd_smem_bytes(H: int) -> int:
    """``wide::smem_bytes(H, false)`` of ``csrc/lstm_wide.cuh``: W_hh's 32
    rows of the block and the ring of chunks, f32; the K slices' partial
    pre-activations reuse the ring."""
    return 4 * (32 * H + WIDE_RING * CHUNK * PITCH)


def wide_bwd_smem_bytes(H: int) -> int:
    """``wide::smem_bytes(H, true)``: K1-fwd's layout and the tile's dgates
    (64 rows of 32 gate rows), f32."""
    return wide_fwd_smem_bytes(H) + 4 * BT * 32


@lru_cache(maxsize=None)
def k1_fwd_plan(H: int, B: int) -> K1Plan:
    """K1-fwd's plan for a (T, B, 4H) layer, f32 or bf16 streams."""
    _check(H, B)
    if H <= NARROW_MAX_H:
        nq = narrow_fwd_ring_depth(H, B)
        return K1Plan("narrow", NARROW_UNITS, H // NARROW_UNITS,
                      NARROW_THREADS, narrow_fwd_smem_bytes(H, nq), nq)
    return K1Plan("wide", WIDE_UNITS, H // WIDE_UNITS, WIDE_THREADS,
                  wide_fwd_smem_bytes(H), WIDE_RING)


@lru_cache(maxsize=None)
def k1_bwd_plan(H: int, B: int) -> K1Plan:
    """K1-bwd's plan. The narrow build stages all of h_{t-1} for a tile
    (``ring`` counts its 32-column boxes)."""
    _check(H, B)
    if H <= NARROW_MAX_H:
        return K1Plan("narrow", NARROW_UNITS, H // NARROW_UNITS,
                      NARROW_THREADS, narrow_bwd_smem_bytes(H), -(-H // 32),
                      cols=2 if H <= 2 * NARROW_THREADS else 3,
                      split=B <= BT)
    return K1Plan("wide", WIDE_UNITS, H // WIDE_UNITS, WIDE_THREADS,
                  wide_bwd_smem_bytes(H), WIDE_RING)
