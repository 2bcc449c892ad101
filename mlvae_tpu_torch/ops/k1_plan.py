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
- ``wide`` (528 < H <= 1024, f32 streams; ``csrc/lstm_fwd_wide.cu``,
  ``csrc/lstm_bwd_wide.cu``): eight units a block, so H/8 <= 128 blocks,
  W_hh's 32 rows of the block in shared memory (128 KB at H=1024), and
  h_{t-1} staged by the TMA box by box, since all of it (256 KB at B=64)
  does not fit beside W_hh: K1-fwd's eight K slices (a warp each) take
  boxes of ``CHUNK`` / 8 rows of k x 64 batch columns through rings of
  ``WIDE_FWD_RING`` boxes each, K1-bwd's four slices (two warps each)
  boxes of ``CHUNK`` / 4 columns x 64 rows of hs through rings of
  ``WIDE_BWD_RING``; ``ring`` counts a slice's boxes. Each slice's sums
  then take its ring (``RED_SLICE`` floats). K1-bwd's ``split`` says
  whether B takes one tile (the recompute between the barrier's arrival
  and wait). dW_hh is a kernel of its own after the recurrence
  (``k1_dw_plan``, f32).
- ``wide_bf16`` (bf16 streams at every H % 128 == 0 up to 1024, the
  whole of the JAX kernel's bf16 contract; ``csrc/lstm_fwd_wide_bf16.cu``,
  ``csrc/lstm_bwd_wide_bf16.cu``): the wide builds' grid of eight units a
  block (hence the name, at any H), its products on the tensor cores.
  W_hh's 32 rows sit in registers as mma fragments, and h_{t-1} lands
  whole from hs by the TMA (128 KB at H=1024) in ``ring`` = H/128 slices of
  ``SLICE`` columns, one mbarrier each, a warp a slice (warps past H/128
  hold none: at H=512 four of eight multiply, at H=128 one). K1-bwd also
  holds W_hh's columns of its units (4H x 8 bf16) and streams every
  block's dgates (dgx[t]) in chunks of ``XCHUNK`` gate columns through
  ``BF16_RING`` buffers, the tile's memory, two a warp; its ``split`` as
  above. dW_hh is a kernel of its own after the recurrence
  (``k1_dw_plan(..., bf16=True)``). The CRDNN's first LSTM layer (In =
  7,680 at H=512) takes it under AMP: it fits neither fused tier.

No recipe of the repo has an LSTM on K1 wider than 1024; a wider H is
refused (``ROADMAP.md`` queue 2, "Still to port"). No build takes a bf16
H that is not a multiple of 128, or any H that is not a multiple of 16:
``nn.rnn.lstm_route`` sends such a layer to ``lstm_scan``, the JAX
package's ``lax.scan``, before any launch.

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
CHUNK = 128           # rows of k whose K slices a product sums in turn
RED_UNIT = BT + 4     # a slice's sums [gate][unit][row]: a unit's pitch,
RED_GATE = 8 * RED_UNIT + 8   # a gate's (floats)
RED_SLICE = 4 * RED_GATE
WIDE_FWD_SLICES = 8   # K1-fwd (csrc/lstm_fwd_wide.cu): a warp a K slice,
WIDE_FWD_RING = 3     # boxes of CHUNK / 8 rows x 64 columns a warp
WIDE_BWD_SLICES = 4   # K1-bwd (csrc/lstm_bwd_wide.cu): two warps a slice,
WIDE_BWD_RING = 2     # boxes of CHUNK / 4 columns x 64 rows a slice
WIDE_DW_TILE = 128    # its dW_hh kernel: rows and columns of dW_hh a block
WIDE_DW_BK = 32       # K rows a stage
WIDE_DW_STAGES = 2
# the wide builds on bf16 streams (csrc/lstm_wide_mma.cuh,
# csrc/lstm_bwd_wide_bf16.cu)
SLICE = 128           # columns of a K slice of h_{t-1}
SLICE_BYTES = BT * SLICE * 2
XCHUNK = 64           # gate columns of a K1-bwd dgates chunk (8 KB)
BF16_RING = 16        # K1-bwd's dgates chunk buffers: two a warp
DW_TILE = 128         # the dW_hh kernel: rows and columns of dW_hh a block
DW_BK = 64            # K rows a stage
DW_STAGES = 3


@dataclass(frozen=True)
class K1Plan:
    variant: str      # "narrow", "wide", "wide_bf16", "dw" or "dw_bf16"
    units: int        # hidden units a block owns
    blocks: int       # the cooperative grid, H / units
    threads: int      # a block
    smem_bytes: int   # dynamic shared memory a block
    ring: int         # staged copies of h_{t-1} in flight (see above)
    cols: int = 0     # narrow K1-bwd: columns of H a thread holds rows for
    split: bool = False  # K1-bwd: the split barrier (B <= 64)


def _check(H: int, B: int) -> None:
    if H < 16 or H % 16 or B < 1:
        raise ValueError(f"K1: H={H} must be a positive multiple of 16 "
                         f"and B={B} positive; ``nn.rnn`` runs a layer "
                         "of another H as ``lstm_scan`` (the JAX "
                         "package's lax.scan), never on K1")
    if H > WIDE_MAX_H:
        raise NotImplementedError(
            f"K1: H={H} is above {WIDE_MAX_H}, the widest the port's K1 "
            "kernels take; wider LSTMs are ROADMAP.md queue 2, 'Still to "
            "port'")


def _check_bf16(H: int) -> None:
    if H % SLICE:
        raise ValueError(
            f"K1: no bf16 build takes H={H}, not a multiple of {SLICE} (nor "
            "does the JAX Pallas kernel); ``nn.rnn`` runs such a layer as "
            "``lstm_scan``, the JAX package's bf16-carry lax.scan "
            "(mlvae_tpu/nn/rnn.py:225-239)")


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


def wide_box_floats(bwd: bool) -> int:
    """The f32 wide builds' TMA box: CHUNK / slices rows (K1-fwd) or
    columns (K1-bwd) of k by 64 batch rows."""
    return CHUNK // (WIDE_BWD_SLICES if bwd else WIDE_FWD_SLICES) * BT


def wide_fwd_smem_bytes(H: int) -> int:
    """``smem_bytes`` of ``csrc/lstm_fwd_wide.cu``: the eight warps' rings
    (whose boxes the slices' sums reuse) and W_hh's 32 rows of the block,
    f32, and an mbarrier a box."""
    boxes = WIDE_FWD_SLICES * WIDE_FWD_RING
    return 4 * (boxes * wide_box_floats(False) + 32 * H) + 8 * boxes


def wide_bwd_smem_bytes(H: int) -> int:
    """``smem_bytes`` of ``csrc/lstm_bwd_wide.cu``: the four slices' rings,
    W_hh's 32 rows, the tile's dgates (64 rows of 32 gate rows) and the
    reduce's sums (64 rows of 8 units), f32, and an mbarrier a box."""
    boxes = WIDE_BWD_SLICES * WIDE_BWD_RING
    return (4 * (boxes * wide_box_floats(True) + 32 * H + BT * (32 + 8))
            + 8 * boxes)


def wide_dw_smem_bytes() -> int:
    """``dw_smem_bytes`` of ``csrc/lstm_bwd_wide.cu``: ``WIDE_DW_STAGES``
    stages of ``WIDE_DW_BK`` rows of both operands, 128 columns of f32
    each."""
    return 4 * WIDE_DW_STAGES * WIDE_DW_BK * 2 * WIDE_DW_TILE


def wide_bf16_fwd_smem_bytes(H: int) -> int:
    """``fwd_smem_bytes`` of ``csrc/lstm_fwd_wide_bf16.cu``: the h_{t-1}
    tile, H/128 slices of 64 x 128 bf16 (each slice's first half takes its
    warp's f32 sums), and an mbarrier a slice."""
    return (H // SLICE) * (SLICE_BYTES + 8)


def wide_bf16_bwd_smem_bytes(H: int) -> int:
    """``bwd_smem_bytes`` of ``csrc/lstm_bwd_wide_bf16.cu``: the tile at
    H=1024 (8 slices), which is also the ring of ``BF16_RING`` dgates
    chunks of 64 x ``XCHUNK`` bf16; the warps' dh sums (8 x 64 x 8 f32);
    W_hh's columns of the block's units (8 x (4H + 8) bf16); an mbarrier a
    slice and a ring buffer."""
    return (8 * SLICE_BYTES + 8 * BT * 8 * 4 + 8 * (4 * H + 8) * 2
            + 8 * (H // SLICE + BF16_RING))


def dw_smem_bytes() -> int:
    """``dw_smem_bytes`` of ``csrc/lstm_bwd_wide_bf16.cu``: ``DW_STAGES``
    stages of a 64-row chunk of each operand, 128 columns of bf16 each, and
    an mbarrier a stage."""
    return DW_STAGES * (2 * DW_BK * DW_TILE * 2 + 8)


@lru_cache(maxsize=None)
def k1_fwd_plan(H: int, B: int, bf16: bool = False) -> K1Plan:
    """K1-fwd's plan for a (T, B, 4H) layer, f32 or ``bf16`` streams."""
    _check(H, B)
    if bf16:
        _check_bf16(H)
        return K1Plan("wide_bf16", WIDE_UNITS, H // WIDE_UNITS, WIDE_THREADS,
                      wide_bf16_fwd_smem_bytes(H), H // SLICE)
    if H <= NARROW_MAX_H:
        nq = narrow_fwd_ring_depth(H, B)
        return K1Plan("narrow", NARROW_UNITS, H // NARROW_UNITS,
                      NARROW_THREADS, narrow_fwd_smem_bytes(H, nq), nq)
    return K1Plan("wide", WIDE_UNITS, H // WIDE_UNITS, WIDE_THREADS,
                  wide_fwd_smem_bytes(H), WIDE_FWD_RING)


@lru_cache(maxsize=None)
def k1_bwd_plan(H: int, B: int, bf16: bool = False) -> K1Plan:
    """K1-bwd's plan. The narrow build stages all of h_{t-1} for a tile
    (``ring`` counts its 32-column boxes); the bf16 one streams the dgates
    through ``BF16_RING`` chunk buffers."""
    _check(H, B)
    if bf16:
        _check_bf16(H)
        return K1Plan("wide_bf16", WIDE_UNITS, H // WIDE_UNITS, WIDE_THREADS,
                      wide_bf16_bwd_smem_bytes(H), BF16_RING,
                      split=B <= BT)
    if H <= NARROW_MAX_H:
        return K1Plan("narrow", NARROW_UNITS, H // NARROW_UNITS,
                      NARROW_THREADS, narrow_bwd_smem_bytes(H), -(-H // 32),
                      cols=2 if H <= 2 * NARROW_THREADS else 3,
                      split=B <= BT)
    return K1Plan("wide", WIDE_UNITS, H // WIDE_UNITS, WIDE_THREADS,
                  wide_bwd_smem_bytes(H), WIDE_BWD_RING, split=B <= BT)


@lru_cache(maxsize=None)
def k1_dw_plan(H: int, B: int, bf16: bool = True) -> K1Plan:
    """The dW_hh kernel after the wide K1-bwd's recurrence: blocks of a 128
    x 128 tile of dW_hh, (H/128) x (4H/128) of them, rounded up in f32;
    ``ring`` its stages (``DW_STAGES`` on bf16 streams,
    ``WIDE_DW_STAGES`` in f32)."""
    _check(H, B)
    if not bf16:
        if H <= NARROW_MAX_H:
            raise ValueError(f"K1: H={H} takes the narrow K1-bwd, which "
                             "forms dW_hh itself")
        return K1Plan("dw", 0, -(-H // WIDE_DW_TILE)
                      * -(-4 * H // WIDE_DW_TILE), WIDE_THREADS,
                      wide_dw_smem_bytes(), WIDE_DW_STAGES)
    _check_bf16(H)
    return K1Plan("dw_bf16", 0, (H // DW_TILE) * (4 * H // DW_TILE),
                  WIDE_THREADS, dw_smem_bytes(), DW_STAGES)
