"""GRU recurrence kernels (K5-fwd, K5-bwd), their plain PyTorch versions,
and the autograd seam between them (counterpart of
``mlvae_tpu/ops/gru_pallas.py``).

The input projection ``x @ W_ih^T + b_ih`` stays outside (a plain
``torch.matmul`` in ``nn.rnn.GRU``); the recurrence runs here, in torch gate
order (r, z, n) with zero initial state and an f32 carry:

    gh = h_{t-1} @ W_hh^T + b_hh
    r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z)
    n = tanh(gx_n + r * gh_n)          # b_hn inside the reset product
    h_t = (1 - z) * n + z * h_{t-1}

so b_hh is a kernel input (it cannot be folded into gx). ``reverse``
processes t = T-1 .. 0 by indexing; outputs stay in natural time order.

Streams are f32 or bf16 (AMP). Under bf16, as the Pallas kernels round:
h_{t-1} is cast to the weights' dtype before the product, which sums in
f32; hs is written in the stream dtype and the exact f32 carry beside it
(``hs32``); the backward reads the bf16 h_{t-1} for its three products and
the f32 one for its elementwise chain, casts dgh to the weights' dtype
before ``dgh @ W_hh`` and ``h_prev^T @ dgh``, sums db_hh from the f32 dgh,
and writes dgx in the stream dtype.

``gru_layer_fwd`` / ``gru_layer_bwd`` run, for CUDA tensors, the build
that ``k5_plan`` picks, and ``gru_layer_ref`` / ``gru_layer_bwd_ref`` for
CPU tensors only; ``GRURecurrence`` joins them. f32 streams take
``csrc/gru_fwd.cu`` / ``csrc/gru_bwd.cu`` (CUDA-core FMAs, four units a
block, h_{t-1} from hs by the TMA, ``csrc/gru_common.cuh``); bf16 streams
take ``csrc/gru_fwd_bf16.cu`` / ``csrc/gru_bwd_bf16.cu`` (the tensor
cores, eight units a group of blocks, ``csrc/gru_mma.cuh``), whose
backward is two kernels: the recurrence, then dW_hh (``gru_dw_ref`` is its
plain version).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from mlvae_tpu_torch import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

GRU_FWD = _build.register(_build.Kernel(
    "gru_fwd", "gru_fwd", "mlvae_gru_fwd", [_P] * 5 + [_I] * 4 + [_P]))
GRU_BWD = _build.register(_build.Kernel(
    "gru_bwd", "gru_bwd", "mlvae_gru_bwd", [_P] * 11 + [_I] * 4 + [_P]))
GRU_FWD_BF16 = _build.register(_build.Kernel(
    "gru_fwd_bf16", "gru_fwd_bf16", "mlvae_gru_fwd_bf16",
    [_P] * 6 + [_I] * 4 + [_P]))
GRU_BWD_BF16 = _build.register(_build.Kernel(
    "gru_bwd_bf16", "gru_bwd_bf16", "mlvae_gru_bwd_bf16",
    [_P] * 11 + [_I] * 4 + [_P]))
GRU_DW_BF16 = _build.register(_build.Kernel(
    "gru_dw_bf16", "gru_bwd_bf16", "mlvae_gru_dw_bf16",
    [_P] * 4 + [_I] * 4 + [_P]))

SMEM_LIMIT = 232448   # an H100 block's dynamic shared memory, bytes
SMS = 132             # an H100 SXM's streaming multiprocessors
K5_MAX_H = 528        # every build needs H/4 co-resident blocks, one an SM
BT = 64               # batch rows a tile
BOX = 64              # columns of a TMA box (bf16 builds)
F32_UNITS = 4         # csrc/gru_common.cuh
BF16_UNITS = 8        # csrc/gru_mma.cuh
THREADS = 256
F32_BOXC = 32         # columns of an f32 TMA box (csrc/gru_common.cuh: BOXC)
F32_RP = BT + 8       # row pitch of the f32 builds' split-K sums (RP)
# Rows of each 64-row batch tile a bf16 block takes (csrc/gru_mma.cuh: RB):
# two blocks on each group of eight units, H/4 blocks (128 at H=512)
BF16_ROWS = 32
XBUFS = 2             # the bf16 K5-bwd's ring buffers a warp
DW_M, DW_N, DW_BK, DW_STAGES = 64, 128, 64, 4   # the dW_hh kernel's tiles


@dataclass(frozen=True)
class K5Plan:
    build: str        # "f32" or "bf16"
    rows: int         # batch rows of a 64-row tile a block takes
    blocks: int       # the grid (cooperative for the recurrences)
    threads: int
    smem_bytes: int   # dynamic shared memory a block
    boxes: int        # the recurrences' TMA boxes of h_{t-1}; 0 for dw


def _boxes(cols: int) -> int:
    return -(-cols // BOX)


def k5_plan(direction: str, H: int, bf16: bool) -> K5Plan:
    """The build of K5 that runs ``direction`` ("fwd", "bwd", or on bf16
    streams "dw", K5-bwd's dW_hh kernel) at hidden width H, and its launch
    as the ``csrc`` code computes it. f32 streams: ``gru_fwd.cu`` /
    ``gru_bwd.cu``, H/4 blocks of four units, each staging a 64-row tile
    of h_{t-1} whole in 32-column boxes. bf16 streams: the tensor-core
    builds, H/8 groups of eight units with two blocks of 32 rows each.
    Every H that is a multiple of 16 up to 528 runs in both dtypes (H/4
    blocks resident on an H100's 132 SMs); another H is refused."""
    if H < 16 or H % 16:
        raise ValueError(f"K5: H={H} must be a positive multiple of 16; "
                         "``nn.rnn`` runs a layer of another H as "
                         "``gru_scan`` (the JAX package's lax.scan)")
    if H > K5_MAX_H:
        raise NotImplementedError(
            f"K5: H={H} above {K5_MAX_H}: every build keeps H/4 blocks of "
            "one cooperative grid resident, one an SM of an H100's "
            f"{SMS} (ROADMAP.md queue 2, 'Still to port')")
    if not bf16:
        if direction not in ("fwd", "bwd"):
            raise ValueError(f"K5: no f32 build runs {direction!r}")
        nb = -(-H // F32_BOXC)
        rows = 3 * F32_UNITS
        # the tile, W_hh's rows [k][unit][r, z, n, 0], the split-K sums
        # (and K5-bwd's dgh rows), f32; an mbarrier a box
        floats = nb * BT * F32_BOXC + 4 * H * F32_UNITS + 4 * rows * F32_RP
        if direction == "bwd":
            floats += BT * rows
        return K5Plan("f32", BT, H // F32_UNITS, THREADS, 4 * floats + 8 * nb,
                      nb)
    box_bytes = BF16_ROWS * BOX * 2
    parts = 8 * 3 * 2 * 32 * 8           # the K parts' sums (float2s)
    nb = _boxes(H)
    if direction == "fwd":
        smem = nb * (box_bytes + 8) + parts
    elif direction == "bwd":
        smem = (nb + 8 * XBUFS) * (box_bytes + 8) + parts
    elif direction == "dw":
        blocks = -(-H // DW_N) * (_boxes(2 * H) + _boxes(H))
        return K5Plan("bf16", DW_BK, blocks, THREADS,
                      DW_STAGES * (DW_BK * (DW_M + DW_N) * 2 + 8), 0)
    else:
        raise ValueError(f"K5: no direction {direction!r}")
    return K5Plan("bf16", BF16_ROWS, H // BF16_UNITS * (BT // BF16_ROWS),
                  THREADS, smem, nb)

_STREAMS = (torch.float32, torch.bfloat16)


def _gates(gx_t: torch.Tensor, gh: torch.Tensor, H: int):
    """(r, z, n, gh_n) of one step from f32 gx_t and gh (B, 3H)."""
    r = torch.sigmoid(gx_t[:, :H] + gh[:, :H])
    z = torch.sigmoid(gx_t[:, H:2 * H] + gh[:, H:2 * H])
    hn = gh[:, 2 * H:]
    return r, z, torch.tanh(gx_t[:, 2 * H:] + r * hn), hn


def gru_layer_ref(gx: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  reverse: bool = False):
    """Plain recurrence: gx (T, B, 3H) in the stream dtype, w_hh (3H, H),
    b_hh (3H,) f32 -> (hs (T, B, H) in gx's dtype, hs32 (T, B, H) f32 under
    bf16, None in f32 where hs is exact)."""
    T, B, G = gx.shape
    H = G // 3
    w_t = w_hh.float().t()
    b = b_hh.float()
    h = gx.new_zeros((B, H), dtype=torch.float32)
    hs = gx.new_empty((T, B, H))
    hs32 = None if gx.dtype == torch.float32 else \
        gx.new_empty((T, B, H), dtype=torch.float32)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = h.to(w_hh.dtype).float() @ w_t + b
        r, z, n, _ = _gates(gx[t].float(), gh, H)
        h = (1.0 - z) * n + z * h
        hs[t] = h.to(hs.dtype)
        if hs32 is not None:
            hs32[t] = h
    return hs, hs32


def gru_layer_bwd_ref(gx: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor, hs: torch.Tensor,
                      hs32, dhs: torch.Tensor, reverse: bool = False,
                      with_dgh: bool = False):
    """Plain BPTT (the work of K5-bwd): the forward's inputs, its hs (and
    hs32 under bf16), the cotangents dhs (T, B, H) -> (dgx (T, B, 3H) in
    gx's dtype, dW_hh (3H, H) f32, db_hh (3H,) f32), and with ``with_dgh``
    also dgh = [dr', dz', dn' r] (T, B, 3H) in W_hh's dtype, the operand of
    both products.

    Walks the processing order backward from dh = 0, recomputing gh from
    the saved h_{t-1} (zero at the first processed step, t=0, or t=T-1
    when ``reverse``)."""
    T, B, G = gx.shape
    H = G // 3
    wd = w_hh.dtype
    w = w_hh.float()
    b = b_hh.float()
    h32 = hs if hs32 is None else hs32
    dgx = gx.new_empty((T, B, G))
    dw = gx.new_zeros((G, H), dtype=torch.float32)
    db = gx.new_zeros((G,), dtype=torch.float32)
    dh = gx.new_zeros((B, H), dtype=torch.float32)
    zeros = torch.zeros_like(dh)
    dghs = gx.new_empty((T, B, G), dtype=wd) if with_dgh else None
    for s in range(T - 1, -1, -1):          # processing steps, backward
        t = T - 1 - s if reverse else s
        tp = t + 1 if reverse else t - 1     # previous processed position
        h_prev = zeros if s == 0 else hs[tp].to(wd).float()
        h_prev_f = zeros if s == 0 else h32[tp].float()
        r, z, n, hn = _gates(gx[t].float(), h_prev @ w.t() + b, H)
        dh = dhs[t].float() + dh
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dz_pre = dh * (h_prev_f - n) * z * (1.0 - z)
        dgx[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=1).to(dgx.dtype)
        dgh = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=1)
        dgh_w = dgh.to(wd).float()
        if with_dgh:
            dghs[t] = dgh_w.to(wd)
        dh = dh * z + dgh_w @ w
        dw += dgh_w.t() @ h_prev
        db += dgh.sum(0)
    if with_dgh:
        return dgx, dw, db, dghs
    return dgx, dw, db


def gru_dw_ref(dgx: torch.Tensor, dgn: torch.Tensor, hs: torch.Tensor,
               reverse: bool = False) -> torch.Tensor:
    """Plain dW_hh of the bf16 K5-bwd from its operands (the work of the
    dW_hh kernel): bf16(dgh) = [dgx's r and z columns | dgn] (T, B, 3H),
    dgn (T, B, H) holding bf16(dn' r), and hs (T, B, H) shifted by a step,
    summed in f32 -> (3H, H) f32: the sum over the processing order's
    steps s >= 1 of bf16(dgh)[t_s]^T hs[t_{s-1}] (the first processed
    step's h_{t-1} is zero)."""
    T, B, G = dgx.shape
    H = hs.shape[2]
    if T < 2:
        return dgx.new_zeros((G, H), dtype=torch.float32)
    dgh = torch.cat([dgx[..., :2 * H], dgn], dim=2)
    x, y = (dgh[:-1], hs[1:]) if reverse else (dgh[1:], hs[:-1])
    return x.reshape(-1, G).float().t() @ y.reshape(-1, H).float()


def _check(name: str, gx, w_hh, b_hh, extra=()) -> None:
    """A kernel's inputs: one CUDA device; gx, w_hh (and hs, dhs) in one
    stream dtype, f32 or bf16; b_hh (and hs32) f32; contiguous and 16-byte
    aligned; shapes (T, B, 3H), (3H, H), (3H,) with H a multiple of 16."""
    tensors = (gx, w_hh, b_hh) + tuple(extra)
    dev = gx.device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(x.device) for x in tensors})}; all "
                         "must be on one CUDA device")
    if gx.dtype not in _STREAMS or w_hh.dtype != gx.dtype:
        raise NotImplementedError(
            f"{name}: the kernel takes f32 or bf16 streams with W_hh in the "
            f"stream dtype (got gx {gx.dtype}, w_hh {w_hh.dtype})")
    if b_hh.dtype != torch.float32:
        raise ValueError(f"{name}: b_hh must be f32 (got {b_hh.dtype})")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous and "
                         "16-byte aligned")
    if gx.dim() != 3 or gx.shape[2] % 3:
        raise ValueError(f"{name}: gx {tuple(gx.shape)} is not (T, B, 3H)")
    H = gx.shape[2] // 3
    if w_hh.shape != (3 * H, H) or b_hh.shape != (3 * H,):
        raise ValueError(f"{name}: w_hh {tuple(w_hh.shape)}, b_hh "
                         f"{tuple(b_hh.shape)} are not (3H, H), (3H,) for "
                         f"H={H}")
    if H % 16:
        raise ValueError(f"{name}: H={H} must be a multiple of 16")


def gru_layer_fwd(gx: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  reverse: bool = False):
    """K5-fwd: same contract as ``gru_layer_ref``. CPU tensors take the
    plain version; CUDA tensors launch the build ``k5_plan`` picks (f32:
    ``gru_fwd.cu``; bf16: ``gru_fwd_bf16.cu``) or raise: an H above 528,
    whose blocks cannot all be resident at once, ``NotImplementedError``."""
    if gx.device.type == "cpu":
        return gru_layer_ref(gx, w_hh, b_hh, reverse)
    _check("gru_layer_fwd", gx, w_hh, b_hh)
    T, B, G = gx.shape
    H = G // 3
    plan = k5_plan("fwd", H, gx.dtype == torch.bfloat16)
    bf16 = plan.build == "bf16"
    hs = torch.empty((T, B, H), device=gx.device, dtype=gx.dtype)
    hs32 = torch.empty((T, B, H), device=gx.device,
                       dtype=torch.float32) if bf16 else None
    if not (T and B):
        return hs, hs32
    # the step barrier's counter
    barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
    stream = _build.stream_handle(gx.device)
    if bf16:
        # the next step stages h_{t-1} from hs itself (TMA, 16-byte base)
        GRU_FWD_BF16(gx.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                     hs.data_ptr(), hs32.data_ptr(), barrier.data_ptr(), T,
                     B, H, int(reverse), stream)
    else:
        # the next step copies h_{t-1} from hs itself (TMA, 16-byte base)
        GRU_FWD(gx.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                hs.data_ptr(), barrier.data_ptr(), T, B, H, int(reverse),
                stream)
    return hs, hs32


def gru_layer_bwd(gx: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  hs: torch.Tensor, hs32, dhs: torch.Tensor,
                  reverse: bool = False):
    """K5-bwd: same contract as ``gru_layer_bwd_ref``. CPU tensors take the
    plain version; CUDA tensors launch the build ``k5_plan`` picks or raise,
    as K5-fwd. On bf16 streams two kernels launch: the recurrence (dgx, and
    the n column of bf16(dgh) into a scratch), then the dW_hh kernel
    (``gru_dw_ref``), which a T=1 layer, whose only step has h_{t-1} = 0,
    does without."""
    if gx.device.type == "cpu":
        return gru_layer_bwd_ref(gx, w_hh, b_hh, hs, hs32, dhs, reverse)
    bf16 = gx.dtype == torch.bfloat16
    if bf16 != (hs32 is not None):
        raise ValueError("gru_layer_bwd: hs32 is given for bf16 streams and "
                         "only for them")
    _check("gru_layer_bwd", gx, w_hh, b_hh,
           (hs, dhs) + ((hs32,) if bf16 else ()))
    T, B, G = gx.shape
    H = G // 3
    if (hs.shape != (T, B, H) or dhs.shape != (T, B, H)
            or hs.dtype != gx.dtype or dhs.dtype != gx.dtype
            or (bf16 and (hs32.shape != (T, B, H)
                          or hs32.dtype != torch.float32))):
        raise ValueError(f"gru_layer_bwd: hs/dhs {tuple(hs.shape)}/"
                         f"{tuple(dhs.shape)} ({hs.dtype}/{dhs.dtype}) are "
                         f"not (T, B, H) in gx's dtype, or hs32 is not f32")
    plan = k5_plan("bwd", H, bf16)
    dgx = torch.empty_like(gx)
    dw = torch.zeros((G, H), device=gx.device, dtype=torch.float32)
    db = torch.zeros((G,), device=gx.device, dtype=torch.float32)
    if not (T and B):
        return dgx, dw, db
    # the dh carry (zero at the start; f32 at B <= 64 keeps it in
    # registers), each entry touched by one thread only; the step
    # barrier's counter
    dh_buf = torch.zeros((B, H), device=gx.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
    stream = _build.stream_handle(gx.device)
    if bf16:
        # bf16(dn' r), the n column of the products' operand bf16(dgh)
        dgn = torch.empty((T, B, H), device=gx.device, dtype=gx.dtype)
        GRU_BWD_BF16(gx.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                     hs.data_ptr(), hs32.data_ptr(), dhs.data_ptr(),
                     dgx.data_ptr(), dgn.data_ptr(), db.data_ptr(),
                     dh_buf.data_ptr(), barrier.data_ptr(), T, B, H,
                     int(reverse), stream)
        if T > 1:
            GRU_DW_BF16(dgx.data_ptr(), dgn.data_ptr(), hs.data_ptr(),
                        dw.data_ptr(), T, B, H, int(reverse), stream)
    else:
        # each block's split-K share of dgh @ W_hh, (block, unit group, row,
        # unit), ping-ponged between steps
        part = torch.empty((2, H // F32_UNITS, B, H), device=gx.device,
                           dtype=torch.float32)
        GRU_BWD(gx.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                hs.data_ptr(), dhs.data_ptr(), dgx.data_ptr(), dw.data_ptr(),
                db.data_ptr(), part.data_ptr(), dh_buf.data_ptr(),
                barrier.data_ptr(), T, B, H, int(reverse), stream)
    return dgx, dw, db


def k5_launch_plan(direction: str, H: int, B: int, bf16: bool) -> dict:
    """What a build of ``direction`` ("fwd", "bwd", on bf16 streams also
    "dw") computes for its launch at H, B (its ``*_plan`` entry point):
    blocks, threads, shared memory bytes, resident blocks an SM, boxes (fwd;
    f32 bwd) / ring buffers (bf16 bwd) / stages (dw), rows a block / K rows
    a stage, registers and local memory bytes a thread. Builds the library;
    needs the card. Not a launch: it counts nowhere."""
    kernel = ({"fwd": GRU_FWD_BF16, "bwd": GRU_BWD_BF16, "dw": GRU_DW_BF16}
              if bf16 else {"fwd": GRU_FWD, "bwd": GRU_BWD})[direction]
    fn = getattr(_build.library(kernel.source), f"{kernel.symbol}_plan")
    args = {"fwd": (H,), "bwd": (H, B), "dw": (H,)}[direction]
    fn.argtypes = [_I] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    code = fn(*args, out)
    if code:
        raise RuntimeError(f"{kernel.name} plan: CUDA error {code}")
    keys = ("blocks", "threads", "smem_bytes", "blocks_per_sm", "ring",
            "rows", "registers", "local_bytes")
    return dict(zip(keys, list(out)))


class GRURecurrence(torch.autograd.Function):
    """The differentiable recurrence (the JAX package's ``gru_layer``
    custom VJP): ``apply(gx, w_hh, b_hh, reverse) -> hs (T, B, H)``.
    Forward is ``gru_layer_fwd`` and saves (gx, w_hh, b_hh, hs, hs32);
    backward is ``gru_layer_bwd`` and returns dgx, dW_hh in w_hh's dtype
    and torch's (3H, H) layout, and db_hh in b_hh's dtype. A cotangent that
    autograd leaves undefined is zeros."""

    @staticmethod
    def forward(ctx, gx, w_hh, b_hh, reverse: bool):
        hs, hs32 = gru_layer_fwd(gx, w_hh, b_hh, reverse)
        ctx.save_for_backward(gx, w_hh, b_hh, hs, hs32)
        ctx.reverse = reverse
        ctx.set_materialize_grads(False)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        gx, w_hh, b_hh, hs, hs32 = ctx.saved_tensors
        dhs = (torch.zeros_like(hs) if dhs is None
               else dhs.to(hs.dtype).contiguous())
        dgx, dw, db = gru_layer_bwd(gx, w_hh, b_hh, hs, hs32, dhs,
                                    ctx.reverse)
        return dgx, dw.to(w_hh.dtype), db.to(b_hh.dtype), None
