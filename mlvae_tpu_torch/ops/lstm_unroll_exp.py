"""The K-unrolled LSTM forwards (K7a, K7b), their plain PyTorch versions,
their launch plans and the checks of their wrappers: the port's
counterpart of the JAX package's ``ops/lstm_unroll_exp.py``, an
experiment that processes K consecutive time steps per iteration of the
recurrence.

- ``run_fwd_k`` (K7a): K1-fwd's recurrence over precomputed gates, gx
  (T, B, 4H) and W_hh (4H, H) in f32 or bf16, with the gates of a group
  of K steps staged in shared memory a group ahead. The result does not
  depend on K and is bit-identical to K1-fwd of its dtype
  (``ops.lstm.lstm_layer_fwd``), its one-step twin: f32 streams run
  ``csrc/lstm_unroll_fwd.cu`` (K1-fwd's narrow build, H a multiple of 16
  up to 528), bf16 streams ``csrc/lstm_unroll_fwd_bf16.cu`` (the
  tensor-core build that ``lstm_layer_fwd`` runs on bf16 streams, H a
  multiple of 128 up to 1024, the JAX dispatch's rule).
- ``run_fwd_fused_k`` (K7b): K3/K4-fwd's recurrence with the input
  projection inside, x (T, B, In), W_ih (4H, In) and W_hh in one stream
  dtype and an f32 bias, the input products of a group of K steps formed
  ahead of their barriers into K slots; bit-identical to K3/K4-fwd
  (``ops.lstm.lstm_fused_fwd``) of its dtype. bf16 streams run
  ``csrc/lstm_unroll_fused_fwd.cu``; f32 streams the K entry point of
  K3/K4-fwd's f32 build (``csrc/lstm_fused_fwd_f32.cu``), registered as
  its own kernel, its layout ``ops.lstm.fused_f32_fwd_plan`` with K.

Both are forward only, as the JAX module is. The contract is the JAX one:
T a multiple of K (else ``ValueError``, on every device), hs in the stream
dtype and cs f32, zero initial state, ``reverse`` processing t = T-1 .. 0
with outputs in natural time order. CPU tensors take the plain versions;
CUDA tensors launch the kernel or raise. ``k7a_plan`` and ``k7b_plan``
are the launch code's layouts in integers (the ``*_plan`` entry points
of the three builds return the same numbers, ``device_plan``); a shape
that no layout holds is refused with the rule it breaks before any
device work.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops.k1_plan import (BT, NARROW_MAX_H, SLICE,
                                         SMEM_LIMIT, WIDE_MAX_H)
from mlvae_tpu_torch.ops.lstm import (_check_fused, f32_fwd_launch,
                                      hbuf_pitch, lstm_fused_fwd_ref,
                                      lstm_layer_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

LSTM_UNROLL_FWD = _build.register(_build.Kernel(
    "lstm_unroll_fwd", "lstm_unroll_fwd", "mlvae_lstm_unroll_fwd",
    [_P] * 6 + [_I] * 5 + [_P]))
LSTM_UNROLL_FWD_BF16 = _build.register(_build.Kernel(
    "lstm_unroll_fwd_bf16", "lstm_unroll_fwd_bf16",
    "mlvae_lstm_unroll_fwd_bf16", [_P] * 5 + [_I] * 5 + [_P]))
LSTM_UNROLL_FUSED_FWD = _build.register(_build.Kernel(
    "lstm_unroll_fused_fwd", "lstm_unroll_fused_fwd",
    "mlvae_lstm_unroll_fused_fwd", [_P] * 7 + [_I] * 6 + [_P]))
LSTM_UNROLL_FUSED_FWD_F32 = _build.register(_build.Kernel(
    "lstm_unroll_fused_fwd_f32", "lstm_fused_fwd_f32",
    "mlvae_lstm_unroll_fused_fwd_f32", [_P] * 8 + [_I] * 6 + [_LL, _P]))

GX_BOX_BYTES = 4096   # a staged gates box: 64 rows x a block's gate columns
# K7a f32 (csrc/lstm_unroll_fwd.cu, K1-fwd's narrow build): four units a
# block (H/4 blocks, every one resident: H <= NARROW_MAX_H), W_hh's 16 rows
# and the split-K partials in shared memory, a ring of TMA copies of
# h_{t-1} (H/16 rows x 64 columns) for each of four K slices; the gates of
# the first MAXG tiles staged
MAXG = 4
# K7a bf16 (csrc/lstm_unroll_fwd_bf16.cu, lstm_wide_mma.cuh): eight units
# a block, h_{t-1} whole in SLICE-column slices of 16 KB, H up to
# WIDE_MAX_H. K7b (csrc/lstm_unroll_fused_fwd.cu, K3/K4-fwd's layout): 16
# gate rows a block, chunk tiles of 64 x 128 bf16, accumulator slots of
# 64 x 16 f32
KCB = 128
TILE_BYTES = BT * KCB * 2
SLOT_BYTES = BT * 16 * 4
MAXT = 4              # batch tiles of the schedule that keeps them all


@dataclass(frozen=True)
class UnrollPlan:
    """One K7 launch's layout, as its ``*_plan`` entry point gives it."""
    build: str        # "lstm_unroll_fwd", "_bf16" or "lstm_unroll_fused_fwd"
    blocks: int       # the cooperative grid
    threads: int      # a block
    smem_bytes: int   # dynamic shared memory a block
    ring: int         # K7a f32: h_{t-1} copies a K slice; bf16: the
                      # tile's K slices; K7b: group H's chunk tiles
    bufs: int         # K7a: gates buffers (groups of K steps); K7b: slots
    tiles: int        # K7a: batch tiles whose gates are staged; K7b: a pass
    serial: bool = False  # K7b's serial schedule (one tile a pass)


def _check_k(T: int, K: int) -> None:
    if K < 1 or T % K:
        raise ValueError(f"T={T} must be a multiple of K={K} >= 1")


def run_fwd_k_ref(gx: torch.Tensor, w_hh: torch.Tensor,
                  reverse: bool = False, K: int = 2):
    """Plain K7a: the recurrence of ``lstm_layer_ref`` (h_{t-1} rounded to
    the weights' dtype before the product, f32 sums and cell), which K does
    not change -> (hs (T, B, H) in gx's dtype, cs (T, B, H) f32)."""
    _check_k(gx.shape[0], K)
    return lstm_layer_ref(gx, w_hh, reverse)


def run_fwd_fused_k_ref(x: torch.Tensor, w_ih: torch.Tensor,
                        bias: torch.Tensor, w_hh: torch.Tensor,
                        reverse: bool = False, K: int = 2):
    """Plain K7b: the recurrence of ``lstm_fused_fwd_ref``, which K does not
    change -> (hs (T, B, H) in x's dtype, cs (T, B, H) f32)."""
    _check_k(x.shape[0], K)
    return lstm_fused_fwd_ref(x, w_ih, bias, w_hh, reverse)


def k7a_f32_smem_bytes(H: int, B: int, K: int, nq: int, nbuf: int) -> int:
    """``smem_bytes`` of ``csrc/lstm_unroll_fwd.cu``: K1-fwd's ring of nq
    copies a K slice, W_hh's 16 rows and the split-K partials, then nbuf
    gates buffers of K steps x the staged tiles, f32; the ring's mbarriers
    and one a gates buffer."""
    st = min(-(-B // BT), MAXG)
    return (4 * (4 * nq * (H // 16) * BT + 16 * H + 4 * BT * 16)
            + nbuf * K * st * GX_BOX_BYTES + 8 * (4 * nq + nbuf))


def k7a_bf16_smem_bytes(H: int, K: int, st: int, nbuf: int) -> int:
    """``smem_bytes`` of ``csrc/lstm_unroll_fwd_bf16.cu``: the h_{t-1} tile
    (H/128 slices of 64 x 128 bf16), nbuf gates buffers of K steps x st
    tiles, an mbarrier a slice and a gates buffer."""
    nk = H // SLICE
    return nk * BT * SLICE * 2 + nbuf * K * st * GX_BOX_BYTES \
        + 8 * (nk + nbuf)


def k7b_smem_bytes(In: int, H: int, nt: int, nhb: int, nslot: int,
                   ahead: bool) -> int:
    """``fwd_smem_bytes`` of ``csrc/lstm_unroll_fused_fwd.cu``: the chunk
    tiles (group H's nhb, and group X's two when ``ahead``), the slots
    (ahead: nslot of nt tiles and nt of pre-activations; serial: one tile),
    the bf16 weights at pitch In + H + 8, the chunk tiles' mbarriers and a
    full and an empty one a slot."""
    acc = ((nslot + 1) * nt if ahead else 1) * SLOT_BYTES
    return ((nhb + (2 if ahead else 0)) * TILE_BYTES + acc
            + 2 * 16 * (In + H + 8) + 8 * (2 + nhb + 2 * nslot))


def _refuse(name: str, rule: str) -> None:
    raise ValueError(f"{name}: {rule}")


@lru_cache(maxsize=None)
def k7a_plan(H: int, B: int, K: int, bf16: bool = False) -> UnrollPlan:
    """K7a's layout for a (T, B, 4H) layer unrolled K steps at a time, f32
    or ``bf16`` streams. f32: K1-fwd's deepest ring that fits beside the
    staged gates of the first four batch tiles, then two gates buffers
    where they fit. bf16: the most batch tiles whose gates fit, then two
    buffers. Refuses (``ValueError``, naming the rule) an H the build does
    not take and a shape that no layout fits in 227 KB."""
    if K < 1 or B < 1:
        _refuse("run_fwd_k", f"K={K} and B={B} must be positive")
    ntiles = -(-B // BT)
    if bf16:
        if H < SLICE or H % SLICE or H > WIDE_MAX_H:
            _refuse("run_fwd_k", f"K7a on bf16 streams takes H % "
                    f"{SLICE} == 0 up to {WIDE_MAX_H}, the JAX "
                    "dispatch's rule for its Pallas kernels (mlvae_tpu/nn/"
                    f"rnn.py:100-102); H={H}")
        for st in range(ntiles, 0, -1):
            for nbuf in (2, 1):
                smem = k7a_bf16_smem_bytes(H, K, st, nbuf)
                if smem <= SMEM_LIMIT:
                    return UnrollPlan("lstm_unroll_fwd_bf16", H // 8, 256,
                                      smem, H // SLICE, nbuf, st)
    else:
        if H < 16 or H % 16 or H > NARROW_MAX_H:
            _refuse("run_fwd_k", f"K7a on f32 streams takes H a multiple of "
                    f"16 up to {NARROW_MAX_H} (H/4 blocks, every one resident "
                    f"on its own SM of an H100's 132); H={H}")
        for nq in range(4 * ntiles, 0, -1):
            for nbuf in (2, 1):
                smem = k7a_f32_smem_bytes(H, B, K, nq, nbuf)
                if smem <= SMEM_LIMIT:
                    return UnrollPlan("lstm_unroll_fwd", H // 4, 256, smem,
                                      nq, nbuf, min(ntiles, MAXG))
    _refuse("run_fwd_k", f"no layout of K7a holds one group of K={K} steps' "
            f"gates at H={H}, B={B} within {SMEM_LIMIT} bytes of shared "
            "memory")


@lru_cache(maxsize=None)
def k7b_plan(In: int, H: int, B: int, K: int) -> UnrollPlan:
    """K7b's layout on bf16 streams: every batch tile in one pass with K
    slots and as many of h_{t-1}'s chunk tiles as fit (at least one a
    tile) where B <= 256, else K3/K4-fwd's serial schedule (one tile a
    pass, one slot, two shared chunk tiles). Refuses (``ValueError``) a
    shape whose serial layout passes 227 KB and, as K3/K4-fwd, an In that
    is not a multiple of 8 or an H not a multiple of 16 up to 528."""
    if In < 8 or In % 8 or H < 16 or H % 16 or H > NARROW_MAX_H or K < 1 \
            or B < 1:
        _refuse("run_fwd_fused_k", f"K7b takes In a multiple of 8, H of 16 "
                f"up to {NARROW_MAX_H} (H/4 blocks resident at once) and K, B "
                f"positive; In={In}, H={H}, K={K}, B={B}")
    ntiles = -(-B // BT)
    nh = -(-H // KCB)
    if ntiles <= MAXT:
        for nhb in range(ntiles * nh, ntiles - 1, -1):
            smem = k7b_smem_bytes(In, H, ntiles, nhb, K, True)
            if smem <= SMEM_LIMIT:
                return UnrollPlan("lstm_unroll_fused_fwd", H // 4, 256, smem,
                                  nhb, K, ntiles)
    smem = k7b_smem_bytes(In, H, 1, 2, 1, False)
    if smem <= SMEM_LIMIT:
        return UnrollPlan("lstm_unroll_fused_fwd", H // 4, 256, smem, 2, 1, 1,
                          serial=True)
    _refuse("run_fwd_fused_k", f"no layout of K7b fits In={In}, H={H} "
            f"within {SMEM_LIMIT} bytes of shared memory")


def device_plan(build: str, H: int, B: int, K: int,
                In: int = 0) -> dict:
    """What the launch code of ``build`` ("lstm_unroll_fwd",
    "lstm_unroll_fwd_bf16", "lstm_unroll_fused_fwd") computes for (In,) H,
    B, K (its ``*_plan`` entry point): the fields of ``UnrollPlan`` and
    the registers and local memory bytes a thread. Builds the library;
    needs the card. Not a launch: it counts nowhere."""
    kernel = {k.source: k for k in (LSTM_UNROLL_FWD, LSTM_UNROLL_FWD_BF16,
                                    LSTM_UNROLL_FUSED_FWD)}[build]
    fn = getattr(_build.library(kernel.source), f"{kernel.symbol}_plan")
    args = (In, H, B, K) if build == "lstm_unroll_fused_fwd" else (H, B, K)
    fn.argtypes = [_I] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 9)()
    code = fn(*args, out)
    if code:
        raise RuntimeError(f"{build} plan: CUDA error {code}")
    keys = ("blocks", "threads", "smem_bytes", "ring", "bufs", "tiles",
            "serial", "registers", "local_bytes")
    return dict(zip(keys, list(out)))


def check_fwd_k(gx: torch.Tensor, w_hh: torch.Tensor, K: int) -> UnrollPlan:
    """K7a's inputs: gx and w_hh both f32 or both bf16, contiguous, (T, B,
    4H) and (4H, H) with T a multiple of K, a shape whose build and layout
    exist (``k7a_plan``; refused before any device work), then one CUDA
    device and gx on 16 bytes (the TMA reads it). Returns the plan."""
    _check_k(gx.shape[0], K)
    if gx.dtype not in (torch.float32, torch.bfloat16) \
            or w_hh.dtype != gx.dtype:
        raise ValueError(f"run_fwd_k: gx and w_hh must be both f32 or both "
                         f"bf16 (got {gx.dtype}, {w_hh.dtype})")
    if gx.dim() != 3 or gx.shape[2] % 4 or w_hh.shape != (gx.shape[2],
                                                         gx.shape[2] // 4):
        raise ValueError(f"run_fwd_k: gx {tuple(gx.shape)} and w_hh "
                         f"{tuple(w_hh.shape)} are not (T, B, 4H), (4H, H)")
    plan = k7a_plan(gx.shape[2] // 4, max(gx.shape[1], 1), K,
                    bf16=gx.dtype == torch.bfloat16)
    dev = gx.device
    if dev.type != "cuda" or w_hh.device != dev:
        raise ValueError(f"run_fwd_k: tensors on {gx.device} and "
                         f"{w_hh.device}; both must be on one CUDA device")
    if not (gx.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("run_fwd_k: every tensor must be contiguous")
    if gx.data_ptr() % 16:
        raise ValueError("run_fwd_k: gx must start on 16 bytes")
    return plan


def run_fwd_k(gx: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
              K: int = 2):
    """K7a: same contract as ``run_fwd_k_ref``. CPU tensors take the plain
    version; CUDA tensors launch the build of the stream dtype or raise.
    f32 streams take H a multiple of 16 up to 528 (H/4 blocks resident at
    once on an H100's 132 SMs), bf16 streams H a multiple of 128 up to
    1024; every other H, and a (K, B, H) that no layout fits, is refused
    (``k7a_plan``)."""
    if gx.device.type == "cpu":
        return run_fwd_k_ref(gx, w_hh, reverse, K)
    plan = check_fwd_k(gx, w_hh, K)
    T, B, G = gx.shape
    H = G // 4
    hs = torch.empty((T, B, H), device=gx.device, dtype=gx.dtype)
    cs = torch.empty((T, B, H), device=gx.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
    if not (T and B):
        return hs, cs
    stream = _build.stream_handle(gx.device)
    if plan.build == "lstm_unroll_fwd_bf16":
        # h_{t-1} comes from hs itself (TMA, 16-byte base)
        LSTM_UNROLL_FWD_BF16(gx.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                             cs.data_ptr(), barrier.data_ptr(), T, B, H, K,
                             int(reverse), stream)
        return hs, cs
    # h ping-pong buffer (h_0 = 0; rows padded to 16 bytes for the TMA)
    hbuf = torch.zeros((2, H, hbuf_pitch(B)), device=gx.device,
                       dtype=torch.float32)
    LSTM_UNROLL_FWD(gx.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                    cs.data_ptr(), hbuf.data_ptr(), barrier.data_ptr(), T, B,
                    H, K, int(reverse), stream)
    return hs, cs


def check_fwd_fused_k(x, w_ih, bias, w_hh, K: int):
    """K7b's inputs: T a multiple of K, then K3/K4-fwd's checks
    (``ops.lstm._check_fused``) and, on bf16 streams, a layout
    (``k7b_plan``). Returns the stream dtype."""
    _check_k(x.shape[0], K)
    dtype = _check_fused("run_fwd_fused_k", x, w_ih, bias, w_hh)
    if dtype == torch.bfloat16:
        k7b_plan(x.shape[2], w_hh.shape[1], max(x.shape[1], 1), K)
    return dtype


def run_fwd_fused_k(x: torch.Tensor, w_ih: torch.Tensor, bias: torch.Tensor,
                    w_hh: torch.Tensor, reverse: bool = False, K: int = 2):
    """K7b: same contract as ``run_fwd_fused_k_ref``. CPU tensors take the
    plain version; CUDA tensors launch the build of the stream dtype or
    raise. As K3/K4-fwd, the H/4 blocks must all be resident at once
    (H <= 528 on an H100); on bf16 streams a shape that no layout fits is
    refused (``k7b_plan``)."""
    if x.device.type == "cpu":
        return run_fwd_fused_k_ref(x, w_ih, bias, w_hh, reverse, K)
    dtype = check_fwd_fused_k(x, w_ih, bias, w_hh, K)
    if dtype == torch.float32:
        return f32_fwd_launch(LSTM_UNROLL_FUSED_FWD_F32, (x, w_ih, bias, w_hh),
                              reverse, K)
    T, B, In = x.shape
    H = w_hh.shape[1]
    hs = torch.empty((T, B, H), device=x.device, dtype=dtype)
    cs = torch.empty((T, B, H), device=x.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=x.device, dtype=torch.int32)
    if not (T and B):
        return hs, cs
    LSTM_UNROLL_FUSED_FWD(x.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
                          w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                          barrier.data_ptr(), T, B, In, H, K, int(reverse),
                          _build.stream_handle(x.device))
    return hs, cs
