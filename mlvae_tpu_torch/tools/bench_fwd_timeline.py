"""A step timeline of the recurrent forwards (K1-fwd, K3/K4-fwd, the wide
K1-fwd in f32 and on bf16 streams, K5-fwd in f32 and on bf16 streams, the
K-unrolled K7a in f32 and on bf16 streams and K7b beside their one-step
twins, and K3/K4-fwd and K7b on f32 streams) on the card.

    python -m mlvae_tpu_torch.tools.bench_fwd_timeline [--iters N]

Builds ``csrc/lstm_fwd.cu``, ``csrc/lstm_fused_fwd.cu``,
``csrc/lstm_fwd_wide_bf16.cu``, ``csrc/gru_fwd_bf16.cu``,
``csrc/gru_fwd.cu``, ``csrc/lstm_fwd_wide.cu``, ``csrc/lstm_unroll_fwd.cu``,
``csrc/lstm_unroll_fwd_bf16.cu`` and ``csrc/lstm_unroll_fused_fwd.cu`` a
second time with ``-DMLVAE_FWD_TIMELINE``
(their own library names, see ``_build.VARIANTS``): a lead thread of each
block reads ``%globaltimer`` at the phase boundaries of its chain of work
and writes, for each step, the step's start and end and each phase's sum
over the step's batch tiles into a (T, blocks, 8) buffer
(``csrc/fwd_timeline.cuh``). For K1-fwd at B=64 and 128 (f32) and
K3/K4-fwd at In=128, 512 and 1024 and B=64 and 256 (bf16), H=512, the
wide K1-fwd on bf16 streams and in f32 at H=1024, B=64 (LSTM_FC's AMP
and f32 shapes), and
K5-fwd on bf16 streams and in f32 at H=512, B=64 (gate 3's AMP and f32
shapes), and at the unroll A/B's shape (B=128, H=512, In=512) K7a in f32
beside K1-fwd, K7a on bf16 streams beside the bf16 K1-fwd and K7b beside
K3/K4-fwd, each K7 build at K 2, 4 and 8 and held bit-equal to its twin,
and on f32 streams (``csrc/lstm_fused_fwd_f32.cu``, its two entries in one
timing build) K3/K4-fwd at In=128 and 512, B=64, and K7b at B=128, K=2
beside K3/K4-fwd f32 there, T=160,
inputs from a generator seeded 0 at the recipe layers' scales, it
prints each phase's microseconds a step: each block's mean over the steps,
then the min, median and max over the blocks. The phases, on the chain of
thread 0: ``input`` (the x_t product where it lies on the chain), ``stage``
(waiting for h_{t-1} in shared memory), ``product`` (the recurrent
product), ``cell`` (the cell update and its stores), ``barrier`` (arrival
to the end of the wait); ``offchain`` is the input product formed off the
chain by other warps (0 where the design has none), and ``step`` runs from
the step's start to the end of its wait. The f32 rows name the same slots
after that design's phases (``F32_PHASES``): ``slot_wait`` (the recurrence
waiting for its item's input products), ``stage``, ``product``, ``cell``,
``barrier``, and ``producer`` (warps 8-15 forming the input products of a
step's items, its waits for a free slot left out).

It also times both builds (CUDA events after warm-up: what the stamps
cost) and holds the timing build's outputs bit-equal to the normal
build's (and each K7 build's to its twin's). It prints one JSON line
naming the card and its power limit, and exits non-zero when an output
differs. It needs the card and raises
without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from typing import Dict, Optional, Sequence

import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.ops import gru as G
from mlvae_tpu_torch.ops import lstm as L
from mlvae_tpu_torch.ops.k1_plan import (k1_fwd_plan,  # noqa: F401
                                         narrow_fwd_ring_depth,
                                         narrow_fwd_smem_bytes)

SLOTS = 8
# each phase's slot of the timing build's eight: 0 the step's start, 1 its
# end, 2-7 the sums below (ns)
PHASES = {"input": 2, "stage": 3, "product": 4, "cell": 5, "barrier": 6,
          "offchain": 7}
# the same slots as the f32 K3/K4-fwd and K7b name them
F32_PHASES = {"slot_wait": 2, "stage": 3, "product": 4, "cell": 5,
              "barrier": 6, "producer": 7}
# (In, B) of the f32 K3/K4-fwd rows: MD_VAE's K3 and K4 layers; the f32
# K7b row at the unroll A/B's shape
F32_CASES = ((128, 64), (512, 64))
F32_UNROLL_K = 2
# (kernel, In, B); In None for K1-fwd
CASES = (("lstm_fwd", None, 64), ("lstm_fwd", None, 128),
         *(("lstm_fused_fwd", In, B) for In in (128, 512, 1024)
           for B in (64, 256)), ("lstm_fwd_wide_bf16", None, 64),
         ("lstm_fwd_wide", None, 64))
T, H = 160, 512
WIDE_H = 1024         # the wide K1-fwd's shape: LSTM_FC's layers
WARMUP = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGS = {"lstm_fwd": [_P] * 6 + [_I] * 4 + [_P, _P],
         "lstm_fused_fwd": [_P] * 7 + [_I] * 5 + [_P, _P],
         "lstm_fwd_wide_bf16": [_P] * 5 + [_I] * 4 + [_P, _P],
         "gru_fwd_bf16": [_P] * 6 + [_I] * 4 + [_P, _P],
         "gru_fwd": [_P] * 5 + [_I] * 4 + [_P, _P],
         "lstm_fwd_wide": [_P] * 6 + [_I] * 4 + [_P, _P],
         "lstm_unroll_fwd": [_P] * 6 + [_I] * 5 + [_P, _P],
         "lstm_unroll_fwd_bf16": [_P] * 5 + [_I] * 5 + [_P, _P],
         "lstm_unroll_fused_fwd": [_P] * 7 + [_I] * 6 + [_P, _P],
         "lstm_fused_fwd_f32": [_P] * 8 + [_I] * 5 + [_LL, _P, _P]}
GRU_H = 512           # K5-fwd's shape: gate 3's layers
GRU_BATCHES = (64,)
UNROLL_B, UNROLL_IN = 128, 512  # the unroll A/B's shape (H = 512)
UNROLL_KS = (2, 4, 8)
# each K7 build's one-step twin
UNROLL_TWINS = {"lstm_unroll_fwd": "lstm_fwd",
                "lstm_unroll_fwd_bf16": "lstm_fwd_wide_bf16",
                "lstm_unroll_fused_fwd": "lstm_fused_fwd"}

# Not registered: their launches count on no path.
TIMED = {name: _build.Kernel(f"{name}_timeline", f"{name}_timeline",
                             f"mlvae_{name}_timeline", _ARGS[name])
         for name in _ARGS}
# the f32 K7b: the K entry of the f32 K3/K4-fwd's timing build
TIMED["lstm_unroll_fused_fwd_f32"] = _build.Kernel(
    "lstm_unroll_fused_fwd_f32_timeline", "lstm_fused_fwd_f32_timeline",
    "mlvae_lstm_unroll_fused_fwd_f32_timeline",
    [_P] * 8 + [_I] * 6 + [_LL, _P, _P])


SMEM_LIMIT = 232448   # an H100 block's shared memory
BT, ROWS, KCB, TILE_BYTES = 64, 16, 128, 64 * 128 * 2
MAXT = 4              # K3/K4-fwd's batch tiles kept in one pass


def fused_fwd_smem_bytes(In: int, H: int, nt: int, nhb: int,
                         ahead: bool) -> int:
    """Shared memory of a K3/K4-fwd launch (``fwd_smem_bytes`` of
    ``csrc/lstm_fused_fwd.cu``): the chunk tiles (group H's nhb, and group
    X's two when ``ahead``), the accumulator slots and pre-activations
    (ahead: 3 nt tiles of 64 x 16 f32; serial: one), the bf16 weights at
    pitch In + H + 8 and the mbarriers."""
    acc = (3 * nt if ahead else 1) * BT * ROWS * 4
    return ((nhb + (2 if ahead else 0)) * TILE_BYTES + acc
            + 2 * ROWS * (In + H + 8) + 8 * (2 + nhb))


def fused_fwd_schedule(In: int, H: int, B: int):
    """(ahead, nhb) of a K3/K4-fwd launch (``fwd_schedule``): every batch
    tile in one pass with as many of h_{t-1}'s chunk tiles as fit (at least
    one a tile) when B <= 256, else the serial schedule with two shared
    tiles; None when even that passes 227 KB."""
    ntiles = -(-B // BT)
    nh = -(-H // KCB)
    if ntiles <= MAXT:
        for n in range(ntiles * nh, ntiles - 1, -1):
            if fused_fwd_smem_bytes(In, H, ntiles, n, True) <= SMEM_LIMIT:
                return True, n
    if fused_fwd_smem_bytes(In, H, 1, 2, False) <= SMEM_LIMIT:
        return False, 2
    return None


def k1_smem_bytes(H: int, nq: int) -> int:
    """Shared memory of a narrow K1-fwd launch (``smem_bytes`` of
    ``csrc/lstm_fwd.cu``; ``ops.k1_plan.narrow_fwd_smem_bytes``): a ring of
    nq copies of H/16 x 64 f32 for each of the four K slices, W_hh's 16
    rows, the split-K partials and the ring's mbarriers."""
    return narrow_fwd_smem_bytes(H, nq)


def k1_ring_depth(H: int, B: int) -> int:
    """Narrow K1-fwd's ring depth a slice (``ring_depth``): every copy of a
    step (4 a batch tile) where they fit, else the most that fit. The whole
    plan, wide builds included, is ``k1_fwd_plan``."""
    return narrow_fwd_ring_depth(H, B)


def k1_tensor_map(B: int, H: int):
    """K1-fwd's tensor map over the (2, H, Bp) f32 h buffer: (dims, byte
    strides of dims 1 and 2, box), innermost first. The TMA needs each
    stride a multiple of 16 bytes, hence the padded pitch."""
    Bp = L.hbuf_pitch(B)
    return (B, H, 2), (4 * Bp, 4 * Bp * H), (BT, H // 16, 1)


def fused_chunk_map(cols: int, rows: int, slices: int):
    """The fused kernels' chunk descriptors (``chunk_map`` of
    ``csrc/lstm_fused_tma.cuh``) over a dense bf16 (slices, rows, cols)
    tensor: (dims, byte strides, box of one 64-column half)."""
    return (cols, rows, slices), (2 * cols, 2 * cols * rows), (64, BT, 1)


def phase_split(tl: torch.Tensor, phases: Dict[str, int] = PHASES
                ) -> Dict[str, Dict[str, float]]:
    """``tl`` (T, blocks, slots) int64 ns, slot 0 each step's start, 1 its
    end and ``phases`` the slots of the phases' sums (this tool's
    ``PHASES``, or K1-bwd's of ``bench_bwd_timeline``) -> each phase's
    microseconds a step and ``step``, end less start: every block's mean
    over the steps, then min, median and max over the blocks."""
    st = tl.to(torch.float64)
    cols = {name: st[..., k] for name, k in phases.items()}
    cols["step"] = st[..., 1] - st[..., 0]
    out = {}
    for name, v in cols.items():
        m = v.mean(dim=0) / 1e3                     # (blocks,) us a step
        out[name] = {"min": float(m.min()), "median": float(m.median()),
                     "max": float(m.max())}
    return out


def make_problem(dev, name: str, In: Optional[int], B: int, seed: int = 0):
    """K1-fwd: gx N(0, 0.5^2) and W_hh U(+-1/sqrt(H)), f32 (the wide
    builds: at H=1024, f32 or bf16). K3/K4-fwd: x N(0, 0.5^2), W_ih, W_hh U(+-1/sqrt(H))
    bf16 and the bias f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if name in ("lstm_fwd", "lstm_fwd_wide_bf16", "lstm_fwd_wide"):
        Hn = H if name == "lstm_fwd" else WIDE_H
        gx = torch.randn((T, B, 4 * Hn), generator=g, device=dev) * 0.5
        w = (torch.rand((4 * Hn, Hn), generator=g, device=dev) * 2 - 1) \
            / Hn ** 0.5
        if name != "lstm_fwd_wide_bf16":
            return gx, w
        return gx.to(torch.bfloat16), w.to(torch.bfloat16)
    bf = torch.bfloat16
    x = (torch.randn((T, B, In), generator=g, device=dev) * 0.5).to(bf)
    w_ih = ((torch.rand((4 * H, In), generator=g, device=dev) * 2 - 1)
            / H ** 0.5).to(bf)
    bias = (torch.rand((4 * H,), generator=g, device=dev) * 2 - 1) / H ** 0.5
    w_hh = ((torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1)
            / H ** 0.5).to(bf)
    return x, w_ih, bias, w_hh


def normal(name: str, prob, reverse: bool = False):
    return (L.lstm_fused_fwd(*prob, reverse) if name == "lstm_fused_fwd"
            else L.lstm_layer_fwd(*prob, reverse))


def timed_fwd(name: str, prob, reverse: bool = False):
    """The timing build of ``name`` on ``prob``: ((hs, cs), as the normal
    wrapper's, and the (T, blocks, 8) int64 timeline: H/4 blocks, H/8 for
    the wide builds)."""
    kernel = TIMED[name]
    head = prob[0]
    Tn, B = head.shape[:2]
    Hn = prob[-1].shape[1]
    dev = head.device
    stream = _build.stream_handle(dev)
    units = 8 if name in ("lstm_fwd_wide_bf16", "lstm_fwd_wide") else 4
    tl = torch.zeros((Tn, Hn // units, SLOTS), device=dev, dtype=torch.int64)
    cs = torch.empty((Tn, B, Hn), device=dev, dtype=torch.float32)
    hs = torch.empty((Tn, B, Hn), device=dev, dtype=head.dtype)
    barrier = torch.zeros((1,), device=dev, dtype=torch.int32)
    if name in ("lstm_fwd", "lstm_fwd_wide"):
        gx, w = prob
        hbuf = torch.zeros((2, Hn, L.hbuf_pitch(B)), device=dev,
                           dtype=torch.float32)
        kernel(gx.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
               hbuf.data_ptr(), barrier.data_ptr(), Tn, B, Hn, int(reverse),
               tl.data_ptr(), stream)
    elif name == "lstm_fwd_wide_bf16":
        gx, w = prob
        kernel(gx.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
               barrier.data_ptr(), Tn, B, Hn, int(reverse), tl.data_ptr(),
               stream)
    else:
        x, w_ih, bias, w_hh = prob
        kernel(x.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
               w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
               barrier.data_ptr(), Tn, B, x.shape[2], Hn, int(reverse),
               tl.data_ptr(), stream)
    return (hs, cs), tl


def cuda_ms(fn, iters: int) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def gru_problem(dev, B: int, seed: int = 0, bf16: bool = True):
    """A K5-fwd input at T, H=512: gx N(0, 0.5^2), W_hh and b_hh
    U(+-1/sqrt(H)) (gx and W_hh bf16, or f32 with ``bf16`` false; b_hh
    f32)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    gx = (torch.randn((T, B, 3 * GRU_H), generator=g, device=dev)
          * 0.5).to(dt)
    w = ((torch.rand((3 * GRU_H, GRU_H), generator=g, device=dev) * 2 - 1)
         / GRU_H ** 0.5).to(dt)
    b = (torch.rand((3 * GRU_H,), generator=g, device=dev) * 2 - 1) \
        / GRU_H ** 0.5
    return gx, w, b


def timed_gru(prob, reverse: bool = False):
    """K5-fwd's timing build of ``prob``'s stream dtype (``gru_fwd_bf16`` or
    ``gru_fwd``) on ``prob``: ((hs, hs32), as ``gru_layer_fwd``'s, and the
    (T, blocks, 8) int64 timeline)."""
    gx, w, b = prob
    Tn, B, G3 = gx.shape
    Hn = G3 // 3
    dev = gx.device
    bf16 = gx.dtype == torch.bfloat16
    tl = torch.zeros((Tn, G.k5_plan("fwd", Hn, bf16).blocks, SLOTS),
                     device=dev, dtype=torch.int64)
    hs = torch.empty((Tn, B, Hn), device=dev, dtype=gx.dtype)
    hs32 = torch.empty((Tn, B, Hn), device=dev,
                       dtype=torch.float32) if bf16 else None
    barrier = torch.zeros((1,), device=dev, dtype=torch.int32)
    stream = _build.stream_handle(dev)
    if bf16:
        TIMED["gru_fwd_bf16"](gx.data_ptr(), w.data_ptr(), b.data_ptr(),
                              hs.data_ptr(), hs32.data_ptr(),
                              barrier.data_ptr(), Tn, B, Hn, int(reverse),
                              tl.data_ptr(), stream)
    else:
        TIMED["gru_fwd"](gx.data_ptr(), w.data_ptr(), b.data_ptr(),
                         hs.data_ptr(), barrier.data_ptr(), Tn, B, Hn,
                         int(reverse), tl.data_ptr(), stream)
    return (hs, hs32), tl


def gru_rows(dev, iters: int):
    """The rows of K5-fwd at gate 3's shape: its bf16 build, then its f32
    build."""
    rows = []
    for bf16 in (True, False):
        for B in GRU_BATCHES:
            prob = gru_problem(dev, B, bf16=bf16)
            want = G.gru_layer_fwd(*prob)
            got, tl = timed_gru(prob)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: G.gru_layer_fwd(*prob), iters)
            rows.append({
                "kernel": "gru_fwd_bf16" if bf16 else "gru_fwd", "In": None,
                "B": B, "T": T, "H": GRU_H,
                "bit_equal_to_normal_build": all(
                    torch.equal(a, c) for a, c in zip(got, want)
                    if c is not None),
                "ms": ms, "us_a_step": ms * 1e3 / T,
                "ms_timing_build": cuda_ms(lambda: timed_gru(prob), iters),
                "phases_us_a_step": phase_split(tl.cpu())})
    return rows


def unroll_problem(dev, name: str, seed: int = 0):
    """A K7 build's input at the unroll A/B's shape, at the recipe layers'
    scales as ``make_problem``: gx and W_hh at H=512 (f32, or bf16 for
    ``lstm_unroll_fwd_bf16``), or K3/K4-fwd's x, W_ih, bias, W_hh at
    In=512."""
    if name == "lstm_unroll_fused_fwd":
        return make_problem(dev, "lstm_fused_fwd", UNROLL_IN, UNROLL_B, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    gx = torch.randn((T, UNROLL_B, 4 * H), generator=g, device=dev) * 0.5
    w = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) / H ** 0.5
    if name == "lstm_unroll_fwd_bf16":
        return gx.to(torch.bfloat16), w.to(torch.bfloat16)
    return gx, w


def unroll_normal(name: str, prob, K: int, reverse: bool = False):
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    if name == "lstm_unroll_fused_fwd":
        return LU.run_fwd_fused_k(*prob, reverse, K)
    return LU.run_fwd_k(*prob, reverse, K)


def timed_unroll(name: str, prob, K: int, reverse: bool = False):
    """The timing build of the K7 build ``name`` on ``prob`` unrolled K
    steps at a time: ((hs, cs), as the normal wrapper's, and the (T,
    blocks, 8) int64 timeline: H/4 blocks, H/8 on bf16 streams for
    K7a)."""
    kernel = TIMED[name]
    head = prob[0]
    Tn, B = head.shape[:2]
    Hn = prob[-1].shape[1]
    dev = head.device
    stream = _build.stream_handle(dev)
    units = 8 if name == "lstm_unroll_fwd_bf16" else 4
    tl = torch.zeros((Tn, Hn // units, SLOTS), device=dev, dtype=torch.int64)
    cs = torch.empty((Tn, B, Hn), device=dev, dtype=torch.float32)
    hs = torch.empty((Tn, B, Hn), device=dev, dtype=head.dtype)
    barrier = torch.zeros((1,), device=dev, dtype=torch.int32)
    if name == "lstm_unroll_fwd":
        gx, w = prob
        hbuf = torch.zeros((2, Hn, L.hbuf_pitch(B)), device=dev,
                           dtype=torch.float32)
        kernel(gx.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
               hbuf.data_ptr(), barrier.data_ptr(), Tn, B, Hn, K,
               int(reverse), tl.data_ptr(), stream)
    elif name == "lstm_unroll_fwd_bf16":
        gx, w = prob
        kernel(gx.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
               barrier.data_ptr(), Tn, B, Hn, K, int(reverse), tl.data_ptr(),
               stream)
    else:
        x, w_ih, bias, w_hh = prob
        kernel(x.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
               w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
               barrier.data_ptr(), Tn, B, x.shape[2], Hn, K, int(reverse),
               tl.data_ptr(), stream)
    return (hs, cs), tl


def unroll_rows(dev, iters: int, Ks=UNROLL_KS):
    """At the unroll A/B's shape: each K7 build's twin (its timing build,
    K 1), then the K7 build at each K, held bit-equal to the twin's normal
    build and to its own normal build."""
    rows = []
    for name, twin in UNROLL_TWINS.items():
        prob = unroll_problem(dev, name)
        In = prob[0].shape[2] if name == "lstm_unroll_fused_fwd" else None
        want = normal(twin, prob)
        got, tl = timed_fwd(twin, prob)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: normal(twin, prob), iters)
        rows.append({
            "kernel": twin, "In": In, "B": UNROLL_B, "T": T, "H": H, "K": 1,
            "bit_equal_to_normal_build": all(
                torch.equal(a, b) for a, b in zip(got, want)),
            "bit_equal_to_twin": True, "ms": ms, "us_a_step": ms * 1e3 / T,
            "ms_timing_build": cuda_ms(lambda: timed_fwd(twin, prob), iters),
            "phases_us_a_step": phase_split(tl.cpu())})
        for K in Ks:
            mine = unroll_normal(name, prob, K)
            got, tl = timed_unroll(name, prob, K)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: unroll_normal(name, prob, K), iters)
            rows.append({
                "kernel": name, "In": In, "B": UNROLL_B, "T": T, "H": H,
                "K": K, "bit_equal_to_normal_build": all(
                    torch.equal(a, b) for a, b in zip(got, mine)),
                "bit_equal_to_twin": all(
                    torch.equal(a, b) for a, b in zip(mine, want)),
                "ms": ms, "us_a_step": ms * 1e3 / T,
                "ms_timing_build": cuda_ms(
                    lambda: timed_unroll(name, prob, K), iters),
                "phases_us_a_step": phase_split(tl.cpu())})
    return rows


def f32_problem(dev, In: int, B: int, seed: int = 0):
    """A K3/K4-fwd input on f32 streams at T, H=512, the scales of
    ``make_problem``: x N(0, 0.5^2), W_ih, W_hh and the bias
    U(+-1/sqrt(H)), all f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, B, In), generator=g, device=dev) * 0.5
    w_ih = (torch.rand((4 * H, In), generator=g, device=dev) * 2 - 1) \
        / H ** 0.5
    bias = (torch.rand((4 * H,), generator=g, device=dev) * 2 - 1) / H ** 0.5
    w_hh = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) \
        / H ** 0.5
    return x, w_ih, bias, w_hh


def timed_f32(prob, K: Optional[int] = None, reverse: bool = False):
    """The f32 timing build on ``prob``: K3/K4-fwd, or K7b with ``K``;
    ((hs, cs), as the normal wrappers', and the (T, H/4, 8) int64
    timeline)."""
    Tn = prob[0].shape[0]
    Hn = prob[3].shape[1]
    tl = torch.zeros((Tn, Hn // 4, SLOTS), device=prob[0].device,
                     dtype=torch.int64)
    name = "lstm_fused_fwd_f32" if K is None else "lstm_unroll_fused_fwd_f32"
    out = L.f32_fwd_launch(TIMED[name], prob, reverse, K, timeline=tl)
    return out, tl


def f32_rows(dev, iters: int):
    """K3/K4-fwd on f32 streams at ``F32_CASES``, then K7b on f32 streams at
    the unroll A/B's shape with K ``F32_UNROLL_K``, held bit-equal to
    K3/K4-fwd f32 there (its twin) and to its own normal build."""
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    rows = []
    for In, B, K in (*((In, B, None) for In, B in F32_CASES),
                     (UNROLL_IN, UNROLL_B, F32_UNROLL_K)):
        prob = f32_problem(dev, In, B)
        twin = L.lstm_fused_fwd(*prob)
        if K is None:
            mine = twin
        else:
            mine = LU.run_fwd_fused_k(*prob, False, K)
        got, tl = timed_f32(prob, K)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: (L.lstm_fused_fwd(*prob) if K is None else
                              LU.run_fwd_fused_k(*prob, False, K)), iters)
        rows.append({
            "kernel": ("lstm_fused_fwd_f32" if K is None
                       else "lstm_unroll_fused_fwd_f32"),
            "In": In, "B": B, "T": T, "H": H, "K": K or 1,
            "bit_equal_to_normal_build": all(
                torch.equal(a, b) for a, b in zip(got, mine)),
            "bit_equal_to_twin": all(
                torch.equal(a, b) for a, b in zip(mine, twin)),
            "ms": ms, "us_a_step": ms * 1e3 / T,
            "ms_timing_build": cuda_ms(lambda: timed_f32(prob, K), iters),
            "phases_us_a_step": phase_split(tl.cpu(), F32_PHASES)})
    return rows


def bench(dev, iters: int = 10, cases=CASES) -> Dict:
    _build.build([*(f"{n}_timeline" for n in _build.FWD_TIMED),
                  *_build.FWD_TIMED])
    rows = []
    for name, In, B in cases:
        prob = make_problem(dev, name, In, B)
        want = normal(name, prob)
        got, tl = timed_fwd(name, prob)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        ms = cuda_ms(lambda: normal(name, prob), iters)
        rows.append({
            "kernel": name, "In": In, "B": B, "T": T,
            "H": prob[-1].shape[1],
            "bit_equal_to_normal_build": equal,
            "ms": ms, "us_a_step": ms * 1e3 / T,
            "ms_timing_build": cuda_ms(lambda: timed_fwd(name, prob), iters),
            "phases_us_a_step": phase_split(tl.cpu())})
    return {"rows": rows + gru_rows(dev, iters) + unroll_rows(dev, iters)
            + f32_rows(dev, iters)}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls per build and shape (default "
                    "%(default)s)")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    res = bench(dev, args.iters)
    print(json.dumps({"tool": "bench_fwd_timeline",
                      "device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": _card(), **res}), flush=True)
    bad = [(r["kernel"], r["In"], r["B"], r.get("K")) for r in res["rows"]
           if not (r["bit_equal_to_normal_build"]
                   and r.get("bit_equal_to_twin", True))]
    if bad:
        print(f"bench_fwd_timeline: a timing build differs from its normal "
              f"build, or a K7 build from its twin, at {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
