"""A step timeline of the LSTM backwards (K3-bwd, K4-bwd, K1-bwd, the wide
K1-bwd in f32 and on bf16 streams) and K5-bwd on the card.

    python -m mlvae_tpu_torch.tools.bench_bwd_timeline [--iters N]

Builds ``csrc/lstm_fused_bwd.cu`` and ``csrc/lstm_semi_bwd.cu`` a second
time with ``-DMLVAE_BWD_TIMELINE`` (their own library names, see
``_build.VARIANTS``): thread 0 of each block writes ``%globaltimer`` at the
phase boundaries of each step into a (T, H/4, 7) buffer. For K3-bwd at
In=512 and K4-bwd at In=1024, H=512, T=160, B=64 and B=256 (the AMP step's
shapes and the JAX bench's batch), inputs from a generator seeded 0 at the
recipe layers' scales, it prints each phase's microseconds a step: each
block's mean over the steps, then the min, median and max over the blocks.
The phases: ``dgates`` (from the carries, then the barrier's arrival);
then at once on warps 4-7 ``dW`` and ``recompute`` (the next step's
pre-activations) and on warps 0-3 ``wait`` (the rest of the barrier) and
``exchange`` (dX and dh_{t-1}); ``warps_0_3`` and ``warps_4_7`` are the
two groups' spans after the arrival, and ``step`` runs from the step's
start to the groups' join. A launch that keeps its tiles in the serial
schedule (``ahead`` false) reports dgates, dW and recompute together
under ``dgates``.

It also times both builds (CUDA events after warm-up: what the stamps
cost) and holds the timing build's outputs bit-equal to the normal
build's. The ablation reruns each shape with only the first 0 or 32 of
each staged chunk's 64 rows read from L2 (``-DMLVAE_BWD_STAGE_ROWS``; wrong
outputs by design): what the copies' traffic costs a step.

K1-bwd (``csrc/lstm_bwd.cu``, f32) has a timing build of its own
(``-DMLVAE_K1_BWD_TIMELINE``): thread 0 of each block sums the intervals
of its phases, a (T, H/4, 10) buffer, at T=160, H=512, B=64 on the
trajectory of K1-fwd. Its phases, microseconds a step as above:
``stage`` (waiting for the copies of h_{t-1}), ``recompute``, ``cell``,
``partial_dw`` (one pass forming the split-K share of dh_{t-1} and dW),
``wait`` (in the grid barrier), ``reduce``, ``barrier`` (from the arrival
to the end of the wait, with whatever runs between), ``loads`` (the next
step's cell inputs) and ``step``.

The wide K1-bwd on bf16 streams (``csrc/lstm_bwd_wide_bf16.cu``) has a
timing build of its recurrence with the same define and layout, a (T,
H/8, 10) buffer, at T=160, H=1024, B=64 (LSTM_FC's AMP shape) on the
trajectory of the bf16 K1-fwd. Its phases (``WIDE_PHASES``): ``stage``
(waiting for thread 0's slice of h_{t-1}), ``recompute`` (its slice's
product and the gather of the slices' sums), ``cell`` (the dgates, their
stores and the arrival), ``dh_stage`` (waiting for warp 0's chunks of the
dgates), ``wait``, ``dh_product`` (warp 0's chunk products and the
gather of the warps' dh sums), ``barrier``, ``loads`` and ``step``.
Its normal build's ms include the dW_hh kernel that follows the
recurrence; the timing build's do not.

K5-bwd on bf16 streams (``csrc/gru_bwd_bf16.cu``) has a timing build of
its recurrence with the same define, slots and phases (``WIDE_PHASES``;
``dh_stage`` and ``dh_product`` are its exchange of bf16(dgh)), a (T,
blocks, 10) buffer, at T=160, H=512, B=64 (gate 3's AMP shape) on the
trajectory of the bf16 K5-fwd; its dgx and db_hh must be bit-equal to the
normal build's. K5-bwd in f32 (``csrc/gru_bwd.cu``) has one with the same
define and K1-bwd's slots and phases (``K1_PHASES``; ``loads`` also holds
thread 0's issue of the next step's copies), at the same shape in f32 on
the trajectory of the f32 K5-fwd; its dgx, dW_hh and db_hh must be
bit-equal to the normal build's.

The wide K1-bwd in f32 (``csrc/lstm_bwd_wide.cu``) has one of its
recurrence too, with K1-bwd's define, slots and phases (``K1_PHASES``;
``partial_dw`` is the pass forming the partials), a (T, H/8, 10) buffer,
at T=160, H=1024, B=64 (LSTM_FC's f32 shape) on the trajectory of the f32
wide K1-fwd; its dgx must be bit-equal to the normal build's. Its normal
build's ms include the dW_hh kernel that follows the recurrence.

K3-bwd and K4-bwd on f32 streams (``csrc/lstm_fused_bwd_f32.cu``) have one
timing build of both entries with ``-DMLVAE_BWD_TIMELINE``, K1-bwd's
clock, slots and phases (``K1_PHASES``), a (T, H/4, 10) buffer: K3 at
In=128 and K4 at In=512 (MD_VAE's f32 layers under
``MLVAE_PALLAS_FUSED=1``), which take the split-K schedule (``split``,
one tile of 64 rows a barrier), and K3 at In=256 (the widest K3 layer
the f32 budget admits at H=512), which takes the exchange schedule
(``exchange``); H=512, T=160, B=64 and 256, inputs at the recipe layers'
scales in f32 and the trajectory from K3/K4-fwd f32. Each row runs the
schedule the C code's plan chooses (``ops.lstm.fused_f32_launch_plan``).
In the exchange schedule ``partial_dw`` is its dW, ``reduce`` its
exchange and ``recompute`` holds its copies (``stage`` 0); ``cell`` holds
the arrival. Each row's outputs must be bit-equal to the normal build's.

It prints one JSON line naming the card and its power limit, and exits
non-zero when an output differs. It needs the card and raises without
CUDA.
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
from mlvae_tpu_torch.ops.k1_plan import k1_bwd_plan, narrow_bwd_smem_bytes
from mlvae_tpu_torch.tools import bench_fwd_timeline as ftl

# each phase as (start stamp, end stamp) of the timing build's seven: 0 the
# step's start, 1 dgates done and arrived, 2 dW done, 3 the next step's
# pre-activations done (warps 4-7), 4 the wait done, 5 the exchange done
# (warps 0-3), 6 the two groups joined
PHASES = {"dgates": (0, 1), "dW": (1, 2), "recompute": (2, 3),
          "wait": (1, 4), "exchange": (4, 5), "warps_0_3": (1, 5),
          "warps_4_7": (1, 3), "step": (0, 6)}
STAMPS = 7
CASES = (("lstm_fused_bwd", 512), ("lstm_semi_bwd", 1024))
BATCHES = (64, 256)
T, H = 160, 512
WARMUP = 2

# K1-bwd's timeline: slot of each phase's sum (0 the step's start, 1 its
# end), as ``csrc/lstm_bwd.cu`` writes them
K1_SLOTS = 10
K1_PHASES = {"stage": 2, "recompute": 3, "cell": 4, "partial_dw": 5,
             "wait": 6, "reduce": 7, "barrier": 8, "loads": 9}
K1_BATCHES = (64,)
# the wide K1-bwd on bf16 streams: the same slots, its own phases
WIDE_PHASES = {"stage": 2, "recompute": 3, "cell": 4, "dh_stage": 5,
               "wait": 6, "dh_product": 7, "barrier": 8, "loads": 9}
WIDE_H = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = {"lstm_fused_bwd": [_P] * 15 + [_I] * 5 + [_P, _P],
         "lstm_semi_bwd": [_P] * 12 + [_I] * 5 + [_P, _P]}
_K1_ARGS = [_P] * 11 + [_I] * 4 + [_P, _P]
_WIDE_ARGS = [_P] * 9 + [_I] * 4 + [_P, _P]
_GRU_ARGS = [_P] * 11 + [_I] * 4 + [_P, _P]
_GRU_F32_ARGS = [_P] * 11 + [_I] * 4 + [_P, _P]
_WIDE_F32_ARGS = [_P] * 10 + [_I] * 4 + [_P, _P]


def _timed(name: str, rows: Optional[int] = None) -> _build.Kernel:
    """The timing build of ``name`` (with the staged-rows ablation if
    ``rows`` is given); its entry takes the timeline before the stream."""
    src = f"{name}_timeline" + ("" if rows is None else f"_rows{rows}")
    return _build.Kernel(src, src, f"mlvae_{name}_timeline", _ARGS[name])


# Not registered: their launches count on no path.
TIMED = {name: _timed(name) for name in _ARGS}
TIMED["lstm_bwd"] = _build.Kernel("lstm_bwd_timeline", "lstm_bwd_timeline",
                                  "mlvae_lstm_bwd_timeline", _K1_ARGS)
TIMED["lstm_bwd_wide_bf16"] = _build.Kernel(
    "lstm_bwd_wide_bf16_timeline", "lstm_bwd_wide_bf16_timeline",
    "mlvae_lstm_bwd_wide_bf16_timeline", _WIDE_ARGS)
TIMED["gru_bwd_bf16"] = _build.Kernel(
    "gru_bwd_bf16_timeline", "gru_bwd_bf16_timeline",
    "mlvae_gru_bwd_bf16_timeline", _GRU_ARGS)
TIMED["gru_bwd"] = _build.Kernel("gru_bwd_timeline", "gru_bwd_timeline",
                                 "mlvae_gru_bwd_timeline", _GRU_F32_ARGS)
TIMED["lstm_bwd_wide"] = _build.Kernel(
    "lstm_bwd_wide_timeline", "lstm_bwd_wide_timeline",
    "mlvae_lstm_bwd_wide_timeline", _WIDE_F32_ARGS)
ABLATED = {(name, r): _timed(name, r) for name in _ARGS
           for r in _build.ABLATION_ROWS}
# the f32 K3-bwd and K4-bwd: one timing build, both entries
F32_TIMED_SRC = "lstm_fused_bwd_f32_timeline"
TIMED.update({name: _build.Kernel(
    F32_TIMED_SRC, F32_TIMED_SRC, f"mlvae_{name}_timeline",
    [*kern.argtypes[:-1], _P, _P])
    for name, kern in (("lstm_fused_bwd_f32", L.LSTM_FUSED_BWD_F32),
                       ("lstm_semi_bwd_f32", L.LSTM_SEMI_BWD_F32))})
F32_CASES = (("lstm_fused_bwd_f32", 128), ("lstm_semi_bwd_f32", 512),
             ("lstm_fused_bwd_f32", 256))
F32_SCHEDULE_NAMES = {L.F32_EXCHANGE: "exchange", L.F32_SPLIT: "split"}


def bwd_smem_bytes(semi: bool, In: int, H: int, B: int, ahead: bool) -> int:
    """Shared memory of a K3-bwd (K4-bwd if ``semi``) launch over B batch
    rows, keeping every tile across the barrier (``ahead``) or not
    (``bwd_smem_bytes`` of ``csrc/lstm_fused_bwd.cuh``)."""
    BT, ROWS, LDD, TILE = 64, 16, 72, 64 * 128
    nres = -(-B // BT) if ahead else 1
    passes = 0 if semi else -(-(In // 4) // (H // 4))
    Kp = H if semi else In + H
    Kp += (40 - Kp % 32) % 32                  # dw_pitch
    return (2 * (4 if ahead else 2) * TILE
            + 4 * (ROWS * Kp + nres * BT * ROWS)
            + 2 * (ROWS * (In + H + 8) + nres * ROWS * LDD
                   + (4 * passes + 4) * (4 * H + 8))
            + 4 * 8)                           # the tiles' mbarriers


def keeps_tiles(semi: bool, In: int, H: int, B: int) -> bool:
    """Whether a launch takes the schedule that keeps its tiles across the
    barrier (``keeps_tiles`` of ``csrc/lstm_fused_bwd.cuh``)."""
    return (-(-B // 64) <= 4
            and bwd_smem_bytes(semi, In, H, B, True) <= 232448)


def phase_split(stamps: torch.Tensor) -> Dict[str, Dict[str, float]]:
    """``stamps`` (T, blocks, 7) int64 ns -> each phase's microseconds a
    step (``PHASES``): every block's mean over the steps, then min, median
    and max over the blocks. A stamp never written (0: K4's step 0 has no
    exchange) counts as its phase's start."""
    st = stamps.to(torch.float64)
    out = {}
    for name, (a, b) in PHASES.items():
        end = torch.where(st[..., b] > 0, st[..., b], st[..., a])
        m = (end - st[..., a]).mean(dim=0) / 1e3   # (blocks,) us a step
        out[name] = {"min": float(m.min()), "median": float(m.median()),
                     "max": float(m.max())}
    return out


def k1_bwd_smem_bytes(H: int) -> int:
    """Shared memory of a narrow K1-bwd launch (``smem_bytes`` of
    ``csrc/lstm_bwd.cu``; ``ops.k1_plan.narrow_bwd_smem_bytes``): the
    h_{t-1} tile of 64 rows in boxes of 32 columns, W_hh's 16 rows, the
    split-K pre-activations, the dgates, f32, and an mbarrier a box. It
    does not depend on B."""
    return narrow_bwd_smem_bytes(H)


def k1_bwd_schedule(B: int, H: int):
    """(split, columns) of a narrow K1-bwd launch: whether it takes the
    split schedule (one batch tile, the recompute between the barrier's
    arrival and wait) rather than the tiles in series, and how many columns
    of H a thread holds W_hh's and dW_hh's rows for (``KP``). The whole
    plan, wide builds included, is ``k1_bwd_plan``."""
    plan = k1_bwd_plan(H, B)
    return plan.split, plan.cols


def k1_bwd_tensor_map(T: int, B: int, H: int):
    """K1-bwd's tensor map over hs (T, B, H) f32: (dims, byte strides of
    dims 1 and 2, box), innermost first."""
    return (H, B, T), (4 * H, 4 * H * B), (32, 64, 1)


def k1_problem(dev, B: int, seed: int = 0):
    """A K1-bwd input at T, H: gx N(0, 0.5^2), W_hh U(+-1/sqrt(H)), the
    trajectory from K1-fwd, cotangents N(0, 0.1^2) for every h and the
    final c."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gx = torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5
    w = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) / H ** 0.5
    hs, cs = L.lstm_layer_fwd(gx, w)
    dhs = torch.randn((T, B, H), generator=g, device=dev) * 0.1
    dc_last = torch.randn((B, H), generator=g, device=dev) * 0.1
    return gx, w, hs, cs, dhs, dc_last


def timed_k1(prob, reverse: bool = False):
    """K1-bwd's timing build on ``prob``: ((dgx, dW_hh), as
    ``lstm_layer_bwd``'s, and the (T, H/4, 10) int64 timeline)."""
    gx, w, hs, cs, dhs, dc_last = prob
    Tn, B, G = gx.shape
    Hn = G // 4
    dev = gx.device
    tl = torch.zeros((Tn, Hn // 4, K1_SLOTS), device=dev, dtype=torch.int64)
    dgx = torch.empty_like(gx)
    dw = torch.zeros((G, Hn), device=dev, dtype=torch.float32)
    part, dh_buf, dc_buf, barrier = L.k1_bwd_scratch(gx, dc_last)
    TIMED["lstm_bwd"](gx.data_ptr(), w.data_ptr(), hs.data_ptr(),
                      cs.data_ptr(), dhs.data_ptr(), dgx.data_ptr(),
                      dw.data_ptr(), part.data_ptr(), dh_buf.data_ptr(),
                      dc_buf.data_ptr(), barrier.data_ptr(), Tn, B, Hn,
                      int(reverse), tl.data_ptr(), _build.stream_handle(dev))
    return (dgx, dw), tl


def k1_rows(dev, iters: int):
    rows = []
    for B in K1_BATCHES:
        prob = k1_problem(dev, B)
        want = L.lstm_layer_bwd(*prob)
        got, tl = timed_k1(prob)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        ms = cuda_ms(lambda: L.lstm_layer_bwd(*prob), iters)
        rows.append({
            "kernel": "lstm_bwd", "B": B, "T": T, "H": H,
            "bit_equal_to_normal_build": equal,
            "ms": ms, "us_a_step_total": ms * 1e3 / T,
            "ms_timing_build": cuda_ms(lambda: timed_k1(prob), iters),
            "us_a_step": ftl.phase_split(tl.cpu(), K1_PHASES)})
    return rows


def wide_problem(dev, B: int, seed: int = 0, bf16: bool = True):
    """A wide K1-bwd input at T, H=1024: gx N(0, 0.5^2), W_hh
    U(+-1/sqrt(H)) and cotangents N(0, 0.1^2) for every h in bf16 (or f32
    with ``bf16`` false), the trajectory from the wide K1-fwd of that
    dtype, an f32 cotangent for the final c."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    gx = (torch.randn((T, B, 4 * WIDE_H), generator=g, device=dev)
          * 0.5).to(dt)
    w = ((torch.rand((4 * WIDE_H, WIDE_H), generator=g, device=dev) * 2 - 1)
         / WIDE_H ** 0.5).to(dt)
    hs, cs = L.lstm_layer_fwd(gx, w)
    dhs = (torch.randn((T, B, WIDE_H), generator=g, device=dev) * 0.1).to(dt)
    dc_last = torch.randn((B, WIDE_H), generator=g, device=dev) * 0.1
    return gx, w, hs, cs, dhs, dc_last


def timed_wide(prob, reverse: bool = False):
    """The bf16 wide K1-bwd's timing build (the recurrence) on ``prob``:
    (dgx, as ``lstm_layer_bwd``'s, and the (T, H/8, 10) int64
    timeline)."""
    gx, w, hs, cs, dhs, dc_last = prob
    Tn, B, G = gx.shape
    Hn = G // 4
    dev = gx.device
    tl = torch.zeros((Tn, Hn // 8, K1_SLOTS), device=dev, dtype=torch.int64)
    dgx = torch.empty_like(gx)
    dh_buf, dc_buf, barrier = L.k1_bf16_bwd_scratch(gx, dc_last)
    TIMED["lstm_bwd_wide_bf16"](
        gx.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        dhs.data_ptr(), dgx.data_ptr(), dh_buf.data_ptr(), dc_buf.data_ptr(),
        barrier.data_ptr(), Tn, B, Hn, int(reverse), tl.data_ptr(),
        _build.stream_handle(dev))
    return dgx, tl


def timed_wide_f32(prob, reverse: bool = False):
    """The f32 wide K1-bwd's timing build (the recurrence) on ``prob``:
    (dgx, as ``lstm_layer_bwd``'s, and the (T, H/8, 10) int64
    timeline)."""
    gx, w, hs, cs, dhs, dc_last = prob
    Tn, B, G = gx.shape
    Hn = G // 4
    dev = gx.device
    tl = torch.zeros((Tn, Hn // 8, K1_SLOTS), device=dev, dtype=torch.int64)
    dgx = torch.empty_like(gx)
    part, dh_buf, dc_buf, barrier = L.k1_bwd_scratch(gx, dc_last)
    TIMED["lstm_bwd_wide"](
        gx.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        dhs.data_ptr(), dgx.data_ptr(), part.data_ptr(), dh_buf.data_ptr(),
        dc_buf.data_ptr(), barrier.data_ptr(), Tn, B, Hn, int(reverse),
        tl.data_ptr(), _build.stream_handle(dev))
    return dgx, tl


def wide_f32_rows(dev, iters: int):
    rows = []
    for B in K1_BATCHES:
        prob = wide_problem(dev, B, bf16=False)
        want = L.lstm_layer_bwd(*prob)[0]
        got, tl = timed_wide_f32(prob)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: L.lstm_layer_bwd(*prob), iters)
        rows.append({
            "kernel": "lstm_bwd_wide", "B": B, "T": T, "H": WIDE_H,
            "bit_equal_to_normal_build": torch.equal(got, want),
            "ms": ms, "us_a_step_total": ms * 1e3 / T,
            "ms_timing_build": cuda_ms(lambda: timed_wide_f32(prob), iters),
            "us_a_step": ftl.phase_split(tl.cpu(), K1_PHASES)})
    return rows


def wide_rows(dev, iters: int):
    rows = []
    for B in K1_BATCHES:
        prob = wide_problem(dev, B)
        want = L.lstm_layer_bwd(*prob)[0]
        got, tl = timed_wide(prob)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: L.lstm_layer_bwd(*prob), iters)
        rows.append({
            "kernel": "lstm_bwd_wide_bf16", "B": B, "T": T, "H": WIDE_H,
            "bit_equal_to_normal_build": torch.equal(got, want),
            "ms": ms, "us_a_step_total": ms * 1e3 / T,
            "ms_timing_build": cuda_ms(lambda: timed_wide(prob), iters),
            "us_a_step": ftl.phase_split(tl.cpu(), WIDE_PHASES)})
    return rows


def gru_problem(dev, B: int, seed: int = 0, bf16: bool = True):
    """A K5-bwd input at T, H=512 (``bench_fwd_timeline``'s K5-fwd input,
    bf16 or f32), its trajectory from K5-fwd, and cotangents N(0, 0.1^2)
    for every h in the stream dtype."""
    gx, w, b = ftl.gru_problem(dev, B, seed, bf16)
    hs, hs32 = G.gru_layer_fwd(gx, w, b)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dhs = (torch.randn(hs.shape, generator=g, device=dev) * 0.1).to(
        gx.dtype)
    return gx, w, b, hs, hs32, dhs


def timed_gru(prob, reverse: bool = False):
    """K5-bwd's timing build of ``prob``'s stream dtype on ``prob``: bf16,
    the recurrence, ((dgx, db_hh), as ``gru_layer_bwd``'s); f32, ((dgx,
    dW_hh, db_hh)); and the (T, blocks, 10) int64 timeline."""
    gx, w, b, hs, hs32, dhs = prob
    Tn, B, G3 = gx.shape
    Hn = G3 // 3
    dev = gx.device
    bf16 = gx.dtype == torch.bfloat16
    tl = torch.zeros((Tn, G.k5_plan("bwd", Hn, bf16).blocks, K1_SLOTS),
                     device=dev, dtype=torch.int64)
    dgx = torch.empty_like(gx)
    db = torch.zeros((G3,), device=dev, dtype=torch.float32)
    dh_buf = torch.zeros((B, Hn), device=dev, dtype=torch.float32)
    barrier = torch.zeros((1,), device=dev, dtype=torch.int32)
    stream = _build.stream_handle(dev)
    if bf16:
        dgn = torch.empty_like(hs)
        TIMED["gru_bwd_bf16"](
            gx.data_ptr(), w.data_ptr(), b.data_ptr(), hs.data_ptr(),
            hs32.data_ptr(), dhs.data_ptr(), dgx.data_ptr(), dgn.data_ptr(),
            db.data_ptr(), dh_buf.data_ptr(), barrier.data_ptr(), Tn, B, Hn,
            int(reverse), tl.data_ptr(), stream)
        return (dgx, db), tl
    dw = torch.zeros((G3, Hn), device=dev, dtype=torch.float32)
    part = torch.empty((2, Hn // G.F32_UNITS, B, Hn), device=dev,
                       dtype=torch.float32)
    TIMED["gru_bwd"](
        gx.data_ptr(), w.data_ptr(), b.data_ptr(), hs.data_ptr(),
        dhs.data_ptr(), dgx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        part.data_ptr(), dh_buf.data_ptr(), barrier.data_ptr(), Tn, B, Hn,
        int(reverse), tl.data_ptr(), stream)
    return (dgx, dw, db), tl


def gru_rows(dev, iters: int):
    """The rows of K5-bwd at gate 3's shape: its bf16 recurrence, then its
    f32 build."""
    rows = []
    for bf16 in (True, False):
        for B in ftl.GRU_BATCHES:
            prob = gru_problem(dev, B, bf16=bf16)
            want = G.gru_layer_bwd(*prob)
            got, tl = timed_gru(prob)
            torch.cuda.synchronize()
            if bf16:         # the recurrence's outputs: dgx and db_hh
                want = (want[0], want[2])
            ms = cuda_ms(lambda: G.gru_layer_bwd(*prob), iters)
            rows.append({
                "kernel": "gru_bwd_bf16" if bf16 else "gru_bwd", "B": B,
                "T": T, "H": ftl.GRU_H,
                "bit_equal_to_normal_build": all(
                    torch.equal(a, c) for a, c in zip(got, want)),
                "ms": ms, "us_a_step_total": ms * 1e3 / T,
                "ms_timing_build": cuda_ms(lambda: timed_gru(prob), iters),
                "us_a_step": ftl.phase_split(
                    tl.cpu(), WIDE_PHASES if bf16 else K1_PHASES)})
    return rows


def make_problem(dev, In: int, B: int, seed: int = 0):
    """x, w_ih, w_hh bf16, the f32 bias at the recipe layers' scales
    (weights U(+-1/sqrt(H))), the forward's hs and cs from K3/K4-fwd, bf16
    cotangents for every h and f32 ones for the final c."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    x = (torch.randn((T, B, In), generator=g, device=dev) * 0.5).to(bf)
    w_ih = ((torch.rand((4 * H, In), generator=g, device=dev) * 2 - 1)
            / H ** 0.5).to(bf)
    bias = (torch.rand((4 * H,), generator=g, device=dev) * 2 - 1) / H ** 0.5
    w_hh = ((torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1)
            / H ** 0.5).to(bf)
    hs, cs = L.lstm_fused_fwd(x, w_ih, bias, w_hh)
    dhs = (torch.randn((T, B, H), generator=g, device=dev) * 0.1).to(bf)
    dc_last = torch.randn((B, H), generator=g, device=dev) * 0.1
    return x, w_ih, bias, w_hh, hs, cs, dhs, dc_last


def timed_bwd(name: str, prob, reverse: bool = False, kernel=None):
    """The timing build of ``name`` (or ``kernel``, one of ``ABLATED``) on
    ``prob``: (its outputs, as the normal wrapper's, and the (T, H/4, 7)
    int64 timeline)."""
    kernel = kernel or TIMED[name]
    x, w_ih, bias, w_hh, hs, cs, dhs, dc_last = prob
    Tn, B, In = x.shape
    Hn = w_hh.shape[1]
    stream = _build.stream_handle(x.device)
    tl = torch.zeros((Tn, Hn // 4, STAMPS), device=x.device,
                     dtype=torch.int64)
    dh_buf, dc_buf, barrier = L._bwd_scratch(x, Hn, dc_last)
    head = (x.data_ptr(), w_ih.data_ptr(), bias.data_ptr(), w_hh.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), dhs.data_ptr())
    if name == "lstm_fused_bwd":
        dx = torch.empty_like(x)
        dwih = torch.empty((4 * Hn, In), device=x.device, dtype=torch.float32)
        db = torch.empty((4 * Hn,), device=x.device, dtype=torch.float32)
        dwhh = torch.empty((4 * Hn, Hn), device=x.device,
                           dtype=torch.float32)
        dgbuf = torch.empty((2, B, 4 * Hn), device=x.device, dtype=x.dtype)
        kernel(*head, dx.data_ptr(), dwih.data_ptr(), db.data_ptr(),
                    dwhh.data_ptr(), dgbuf.data_ptr(), dh_buf.data_ptr(),
                    dc_buf.data_ptr(), barrier.data_ptr(), Tn, B, In, Hn,
                    int(reverse), tl.data_ptr(), stream)
        return (dx, dwih, db, dwhh), tl
    dgx = torch.empty((Tn, B, 4 * Hn), device=x.device, dtype=x.dtype)
    dwhh = torch.empty((4 * Hn, Hn), device=x.device, dtype=torch.float32)
    kernel(*head, dgx.data_ptr(), dwhh.data_ptr(), dh_buf.data_ptr(),
                dc_buf.data_ptr(), barrier.data_ptr(), Tn, B, In, Hn,
                int(reverse), tl.data_ptr(), stream)
    return (dgx, dwhh), tl


def make_f32_problem(dev, In: int, B: int, seed: int = 0):
    """``make_problem``'s layer on f32 streams: x, W_ih, W_hh, the bias
    f32, the trajectory from K3/K4-fwd f32, f32 cotangents."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, B, In), generator=g, device=dev) * 0.5
    w_ih = (torch.rand((4 * H, In), generator=g, device=dev) * 2 - 1) \
        / H ** 0.5
    bias = (torch.rand((4 * H,), generator=g, device=dev) * 2 - 1) / H ** 0.5
    w_hh = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) \
        / H ** 0.5
    hs, cs = L.lstm_fused_fwd(x, w_ih, bias, w_hh)
    dhs = torch.randn((T, B, H), generator=g, device=dev) * 0.1
    dc_last = torch.randn((B, H), generator=g, device=dev) * 0.1
    return x, w_ih, bias, w_hh, hs, cs, dhs, dc_last


def f32_outputs(name: str, prob):
    """Empty outputs of the f32 K3-bwd (dX, dW_ih, db, dW_hh) or K4-bwd
    (dgx, dW_hh) on ``prob``."""
    x, w_ih = prob[0], prob[1]
    Tn, B, In = x.shape
    G = w_ih.shape[0]
    f32 = dict(device=x.device, dtype=torch.float32)
    if name == "lstm_semi_bwd_f32":
        return (torch.empty((Tn, B, G), **f32),
                torch.empty((G, G // 4), **f32))
    return (torch.empty_like(x), torch.empty((G, In), **f32),
            torch.empty((G,), **f32), torch.empty((G, G // 4), **f32))


def run_f32(name: str, prob, timed: bool):
    """The f32 build of ``name`` (its timing build if ``timed``) on
    ``prob``: (its outputs, the (T, H/4, 10) int64 timeline or None)."""
    x, w_ih, bias, w_hh, hs, cs, dhs, dc_last = prob
    out = f32_outputs(name, prob)
    tl = None
    if timed:
        tl = torch.zeros((x.shape[0], w_hh.shape[1] // 4, K1_SLOTS),
                         device=x.device, dtype=torch.int64)
    kernel = TIMED[name] if timed else (
        L.LSTM_FUSED_BWD_F32 if name == "lstm_fused_bwd_f32"
        else L.LSTM_SEMI_BWD_F32)
    L.f32_bwd_launch(kernel, (x, w_ih, bias, w_hh, hs, cs, dhs), out,
                     dc_last, False, tl)
    return out, tl


def f32_rows(dev, iters: int):
    rows = []
    for name, In in F32_CASES:
        kind = "semi" if name == "lstm_semi_bwd_f32" else "bwd"
        for B in BATCHES:
            prob = make_f32_problem(dev, In, B)
            want, _ = run_f32(name, prob, False)
            got, tl = run_f32(name, prob, True)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: run_f32(name, prob, False), iters)
            plan = L.fused_f32_launch_plan(kind, In, H, B)
            rows.append({
                "kernel": name, "In": In, "B": B, "T": T, "H": H,
                "schedule": F32_SCHEDULE_NAMES[plan["schedule"]],
                "plan": plan,
                "bit_equal_to_normal_build": all(
                    torch.equal(a, b) for a, b in zip(got, want)),
                "ms": ms, "us_a_step_total": ms * 1e3 / T,
                "ms_timing_build": cuda_ms(
                    lambda: run_f32(name, prob, True), iters),
                "us_a_step": ftl.phase_split(tl.cpu(), K1_PHASES)})
    return rows


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


def bench(dev, iters: int = 10) -> Dict:
    _build.build([*_build.VARIANTS, "lstm_fused_fwd", "lstm_fused_bwd",
                  "lstm_semi_bwd", "lstm_fwd", "lstm_bwd",
                  "lstm_fwd_wide_bf16", "lstm_bwd_wide_bf16",
                  "gru_fwd_bf16", "gru_bwd_bf16", "gru_fwd", "gru_bwd",
                  "lstm_fwd_wide", "lstm_bwd_wide", "lstm_fused_fwd_f32",
                  "lstm_fused_bwd_f32"])
    rows = []
    for name, In in CASES:
        for B in BATCHES:
            prob = make_problem(dev, In, B)
            want = getattr(L, name)(*prob)
            got, tl = timed_bwd(name, prob)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            rows.append({
                "kernel": name, "In": In, "B": B, "T": T, "H": H,
                "ahead": keeps_tiles(name == "lstm_semi_bwd", In, H, B),
                "bit_equal_to_normal_build": equal,
                "ms": cuda_ms(lambda: getattr(L, name)(*prob), iters),
                "ms_timing_build": cuda_ms(lambda: timed_bwd(name, prob),
                                           iters),
                "us_a_step": phase_split(tl.cpu()),
                "ablation": {
                    f"rows{r}": ablation(name, prob, r, iters)
                    for r in _build.ABLATION_ROWS}})
    return {"rows": rows, "lstm_bwd": k1_rows(dev, iters),
            "lstm_bwd_wide_bf16": wide_rows(dev, iters),
            "lstm_bwd_wide": wide_f32_rows(dev, iters),
            "gru": gru_rows(dev, iters), "fused_f32": f32_rows(dev, iters)}


def ablation(name: str, prob, rows: int, iters: int) -> Dict:
    """The timing build that reads only the first ``rows`` rows of each
    staged chunk from L2: its ms and median microseconds a step of each
    phase (outputs wrong by design, not checked)."""
    kernel = ABLATED[(name, rows)]
    _, tl = timed_bwd(name, prob, kernel=kernel)
    torch.cuda.synchronize()
    return {"ms": cuda_ms(lambda: timed_bwd(name, prob, kernel=kernel),
                         iters),
            "us_a_step": {k: v["median"]
                          for k, v in phase_split(tl.cpu()).items()}}


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
    print(json.dumps({"tool": "bench_bwd_timeline",
                      "device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": _card(), **res}), flush=True)
    bad = [(r["kernel"], r["B"]) for r in [*res["rows"], *res["lstm_bwd"],
                                           *res["lstm_bwd_wide_bf16"],
                                           *res["lstm_bwd_wide"],
                                           *res["gru"], *res["fused_f32"]]
           if not r["bit_equal_to_normal_build"]]
    if bad:
        print(f"bench_bwd_timeline: the timing build differs from the "
              f"normal build at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
