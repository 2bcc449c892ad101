"""LSTM recurrence kernels, their plain PyTorch versions, and the autograd
seams between them.

Two families, as in ``mlvae_tpu/ops/lstm_pallas.py``:

- **Over precomputed gates** (K1-fwd, K1-bwd; ``_run_fwd``, ``_run_bwd``
  and the ``lstm_layer`` custom VJP), the f32 path and the bf16 layers
  that miss both fused tiers: the input projection ``x @ W_ih^T + b``
  stays outside (a plain ``torch.matmul``), and the recurrence ``gates =
  gx[t] + h_{t-1} @ W_hh^T`` runs here. ``lstm_layer_fwd`` /
  ``lstm_layer_bwd`` run, for CUDA tensors, the build that ``ops.k1_plan``
  picks for H: on f32 streams ``csrc/lstm_fwd.cu`` / ``csrc/lstm_bwd.cu``
  up to H=528 and ``csrc/lstm_fwd_wide.cu`` / ``csrc/lstm_bwd_wide.cu``
  above it up to H=1024; on bf16 streams ``csrc/lstm_fwd_wide_bf16.cu`` /
  ``csrc/lstm_bwd_wide_bf16.cu`` at every H % 128 == 0 up to 1024 (a wider
  H is refused); either wide backward forms
  dW_hh in a second kernel, after the recurrence. ``lstm_layer_ref`` /
  ``lstm_layer_bwd_ref`` for CPU tensors only; ``LSTMRecurrence`` joins
  them.
- **Fused input projection** (K3/K4-fwd, K3-bwd, K4-bwd;
  ``_run_fwd_fused``, ``_run_bwd_fused``, ``_run_bwd_semi`` and the
  ``lstm_layer_fused`` / ``lstm_layer_semifused`` custom VJPs), the bf16
  (AMP) path, and the f32 one under ``MLVAE_PALLAS_FUSED=1``: ``x @ W_ih^T
  + bias`` is formed inside the recurrence, so the (T, B, 4H) gates never
  reach memory. ``lstm_fused_fwd``, ``lstm_fused_bwd`` and
  ``lstm_semi_bwd`` run, for CUDA tensors, ``csrc/lstm_fused_fwd.cu``,
  ``csrc/lstm_fused_bwd.cu`` and ``csrc/lstm_semi_bwd.cu`` on bf16 streams
  (tensor cores) and ``csrc/lstm_fused_fwd_f32.cu`` and the two kernels of
  ``csrc/lstm_fused_bwd_f32.cu`` on f32 streams (exact f32 FMAs), and the
  ``*_ref`` plain versions for CPU tensors only; ``LSTMFused`` and
  ``LSTMSemiFused`` join them.

All run in torch gate order (i, f, g, o) with zero initial state and f32
carries. ``reverse`` processes t = T-1 .. 0 by indexing; outputs stay in
natural time order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops.k1_plan import (NARROW_MAX_H, k1_bwd_plan,
                                         k1_fwd_plan)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

LSTM_FWD = _build.register(_build.Kernel(
    "lstm_fwd", "lstm_fwd", "mlvae_lstm_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]))
LSTM_BWD = _build.register(_build.Kernel(
    "lstm_bwd", "lstm_bwd", "mlvae_lstm_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]))
LSTM_FWD_WIDE = _build.register(_build.Kernel(
    "lstm_fwd_wide", "lstm_fwd_wide", "mlvae_lstm_fwd_wide",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]))
LSTM_BWD_WIDE = _build.register(_build.Kernel(
    "lstm_bwd_wide", "lstm_bwd_wide", "mlvae_lstm_bwd_wide",
    [_P] * 10 + [_I, _I, _I, _I, _P]))
# the dW_hh kernel that follows the f32 wide K1-bwd's recurrence
LSTM_DW_WIDE = _build.register(_build.Kernel(
    "lstm_dw_wide", "lstm_bwd_wide", "mlvae_lstm_dw_wide",
    [_P] * 3 + [_I] * 4 + [_P]))
# the wide builds on bf16 streams (tensor cores), and the dW_hh kernel that
# follows the bf16 K1-bwd's recurrence
LSTM_FWD_WIDE_BF16 = _build.register(_build.Kernel(
    "lstm_fwd_wide_bf16", "lstm_fwd_wide_bf16", "mlvae_lstm_fwd_wide_bf16",
    [_P] * 5 + [_I] * 4 + [_P]))
LSTM_BWD_WIDE_BF16 = _build.register(_build.Kernel(
    "lstm_bwd_wide_bf16", "lstm_bwd_wide_bf16", "mlvae_lstm_bwd_wide_bf16",
    [_P] * 9 + [_I] * 4 + [_P]))
LSTM_DW_WIDE_BF16 = _build.register(_build.Kernel(
    "lstm_dw_wide_bf16", "lstm_bwd_wide_bf16", "mlvae_lstm_dw_wide_bf16",
    [_P] * 3 + [_I] * 4 + [_P]))
LSTM_FUSED_FWD = _build.register(_build.Kernel(
    "lstm_fused_fwd", "lstm_fused_fwd", "mlvae_lstm_fused_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]))
LSTM_FUSED_BWD = _build.register(_build.Kernel(
    "lstm_fused_bwd", "lstm_fused_bwd", "mlvae_lstm_fused_bwd",
    [_P] * 15 + [_I, _I, _I, _I, _I, _P]))
LSTM_SEMI_BWD = _build.register(_build.Kernel(
    "lstm_semi_bwd", "lstm_semi_bwd", "mlvae_lstm_semi_bwd",
    [_P] * 12 + [_I, _I, _I, _I, _I, _P]))
# the same three on f32 streams; K3-bwd and K4-bwd share one source
LSTM_FUSED_FWD_F32 = _build.register(_build.Kernel(
    "lstm_fused_fwd_f32", "lstm_fused_fwd_f32", "mlvae_lstm_fused_fwd_f32",
    [_P] * 8 + [_I] * 5 + [_LL, _P]))
LSTM_FUSED_BWD_F32 = _build.register(_build.Kernel(
    "lstm_fused_bwd_f32", "lstm_fused_bwd_f32", "mlvae_lstm_fused_bwd_f32",
    [_P] * 15 + [_I] * 5 + [_LL, _P]))
LSTM_SEMI_BWD_F32 = _build.register(_build.Kernel(
    "lstm_semi_bwd_f32", "lstm_fused_bwd_f32", "mlvae_lstm_semi_bwd_f32",
    [_P] * 13 + [_I] * 5 + [_LL, _P]))


def _gate_acts(gates: torch.Tensor, H: int):
    return (torch.sigmoid(gates[:, 0 * H:1 * H]),
            torch.sigmoid(gates[:, 1 * H:2 * H]),
            torch.tanh(gates[:, 2 * H:3 * H]),
            torch.sigmoid(gates[:, 3 * H:4 * H]))


def _bptt_dgates(gates, c_t, c_prev, dh, dc, H: int):
    """One BPTT step (``_bptt_dgates`` of the JAX package): f32
    pre-activation cotangents (B, 4H) and the cell cotangent carried to the
    previous step, from the recomputed gates and the saved cells."""
    i, f, g, o = _gate_acts(gates, H)
    tanh_c = torch.tanh(c_t)
    d_o = dh * tanh_c
    dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
    dgates = torch.cat([dc * g * i * (1.0 - i),
                        dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g * g),
                        d_o * o * (1.0 - o)], dim=1)
    return dgates, dc * f


def lstm_layer_ref(gx: torch.Tensor, w_hh: torch.Tensor,
                   reverse: bool = False):
    """Plain recurrence: gx (T, B, 4H), w_hh (4H, H) -> (hs (T, B, H) in
    gx's dtype, cs (T, B, H) f32). As the Pallas kernel, h_{t-1} is rounded
    to the weights' dtype before the recurrent product (a no-op in f32),
    the product sums in f32 and c stays f32."""
    T, B, G = gx.shape
    H = G // 4
    w_t = w_hh.float().t()
    h = gx.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    hs = gx.new_empty((T, B, H))
    cs = gx.new_empty((T, B, H), dtype=torch.float32)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = _gate_acts(
            gx[t].float() + h.to(w_hh.dtype).float() @ w_t, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[t] = h.to(hs.dtype)
        cs[t] = c
    return hs, cs


def lstm_layer_bwd_ref(gx: torch.Tensor, w_hh: torch.Tensor,
                       hs: torch.Tensor, cs: torch.Tensor, dhs: torch.Tensor,
                       dc_last: torch.Tensor, reverse: bool = False):
    """Plain BPTT (the work of K1-bwd): the saved trajectories hs (T, B, H)
    in gx's dtype and cs (T, B, H) f32, the cotangents dhs (T, B, H) and
    dc_last (B, H) f32 of the final cell state -> (dgx (T, B, 4H) in gx's
    dtype, dW_hh (4H, H) f32).

    Walks the processing order backward from dh = 0, dc = dc_last,
    recomputing the gates from ``hs`` (h_{t-1} = c_{t-1} = 0 at the first
    processed step), with ``_bptt_dgates``' step math in f32. As the
    Pallas kernel (``_bwd_recurrent_grads``), the dgates are rounded to the
    weights' dtype before both products, dh_{t-1} = dgates @ W_hh and
    dW_hh += dgates^T h_{t-1}, which sum in f32 (a no-op in f32); dgx
    takes the f32 dgates rounded to gx's dtype."""
    T, B, G = gx.shape
    H = G // 4
    wd = w_hh.dtype
    w = w_hh.float()
    w_t = w.t()
    dgx = gx.new_empty((T, B, G))
    dw = gx.new_zeros((G, H), dtype=torch.float32)
    dh = gx.new_zeros((B, H), dtype=torch.float32)
    dc = dc_last.float().clone()
    zeros = torch.zeros_like(dh)
    for s in range(T - 1, -1, -1):          # processing steps, backward
        t = T - 1 - s if reverse else s
        tp = t + 1 if reverse else t - 1     # previous processed position
        h_prev = zeros if s == 0 else hs[tp].float()
        c_prev = zeros if s == 0 else cs[tp].float()
        dh = dhs[t].float() + dh
        dgates, dc = _bptt_dgates(gx[t].float() + h_prev @ w_t,
                                  cs[t].float(), c_prev, dh, dc, H)
        dgx[t] = dgates.to(dgx.dtype)
        dgates = dgates.to(wd).float()
        dh = dgates @ w
        dw += dgates.t() @ h_prev
    return dgx, dw


def wide_dw_ref(dgx: torch.Tensor, hs: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """Plain dW_hh of the wide K1-bwd from its operands (the work of the
    dW_hh kernels, f32 and bf16): dgx (T, B, 4H), which holds the dgates
    rounded to the stream dtype as both of ``_bwd_recurrent_grads``'
    products take them, and hs (T, B, H) shifted by a step, summed in f32 ->
    (4H, H) f32: sum over the processing order's steps s >= 1 of
    dgx[t_s]^T hs[t_{s-1}] (the first processed step's h_{t-1} is zero)."""
    T, B, G = dgx.shape
    H = hs.shape[2]
    if T < 2:
        return dgx.new_zeros((G, H), dtype=torch.float32)
    x, y = (dgx[:-1], hs[1:]) if reverse else (dgx[1:], hs[:-1])
    return x.reshape(-1, G).float().t() @ y.reshape(-1, H).float()


def _stream_dtype(name: str, streams, f32s) -> torch.dtype:
    """The one dtype of K1's streams (gx, W_hh, hs, dhs), f32 or bf16; the
    cells and their cotangent (cs, dc_last) are f32."""
    dtypes = {x.dtype for x in streams}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise ValueError(f"{name}: the streams must share one dtype, f32 or "
                         f"bf16 (got {sorted(str(d) for d in dtypes)})")
    if any(x.dtype != torch.float32 for x in f32s):
        raise ValueError(f"{name}: cs and dc_last must be f32")
    return dtypes.pop()


def _k1_kernel(plan, narrow, wide, wide_bf16):
    """The kernel of ``plan``'s build (``k1_plan`` refuses what no build
    takes)."""
    return {"narrow": narrow, "wide": wide,
            "wide_bf16": wide_bf16}[plan.variant]


def _check_cuda(name: str, tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(x.device) for x in tensors})}; all "
                         "must be on one CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")


def hbuf_pitch(B: int) -> int:
    """K1-fwd's h ping-pong buffer row pitch (floats): B rounded up to a
    multiple of 4, so that each row of the TMA's tensor map starts on 16
    bytes (``hbuf_pitch`` of ``csrc/lstm_fwd.cu``)."""
    return -(-B // 4) * 4


def wide_plan(direction: str, H: int, B: int, bf16: bool = False) -> dict:
    """What the wide build of ``direction`` ("fwd", "bwd" or "dw", K1-bwd's
    dW_hh kernel) computes for its launch at H, B on f32 or ``bf16``
    streams (its ``*_plan`` entry point): blocks, threads, shared memory
    bytes, resident blocks an SM, ring buffers (f32: boxes a K slice; bf16
    K1-fwd: the h_{t-1} tile's slices; dW_hh: stages), rows or columns a
    chunk, registers and local memory bytes a thread. Builds the library;
    needs the card. Not a launch: it counts nowhere."""
    kernel = {("fwd", False): LSTM_FWD_WIDE, ("bwd", False): LSTM_BWD_WIDE,
              ("dw", False): LSTM_DW_WIDE,
              ("fwd", True): LSTM_FWD_WIDE_BF16,
              ("bwd", True): LSTM_BWD_WIDE_BF16,
              ("dw", True): LSTM_DW_WIDE_BF16}[direction, bf16]
    fn = getattr(_build.library(kernel.source), f"{kernel.symbol}_plan")
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    code = fn(H, B, out)
    if code:
        raise RuntimeError(f"{kernel.name} plan: CUDA error {code}")
    keys = ("blocks", "threads", "smem_bytes", "blocks_per_sm", "ring",
            "chunk", "registers", "local_bytes")
    return dict(zip(keys, list(out)))


def lstm_layer_fwd(gx: torch.Tensor, w_hh: torch.Tensor,
                   reverse: bool = False):
    """K1-fwd: same contract as ``lstm_layer_ref``, gx and W_hh in one
    stream dtype (f32 or bf16). CPU tensors take the plain version; CUDA
    tensors launch the build ``k1_fwd_plan`` picks or raise: on f32
    streams the narrow one (four units a block, H/4 blocks all resident at
    once) up to H=528 and the wide one (eight units a block) above it up to
    H=1024; on bf16 streams the tensor-core build (eight units a block) at
    every H % 128 == 0 up to 1024. Mixed stream dtypes and an H that is not
    a multiple of 16 are refused (``ValueError``); bf16 streams at an H
    that is not a multiple of 128, and an H above 1024, raise
    ``NotImplementedError``."""
    if gx.device.type == "cpu":
        return lstm_layer_ref(gx, w_hh, reverse)
    dtype = _stream_dtype("lstm_layer_fwd", (gx, w_hh), ())
    if gx.dim() != 3 or gx.shape[2] % 4 or w_hh.shape != (gx.shape[2],
                                                         gx.shape[2] // 4):
        raise ValueError(f"lstm_layer_fwd: gx {tuple(gx.shape)} and w_hh "
                         f"{tuple(w_hh.shape)} are not (T, B, 4H), (4H, H)")
    T, B, G = gx.shape
    H = G // 4
    plan = k1_fwd_plan(H, max(B, 1), bf16=dtype == torch.bfloat16)
    kernel = _k1_kernel(plan, LSTM_FWD, LSTM_FWD_WIDE, LSTM_FWD_WIDE_BF16)
    _check_cuda("lstm_layer_fwd", (gx, w_hh))
    hs = torch.empty((T, B, H), device=gx.device, dtype=dtype)
    cs = torch.empty((T, B, H), device=gx.device, dtype=torch.float32)
    if plan.variant == "wide_bf16":
        # the next step stages h_{t-1} from hs itself (TMA, 16-byte base)
        barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
        if T and B:
            kernel(gx.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                   cs.data_ptr(), barrier.data_ptr(), T, B, H, int(reverse),
                   _build.stream_handle(gx.device))
        return hs, cs
    # h ping-pong buffer (rows padded to 16 bytes for the TMA) and the step
    # barrier's counter
    hbuf = torch.zeros((2, H, hbuf_pitch(B)), device=gx.device,
                       dtype=torch.float32)
    barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
    if T and B:
        kernel(gx.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
               hbuf.data_ptr(), barrier.data_ptr(), T, B, H, int(reverse),
               _build.stream_handle(gx.device))
    return hs, cs


def k1_bwd_scratch(gx: torch.Tensor, dc_last: torch.Tensor):
    """K1-bwd's scratch for a (T, B, 4H) ``gx``: each block's split-K
    share of dh_{t-1}, (2, H/units, B, H) floats ping-ponged between steps
    (``k1_bwd_plan``'s units a block: the narrow build lays each block's
    B x H out as (H/4, B, 4), the wide one as (H/8, B, 8)); the dh carry
    (zero at the start) and the dc carry (from dc_last), (B, H), each entry
    touched by one thread only; the step barrier's counter."""
    _, B, G = gx.shape
    H = G // 4
    units = k1_bwd_plan(H, max(B, 1)).units
    part = torch.empty((2, H // units, B, H), device=gx.device,
                       dtype=torch.float32)
    dh_buf = torch.zeros((B, H), device=gx.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
    return part, dh_buf, dc_last.clone(), barrier


def k1_bf16_bwd_scratch(gx: torch.Tensor, dc_last: torch.Tensor):
    """The bf16 wide K1-bwd's scratch for a (T, B, 4H) ``gx``: the dh carry
    (zero at the start) and the dc carry (from dc_last), (B, H) f32, each
    entry touched by one thread only (read by the tiles in series of B >
    64; one tile keeps them in registers), and the step barrier's
    counter."""
    _, B, G = gx.shape
    dh_buf = torch.zeros((B, G // 4), device=gx.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
    return dh_buf, dc_last.clone(), barrier


def lstm_layer_bwd(gx: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor,
                   cs: torch.Tensor, dhs: torch.Tensor,
                   dc_last: torch.Tensor, reverse: bool = False):
    """K1-bwd: same contract as ``lstm_layer_bwd_ref``, gx, W_hh, hs and dhs
    in one stream dtype (f32 or bf16), cs and dc_last f32. CPU tensors take
    the plain version; CUDA tensors launch the build ``k1_bwd_plan`` picks
    or raise, as K1-fwd: f32 narrow up to H=528 and wide up to H=1024,
    bf16 at every H % 128 == 0 up to 1024, mixed stream dtypes and an H
    that is not a multiple of 16 refused, the bf16 layers no build takes
    and an H above 1024 ``NotImplementedError``. dW_hh comes back f32 in
    either dtype. The wide and bf16 builds launch two kernels: the recurrence
    (dgx), then the dW_hh kernel over dgx and hs (``wide_dw_ref``), which
    a T=1 layer, whose only step has h_{t-1} = 0, does without.
    """
    if gx.device.type == "cpu":
        return lstm_layer_bwd_ref(gx, w_hh, hs, cs, dhs, dc_last, reverse)
    dtype = _stream_dtype("lstm_layer_bwd", (gx, w_hh, hs, dhs),
                          (cs, dc_last))
    T, B, G = gx.shape
    H = G // 4
    if (gx.dim() != 3 or G % 4 or w_hh.shape != (G, H)
            or hs.shape != (T, B, H) or cs.shape != (T, B, H)
            or dhs.shape != (T, B, H) or dc_last.shape != (B, H)):
        raise ValueError(
            f"lstm_layer_bwd: gx {tuple(gx.shape)}, w_hh "
            f"{tuple(w_hh.shape)}, hs/cs/dhs {tuple(hs.shape)}/"
            f"{tuple(cs.shape)}/{tuple(dhs.shape)}, dc_last "
            f"{tuple(dc_last.shape)} are not (T, B, 4H), (4H, H), (T, B, H) "
            "and (B, H)")
    plan = k1_bwd_plan(H, max(B, 1), bf16=dtype == torch.bfloat16)
    kernel = _k1_kernel(plan, LSTM_BWD, LSTM_BWD_WIDE, LSTM_BWD_WIDE_BF16)
    _check_cuda("lstm_layer_bwd", (gx, w_hh, hs, cs, dhs, dc_last))
    if hs.data_ptr() % 16:
        raise ValueError("lstm_layer_bwd: hs must be 16-byte aligned (the "
                         "kernel reads it as float4 or by the TMA)")
    dgx = torch.empty_like(gx)
    dw = torch.zeros((G, H), device=gx.device, dtype=torch.float32)
    if not (T and B):
        return dgx, dw
    stream = _build.stream_handle(gx.device)
    if plan.variant == "wide_bf16":
        dh_buf, dc_buf, barrier = k1_bf16_bwd_scratch(gx, dc_last)
        kernel(gx.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
               dhs.data_ptr(), dgx.data_ptr(), dh_buf.data_ptr(),
               dc_buf.data_ptr(), barrier.data_ptr(), T, B, H, int(reverse),
               stream)
    else:
        part, dh_buf, dc_buf, barrier = k1_bwd_scratch(gx, dc_last)
        head = (gx.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                dhs.data_ptr(), dgx.data_ptr())
        tail = (part.data_ptr(), dh_buf.data_ptr(), dc_buf.data_ptr(),
                barrier.data_ptr(), T, B, H, int(reverse), stream)
        if plan.variant == "narrow":
            kernel(*head, dw.data_ptr(), *tail)
            return dgx, dw
        kernel(*head, *tail)
    if T > 1:
        dw_kernel = LSTM_DW_WIDE_BF16 if plan.variant == "wide_bf16" \
            else LSTM_DW_WIDE
        dw_kernel(dgx.data_ptr(), hs.data_ptr(), dw.data_ptr(), T, B, H,
                  int(reverse), stream)
    return dgx, dw


class LSTMRecurrence(torch.autograd.Function):
    """The differentiable recurrence (the JAX package's ``lstm_layer``
    custom VJP): ``apply(gx, w_hh, reverse) -> (hs (T, B, H), c_last
    (B, H))``, c_last being the cell state after the last PROCESSED step
    (t=0 when ``reverse``). Forward is ``lstm_layer_fwd`` and saves
    (w_hh, gx, hs, cs); backward is ``lstm_layer_bwd``, whose f32 dW_hh
    goes back in W_hh's dtype, rounded once (``_run_bwd``'s
    ``dwhh.T.astype(w_hh.dtype)``). gx and W_hh share a stream dtype, f32
    or bf16; hs comes back in it, c_last f32. A cotangent that autograd
    leaves undefined is zeros."""

    @staticmethod
    def forward(ctx, gx, w_hh, reverse: bool):
        hs, cs = lstm_layer_fwd(gx, w_hh, reverse)
        ctx.save_for_backward(w_hh, gx, hs, cs)
        ctx.reverse = reverse
        ctx.set_materialize_grads(False)
        return hs, (cs[0] if reverse else cs[-1]).clone()

    @staticmethod
    def backward(ctx, dhs, dc_last):
        w_hh, gx, hs, cs = ctx.saved_tensors
        dhs = (torch.zeros_like(hs) if dhs is None
               else dhs.to(hs.dtype).contiguous())
        dc_last = (cs.new_zeros(cs.shape[1:]) if dc_last is None
                   else dc_last.float().contiguous())
        dgx, dw = lstm_layer_bwd(gx, w_hh, hs, cs, dhs, dc_last,
                                 ctx.reverse)
        return dgx, dw.to(w_hh.dtype), None


# ---------------------------------------------------------------------------
# Fused input projection (K3/K4-fwd, K3-bwd, K4-bwd): bf16 and f32 streams
# ---------------------------------------------------------------------------

# The JAX package's scoped-VMEM budget for the fused backward's residents
# (``FUSED_RESIDENT_BUDGET`` of ``lstm_pallas.py``): a TPU limit, not an H100
# one. It is kept so that every layer takes the same tier (fused, semi-fused)
# in both packages; choosing the tiers by H100 measurement is later work.
FUSED_RESIDENT_BUDGET = 13 * 1024 * 1024


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def fused_eligible(In: int, H: int, dtype) -> bool:
    """The JAX package's predicate for the fully fused tier (K3): In and H
    multiples of 128, and W_ih, W_hh in ``dtype`` with their f32 grads
    within the budget."""
    if In % 128 or H % 128:
        return False
    resident = (In + H) * 4 * H * _itemsize(dtype) + (In + H) * 4 * H * 4
    return resident <= FUSED_RESIDENT_BUDGET


def semifused_eligible(In: int, H: int, dtype) -> bool:
    """The half-fused tier (K4): as ``fused_eligible`` without the f32
    dW_ih accumulator."""
    if In % 128 or H % 128:
        return False
    resident = (In + H) * 4 * H * _itemsize(dtype) + H * 4 * H * 4
    return resident <= FUSED_RESIDENT_BUDGET


def lstm_fused_fwd_ref(x: torch.Tensor, w_ih: torch.Tensor,
                       bias: torch.Tensor, w_hh: torch.Tensor,
                       reverse: bool = False):
    """Plain fused recurrence (the work of K3/K4-fwd): x (T, B, In), w_ih
    (4H, In), bias (4H,) f32, w_hh (4H, H) -> (hs (T, B, H) in x's dtype,
    cs (T, B, H) f32). Products take the weights' dtype as operands and
    sum in f32 (a bf16 value times a bf16 value is exact in f32, so the
    operands are upcast); h_{t-1} is rounded to the weights' dtype before
    the recurrent product, c stays f32."""
    T, B, _ = x.shape
    H = w_hh.shape[1]
    xp = x.float() @ w_ih.float().t() + bias.float()     # (T, B, 4H) f32
    w_t = w_hh.float().t()
    h = x.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    hs = x.new_empty((T, B, H))
    cs = x.new_empty((T, B, H), dtype=torch.float32)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = _gate_acts(xp[t] + h.to(w_hh.dtype).float() @ w_t, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[t] = h.to(hs.dtype)
        cs[t] = c
    return hs, cs


def _fused_bptt(x, w_ih, bias, w_hh, hs, cs, dhs, dc_last, reverse,
                semi: bool):
    """The backward walk shared by K3-bwd and K4-bwd's plain versions:
    gates recomputed from x and the saved hs (h_{t-1} = c_{t-1} = 0 at the
    first processed step), dgates rounded to the weights' dtype for every
    product. Returns (dX, dW_ih, db, dW_hh) or, ``semi``, (dgx, dW_hh)."""
    T, B, In = x.shape
    H = w_hh.shape[1]
    G = 4 * H
    wd = w_hh.dtype
    wi, wh = w_ih.float(), w_hh.float()
    xp = x.float() @ wi.t() + bias.float()
    out = x.new_empty((T, B, G) if semi else (T, B, In))
    dwih = x.new_zeros((G, In), dtype=torch.float32)
    db = x.new_zeros((G,), dtype=torch.float32)
    dwhh = x.new_zeros((G, H), dtype=torch.float32)
    dh = x.new_zeros((B, H), dtype=torch.float32)
    dc = dc_last.float().clone()
    zeros = torch.zeros_like(dh)
    for s in range(T - 1, -1, -1):
        t = T - 1 - s if reverse else s
        tp = t + 1 if reverse else t - 1
        h_prev = zeros if s == 0 else hs[tp].to(wd).float()
        c_prev = zeros if s == 0 else cs[tp].float()
        dh = dhs[t].float() + dh
        dgates, dc = _bptt_dgates(xp[t] + h_prev @ wh.t(), cs[t].float(),
                                  c_prev, dh, dc, H)
        dg_w = dgates.to(wd).float()
        if semi:
            out[t] = dgates.to(out.dtype)
        else:
            out[t] = (dg_w @ wi).to(out.dtype)
            dwih += dg_w.t() @ x[t].float()
            db += dgates.sum(0)
        dh = dg_w @ wh
        dwhh += dg_w.t() @ h_prev
    return (out, dwhh) if semi else (out, dwih, db, dwhh)


def lstm_fused_bwd_ref(x, w_ih, bias, w_hh, hs, cs, dhs, dc_last,
                       reverse: bool = False):
    """Plain fused BPTT (the work of K3-bwd): the forward's inputs, its
    saved hs (x's dtype) and cs (f32), the cotangents dhs (T, B, H) and
    dc_last (B, H) -> (dX (T, B, In) in x's dtype, dW_ih (4H, In), db (4H,)
    and dW_hh (4H, H) in f32). db sums the f32 dgates."""
    return _fused_bptt(x, w_ih, bias, w_hh, hs, cs, dhs, dc_last, reverse,
                       semi=False)


def lstm_semi_bwd_ref(x, w_ih, bias, w_hh, hs, cs, dhs, dc_last,
                      reverse: bool = False):
    """Plain half-fused BPTT (the work of K4-bwd): as
    ``lstm_fused_bwd_ref`` but -> (dgx (T, B, 4H) in x's dtype, dW_hh
    (4H, H) f32); dX, dW_ih and db are formed from dgx outside
    (``semi_input_grads``)."""
    return _fused_bptt(x, w_ih, bias, w_hh, hs, cs, dhs, dc_last, reverse,
                       semi=True)


def semi_input_grads(x, w_ih, dgx):
    """dX and dW_ih (the stream dtype) and db (f32) from the half-fused
    backward's dgx, as ``_semi_input_grads`` of the JAX package forms them
    outside its kernel: one GEMM each on the stream-dtype operands, summed
    in f32 and rounded once, and db summed in f32 from the rounded dgx."""
    dx = torch.matmul(dgx, w_ih)
    dwih = dgx.flatten(0, 1).t() @ x.flatten(0, 1)
    return dx, dwih, dgx.sum((0, 1), dtype=torch.float32)


# a block of K3-bwd forms at most four groups of 4 dX columns, H/4 blocks
K3_MAX_IN_PER_H = 4
SMEM_LIMIT = 232448   # an H100 block's shared memory, bytes


def fused_f32_smem(kind: str, In: int, H: int) -> int:
    """Shared memory bytes of a launch of the f32 fused backwards, as
    ``smem_of`` of ``csrc/lstm_fused_bwd_f32.cu`` ("bwd": K3, "semi": K4)
    computes it, whatever B: in the split-K schedule
    (``fused_f32_bwd_plan``) the h tile (64 x 32 boxes over H), the x
    slots, W_hh's 16 rows, the split-K sums (4 x 64 x 16), the dgates (64 x
    16) and an mbarrier a box and slot; in the exchange schedule W_hh's 16
    rows (pitch H + 4), the partial sums (4 x 64 x 16), two stages of a 64
    x 128 chunk (pitch 132) and its weights (2,560 floats), their dW (16 x
    (In + H), K4 16 x H) and a tile's own dgates (64 x 16). f32
    throughout; the launch refuses more than ``SMEM_LIMIT``. The forward's
    layout depends on B and K: ``fused_f32_fwd_plan``."""
    if kind not in ("bwd", "semi"):
        raise ValueError(f"fused_f32_smem: kind {kind!r} is not 'bwd' or "
                         "'semi' (the forward: fused_f32_fwd_plan)")
    slots, smem = _f32_split_layout(kind == "semi", In, H)
    if slots:
        return smem
    return _f32_exchange_smem(kind, In, H)


def _f32_exchange_smem(kind: str, In: int, H: int) -> int:
    floats = 16 * (H + 4) + 4 * 64 * 16 + 2 * (64 * 132 + 128 * 4 * 5)
    floats += 16 * (H if kind == "semi" else In + H) + 16 * 64
    return 4 * floats


# The f32 backwards' split-K layout (csrc/lstm_fused_bwd_f32.cu): boxes of
# 64 rows x 32 columns, x slots of a box and W_ih's 16 rows of its columns,
# K4's ring of at most four slots, at most three columns of [x | h] a
# thread (256 threads)
F32_BOX = 64 * 32
F32_XSLOT = F32_BOX + 16 * 32
F32_RING = 4
F32_MAX_COLS = 3 * 256
# the schedules of ``fused_f32_bwd_plan``
F32_EXCHANGE, F32_SPLIT = 0, 1


def _f32_split_layout(semi: bool, In: int, H: int):
    """(x slots, shared memory bytes) of the split-K schedule, as
    ``split_plan`` of ``csrc/lstm_fused_bwd_f32.cu``: slots 0 where it does
    not fit. K3 keeps every x box of a step in a slot; K4 takes up to four
    slots in rounds."""
    nbh = -(-H // 32)
    fixed = 4 * (nbh * F32_BOX + 16 * H + 4 * 64 * 16 + 64 * 16) + 8 * nbh
    slot = 4 * F32_XSLOT + 8
    nxb = -(-In // 32)
    fit = 0 if fixed >= SMEM_LIMIT else (SMEM_LIMIT - fixed) // slot
    if semi:
        slots = min(F32_RING, nxb, fit)
    else:
        slots = nxb if nxb <= fit else 0
    if (H if semi else In + H) > F32_MAX_COLS:
        slots = 0
    return slots, fixed + slots * slot


class F32BwdPlan(NamedTuple):
    schedule: int   # F32_EXCHANGE or F32_SPLIT
    slots: int      # the split-K layout's x slots (0: it does not fit)
    smem: int       # shared memory bytes
    work: int       # floats of the ``work`` scratch


def fused_f32_bwd_plan(kind: str, In: int, H: int, B: int) -> F32BwdPlan:
    """The plan of an f32 K3-bwd (``kind`` "bwd") or K4-bwd ("semi") launch,
    the CPU mirror of ``schedule_of`` and ``work_floats`` of
    ``csrc/lstm_fused_bwd_f32.cu``: the split-K schedule where its layout
    fits, whatever B (a tile of 64 rows a barrier), else the exchange
    schedule; and the floats of its scratch: the split-K partials (2, H/4,
    min(B, 64), In + H) (K4: H columns), or the exchange schedule's (2, B,
    4H) exchange buffer (K3) and (B, 4H) pre-activations. A launch sizes
    its scratch from ``fused_f32_launch_plan``, the C code's plan."""
    semi = kind == "semi"
    slots, smem = _f32_split_layout(semi, In, H)
    if not slots:
        return F32BwdPlan(F32_EXCHANGE, slots,
                          _f32_exchange_smem(kind, In, H),
                          B * 4 * H * (1 if semi else 3))
    return F32BwdPlan(F32_SPLIT, slots, smem,
                      2 * (H // 4) * min(B, 64) * (H if semi else In + H))


def fused_f32_launch_smem(kind: str, In: int, H: int) -> int:
    """``fused_f32_smem`` as the C code of the backwards' build computes it
    (its ``_smem`` entry point; builds the library, launches nothing)."""
    fn = _build.library("lstm_fused_bwd_f32").mlvae_lstm_fused_bwd_f32_smem
    fn.argtypes, fn.restype = [_I] * 3, _I
    return int(fn(In, H, int(kind == "semi")))


# The f32 forward's layout (csrc/lstm_fused_fwd_f32.cu): 544 threads, the
# recurrence's eight warps, the producer's eight and the issuer's one; x
# slots of a 64 x 32 box of x and W_ih's 16 rows of its columns; item
# slots of 64 x 16 f32; an h copy H/16 rows x 64 columns, four a K slice
# and 64-row tile
F32_FWD_THREADS = 544
F32_FWD_XSLOTS = 4
F32_FWD_XSLOT = 64 * 32 + 16 * 32
F32_FWD_ITEM = 64 * 16
# the schedules of ``fused_f32_fwd_plan``: the producer a step ahead, or
# streaming fewer tiles ahead than two steps hold
F32_FWD_STREAM, F32_FWD_AHEAD = 0, 1


class F32FwdPlan(NamedTuple):
    schedule: int   # F32_FWD_STREAM or F32_FWD_AHEAD
    slots: int      # item slots (an item: a step's 64-row batch tile)
    ring: int       # h_{t-1} copies in flight a K slice
    xslots: int     # x slots
    threads: int    # threads a block
    smem: int       # shared memory bytes
    scratch: int    # floats of the scratch (the h ping-pong)


def _f32_fwd_smem(H: int, nq: int, ns: int) -> int:
    return (4 * (F32_FWD_XSLOTS * F32_FWD_XSLOT + 4 * nq * (H // 16) * 64
                 + 16 * H + 4 * 64 * 16 + ns * F32_FWD_ITEM)
            + 8 * (4 * nq + 2 * F32_FWD_XSLOTS + 2 * ns))


def fused_f32_fwd_plan(In: int, H: int, B: int, K: int = 1) -> F32FwdPlan:
    """The layout of an f32 K3/K4-fwd (K 1) or K7b (K steps a group)
    launch, the CPU mirror of ``plan_of`` of ``csrc/lstm_fused_fwd_f32.cu``
    (``chip_smoke.py`` holds it against the C plan). Shared memory: four x
    slots (10 KB each), the h ring (``ring`` copies of H/16 x 64 f32 a K
    slice, four slices), W_hh's 16 rows, the split-K partials (4 x 64 x
    16), ``slots`` item slots (64 x 16) and their mbarriers. The slots ask
    for two steps' tiles (K7b: K steps'), the ring every copy of a step
    (four a tile); where both do not fit the ring gives way first down to
    two, then the slots down to two steps, then the ring to one and the
    slots to one. The scratch: the h ping-pong (2, H, Bp), Bp = B rounded
    up to 4. A shape that no layout holds is refused with a ``ValueError``
    naming it and its rule; H above 528 among them (the H/4 blocks of one
    cooperative grid on an H100's 132 SMs)."""
    name = f"fused_f32_fwd_plan(In={In}, H={H}, B={B}, K={K})"
    if In < 4 or In % 4:
        raise ValueError(f"{name}: In must be a positive multiple of 4")
    if H < 16 or H % 16:
        raise ValueError(f"{name}: H must be a positive multiple of 16")
    if H > NARROW_MAX_H:
        raise ValueError(f"{name}: H above {NARROW_MAX_H}: H/4 blocks of "
                         "one cooperative grid, one an SM of an H100's 132")
    if B < 1 or K < 1:
        raise ValueError(f"{name}: B and K must be at least 1")
    ntiles = -(-B // 64)
    per, two = 4 * ntiles, 2 * ntiles
    nq, ns = per, max(K, 2) * ntiles

    def fits():
        return _f32_fwd_smem(H, nq, ns) <= SMEM_LIMIT

    while not fits() and nq > min(per, 2):
        nq -= 1
    while not fits() and ns > two:
        ns -= 1
    while not fits() and nq > 1:
        nq -= 1
    while not fits() and ns > 1:
        ns -= 1
    if not fits():
        raise ValueError(f"{name}: even one h copy a slice and one item "
                         f"slot pass {SMEM_LIMIT} bytes of shared memory")
    return F32FwdPlan(F32_FWD_AHEAD if ns >= two else F32_FWD_STREAM, ns, nq,
                      F32_FWD_XSLOTS, F32_FWD_THREADS,
                      _f32_fwd_smem(H, nq, ns), 2 * H * hbuf_pitch(B))


@functools.lru_cache(maxsize=1024)
def fused_f32_fwd_launch_plan(In: int, H: int, B: int, K: int = 1) -> dict:
    """The plan of an f32 K3/K4-fwd (K 1) or K7b launch at (In, H, B, K) as
    the C code of the build computes it (``mlvae_lstm_fused_fwd_f32_plan``):
    the fields of ``F32FwdPlan`` and the kernel's registers and local
    memory bytes a thread. Builds the library; needs the card. Not a
    launch: it counts nowhere."""
    fn = _build.library("lstm_fused_fwd_f32").mlvae_lstm_fused_fwd_f32_plan
    fn.argtypes = [_I] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 9)()
    code = fn(In, H, B, K, out)
    if code:
        raise RuntimeError(f"lstm_fused_fwd_f32 plan at In={In}, H={H}, "
                           f"B={B}, K={K}: CUDA error {code}")
    keys = ("schedule", "slots", "ring", "xslots", "threads", "smem",
            "scratch", "registers", "local_bytes")
    return dict(zip(keys, map(int, out)))


def f32_fwd_launch(kernel, inputs, reverse: bool, K=None,
                   timeline=None):
    """Launch ``kernel``, an entry of ``csrc/lstm_fused_fwd_f32.cu`` (K3/K4-
    fwd, or K7b with ``K``, or their timing builds), on checked ``inputs``
    (x, w_ih, bias, w_hh, f32) with the scratch that the C code's plan
    sizes (``fused_f32_fwd_launch_plan``; the entry refuses a smaller
    one); ``timeline`` the timing build's (T, H/4, 8) int64 buffer.
    Returns (hs, cs)."""
    x = inputs[0]
    T, B, In = x.shape
    H = inputs[3].shape[1]
    hs = torch.empty((T, B, H), device=x.device, dtype=torch.float32)
    cs = torch.empty((T, B, H), device=x.device, dtype=torch.float32)
    if not (T and B):
        return hs, cs
    floats = fused_f32_fwd_launch_plan(In, H, B, K or 1)["scratch"]
    scratch = torch.empty((floats,), device=x.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=x.device, dtype=torch.int32)
    ks = () if K is None else (K,)
    extra = () if timeline is None else (timeline.data_ptr(),)
    kernel(*(t.data_ptr() for t in (*inputs, hs, cs, scratch, barrier)), T,
           B, In, H, *ks, int(reverse), floats, *extra,
           _build.stream_handle(x.device))
    return hs, cs


# the kernels of an f32 backward's launch (``variant_of`` of
# csrc/lstm_fused_bwd_f32.cu)
F32_BWD_KERNELS = ("exchange_kernel", "split_kernel<KP=2>",
                   "split_kernel<KP=3>", "split_kernel<KP=3, XHALF>")


@functools.lru_cache(maxsize=1024)
def fused_f32_launch_plan(kind: str, In: int, H: int, B: int) -> dict:
    """The plan of an f32 K3-bwd (``kind`` "bwd") or K4-bwd ("semi") launch
    at In, H, B as the C code of the build computes it
    (``mlvae_lstm_fused_bwd_f32_plan``): its schedule, x slots, shared
    memory bytes, the floats of its ``work`` scratch, its kernel (an index
    of ``F32_BWD_KERNELS``) and that kernel's registers and local memory
    bytes a thread. Builds the library; needs the card. Not a launch: it
    counts nowhere."""
    fn = _build.library("lstm_fused_bwd_f32").mlvae_lstm_fused_bwd_f32_plan
    fn.argtypes = [_I] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    code = fn(In, H, B, int(kind == "semi"), out)
    if code:
        raise RuntimeError(f"lstm_fused_bwd_f32 plan: CUDA error {code}")
    keys = ("schedule", "slots", "smem", "work", "kernel", "registers",
            "local_bytes")
    return dict(zip(keys, map(int, out)))


def _check_fused(name, x, w_ih, bias, w_hh, extra=()):
    """A fused kernel's inputs: one CUDA device, streams (x, the weights,
    and hs, dhs of the backwards) all bf16 or all f32, f32 bias / cells /
    dc_last, contiguous, shapes (T, B, In), (4H, In), (4H,), (4H, H), In a
    multiple of 8 and H of 16; on f32 streams x, the weights and hs start on
    16 bytes (the kernels copy them 16 bytes at a time). H above 528 is
    refused before the rest: every fused kernel keeps H/4 blocks of one
    cooperative grid resident, one an SM of an H100's 132. Returns the
    stream dtype."""
    H = w_hh.shape[-1]
    if H > NARROW_MAX_H:
        raise NotImplementedError(
            f"{name}: H={H} above {NARROW_MAX_H}: the fused kernels keep H/4 "
            "blocks of one cooperative grid resident, one an SM of an "
            "H100's 132, and have no wide build (ROADMAP.md queue 2, 'Still "
            "to port')")
    tensors = (x, w_ih, bias, w_hh) + tuple(extra)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}; all "
                         "must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or w_ih.dtype != x.dtype or w_hh.dtype != x.dtype:
        raise ValueError(
            f"{name}: x and the weights must be all bf16 or all f32 (got "
            f"{x.dtype}, {w_ih.dtype}, {w_hh.dtype})")
    if bias.dtype != torch.float32:
        raise ValueError(f"{name}: bias must be f32 (got {bias.dtype})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if x.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (T, B, In)")
    T, B, In = x.shape
    if (w_hh.shape != (4 * H, H) or w_ih.shape != (4 * H, In)
            or bias.shape != (4 * H,)):
        raise ValueError(f"{name}: w_ih {tuple(w_ih.shape)}, bias "
                         f"{tuple(bias.shape)}, w_hh {tuple(w_hh.shape)} "
                         f"are not (4H, In), (4H,), (4H, H) for In={In}")
    if In % 8 or H % 16:
        raise ValueError(f"{name}: In={In} must be a multiple of 8 and "
                         f"H={H} of 16")
    if x.dtype == torch.float32 and any(
            t.data_ptr() % 16 for t in (x, w_ih, w_hh) + tuple(extra[:1])):
        raise ValueError(f"{name}: x, the weights and hs must start on 16 "
                         "bytes")
    return x.dtype


def _check_fused_bwd(name, x, w_ih, bias, w_hh, hs, cs, dhs, dc_last):
    dtype = _check_fused(name, x, w_ih, bias, w_hh, (hs, cs, dhs, dc_last))
    T, B, _ = x.shape
    H = w_hh.shape[1]
    if (hs.shape != (T, B, H) or cs.shape != (T, B, H)
            or dhs.shape != (T, B, H) or dc_last.shape != (B, H)):
        raise ValueError(f"{name}: hs/cs/dhs {tuple(hs.shape)}/"
                         f"{tuple(cs.shape)}/{tuple(dhs.shape)}, dc_last "
                         f"{tuple(dc_last.shape)} are not (T, B, H), (B, H)")
    if hs.dtype != dtype or dhs.dtype != dtype \
            or cs.dtype != torch.float32 or dc_last.dtype != torch.float32:
        raise ValueError(f"{name}: hs and dhs must be x's dtype ({dtype}), "
                         "cs and dc_last f32")
    return dtype


def lstm_fused_fwd(x, w_ih, bias, w_hh, reverse: bool = False):
    """K3/K4-fwd: same contract as ``lstm_fused_fwd_ref``. CPU tensors take
    the plain version; CUDA tensors launch the build of the stream dtype
    (bf16: tensor cores; f32: exact f32) or raise. As K1's narrow build,
    the H/4 blocks must all be resident at once (H <= 528 on an H100); the
    fused kernels have no wide build."""
    if x.device.type == "cpu":
        return lstm_fused_fwd_ref(x, w_ih, bias, w_hh, reverse)
    dtype = _check_fused("lstm_fused_fwd", x, w_ih, bias, w_hh)
    if dtype == torch.float32:
        return f32_fwd_launch(LSTM_FUSED_FWD_F32, (x, w_ih, bias, w_hh),
                              reverse)
    T, B, In = x.shape
    H = w_hh.shape[1]
    hs = torch.empty((T, B, H), device=x.device, dtype=dtype)
    cs = torch.empty((T, B, H), device=x.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=x.device, dtype=torch.int32)
    if not (T and B):
        return hs, cs
    LSTM_FUSED_FWD(x.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
                   w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                   barrier.data_ptr(), T, B, In, H, int(reverse),
                   _build.stream_handle(x.device))
    return hs, cs


def _bwd_scratch(x, H, dc_last):
    """The fused backwards' scratch: the dh carry (zero), the dc carry (from
    dc_last) and the step barrier's counter."""
    B = x.shape[1]
    dh_buf = torch.zeros((B, H), device=x.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=x.device, dtype=torch.int32)
    return dh_buf, dc_last.clone(), barrier


def f32_bwd_launch(kernel, inputs, outputs, dc_last, reverse: bool,
                   timeline=None) -> None:
    """Launch ``kernel``, an entry of ``csrc/lstm_fused_bwd_f32.cu`` (K3-bwd
    or K4-bwd on f32 streams, or its timing build), on checked ``inputs``
    (x, w_ih, bias, w_hh, hs, cs, dhs) into ``outputs`` (K3: dX, dW_ih, db,
    dW_hh; K4: dgx, dW_hh), with the scratch that the C code's plan sizes
    (``fused_f32_launch_plan``; the entry refuses a smaller one);
    ``timeline`` the timing build's (T, H/4, 10) int64 buffer."""
    x = inputs[0]
    T, B, In = x.shape
    H = inputs[3].shape[1]
    kind = "semi" if len(outputs) == 2 else "bwd"
    floats = fused_f32_launch_plan(kind, In, H, B)["work"]
    work = torch.empty((floats,), device=x.device, dtype=torch.float32)
    dh_buf, dc_buf, barrier = _bwd_scratch(x, H, dc_last)
    extra = () if timeline is None else (timeline.data_ptr(),)
    kernel(*(t.data_ptr() for t in (*inputs, *outputs)), work.data_ptr(),
           dh_buf.data_ptr(), dc_buf.data_ptr(), barrier.data_ptr(), T, B,
           In, H, int(reverse), floats, *extra,
           _build.stream_handle(x.device))


def _check_k3_width(name, In, H):
    """K3-bwd's dX columns: a block owns at most four groups of 4, so In
    may be at most 4H (both builds)."""
    if In > K3_MAX_IN_PER_H * H:
        raise NotImplementedError(
            f"{name}: In={In} above 4H={4 * H}: a block of K3-bwd forms at "
            "most four groups of 4 dX columns (ROADMAP.md queue 2, item 1)")


def lstm_fused_bwd(x, w_ih, bias, w_hh, hs, cs, dhs, dc_last,
                   reverse: bool = False):
    """K3-bwd: same contract as ``lstm_fused_bwd_ref``. CPU tensors take
    the plain version; CUDA tensors launch the build of the stream dtype or
    raise (In above 4H: ``NotImplementedError`` before the device)."""
    if x.device.type == "cpu":
        return lstm_fused_bwd_ref(x, w_ih, bias, w_hh, hs, cs, dhs, dc_last,
                                  reverse)
    _check_k3_width("lstm_fused_bwd", x.shape[-1], w_hh.shape[-1])
    dtype = _check_fused_bwd("lstm_fused_bwd", x, w_ih, bias, w_hh, hs, cs,
                             dhs, dc_last)
    T, B, In = x.shape
    H = w_hh.shape[1]
    dx = torch.empty_like(x)
    dwih = torch.empty((4 * H, In), device=x.device, dtype=torch.float32)
    db = torch.empty((4 * H,), device=x.device, dtype=torch.float32)
    dwhh = torch.empty((4 * H, H), device=x.device, dtype=torch.float32)
    if not (T and B):
        return dx, dwih.zero_(), db.zero_(), dwhh.zero_()
    if dtype == torch.float32:
        f32_bwd_launch(LSTM_FUSED_BWD_F32, (x, w_ih, bias, w_hh, hs, cs, dhs),
                       (dx, dwih, db, dwhh), dc_last, reverse)
        return dx, dwih, db, dwhh
    dh_buf, dc_buf, barrier = _bwd_scratch(x, H, dc_last)
    # the step's dgates in the stream dtype, exchanged between blocks;
    # ping-ponged
    dgbuf = torch.empty((2, B, 4 * H), device=x.device, dtype=dtype)
    LSTM_FUSED_BWD(x.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
                   w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                   dhs.data_ptr(), dx.data_ptr(), dwih.data_ptr(),
                   db.data_ptr(), dwhh.data_ptr(), dgbuf.data_ptr(),
                   dh_buf.data_ptr(), dc_buf.data_ptr(), barrier.data_ptr(),
                   T, B, In, H, int(reverse), _build.stream_handle(x.device))
    return dx, dwih, db, dwhh


def lstm_semi_bwd(x, w_ih, bias, w_hh, hs, cs, dhs, dc_last,
                  reverse: bool = False):
    """K4-bwd: same contract as ``lstm_semi_bwd_ref``. CPU tensors take the
    plain version; CUDA tensors launch the build of the stream dtype or
    raise."""
    if x.device.type == "cpu":
        return lstm_semi_bwd_ref(x, w_ih, bias, w_hh, hs, cs, dhs, dc_last,
                                 reverse)
    dtype = _check_fused_bwd("lstm_semi_bwd", x, w_ih, bias, w_hh, hs, cs,
                             dhs, dc_last)
    T, B, In = x.shape
    H = w_hh.shape[1]
    dgx = torch.empty((T, B, 4 * H), device=x.device, dtype=dtype)
    dwhh = torch.empty((4 * H, H), device=x.device, dtype=torch.float32)
    if not (T and B):
        return dgx, dwhh.zero_()
    if dtype == torch.float32:
        f32_bwd_launch(LSTM_SEMI_BWD_F32, (x, w_ih, bias, w_hh, hs, cs, dhs),
                       (dgx, dwhh), dc_last, reverse)
        return dgx, dwhh
    dh_buf, dc_buf, barrier = _bwd_scratch(x, H, dc_last)
    LSTM_SEMI_BWD(x.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
                  w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                  dhs.data_ptr(), dgx.data_ptr(), dwhh.data_ptr(),
                  dh_buf.data_ptr(), dc_buf.data_ptr(), barrier.data_ptr(),
                  T, B, In, H, int(reverse), _build.stream_handle(x.device))
    return dgx, dwhh


class _FusedBase(torch.autograd.Function):
    """``apply(x, w_ih, bias, w_hh, reverse) -> (hs (T, B, H), c_last
    (B, H) f32)``, the JAX package's ``lstm_layer_fused`` /
    ``lstm_layer_semifused``: forward ``lstm_fused_fwd``, saving (x, w_ih,
    bias, w_hh, hs, cs). The grads leave in their inputs' dtypes. A
    cotangent that autograd leaves undefined is zeros."""

    @staticmethod
    def forward(ctx, x, w_ih, bias, w_hh, reverse: bool):
        hs, cs = lstm_fused_fwd(x, w_ih, bias, w_hh, reverse)
        ctx.save_for_backward(x, w_ih, bias, w_hh, hs, cs)
        ctx.reverse = reverse
        ctx.set_materialize_grads(False)
        return hs, (cs[0] if reverse else cs[-1]).clone()

    @staticmethod
    def _cotangents(ctx, dhs, dc_last):
        x, w_ih, bias, w_hh, hs, cs = ctx.saved_tensors
        dhs = (torch.zeros_like(hs) if dhs is None
               else dhs.to(hs.dtype).contiguous())
        dc_last = (cs.new_zeros(cs.shape[1:]) if dc_last is None
                   else dc_last.float().contiguous())
        return (x, w_ih, bias, w_hh, hs, cs, dhs, dc_last, ctx.reverse)


class LSTMFused(_FusedBase):
    """The fully fused tier: backward ``lstm_fused_bwd`` (K3-bwd), which
    forms dX, dW_ih, db and dW_hh itself."""

    @staticmethod
    def backward(ctx, dhs, dc_last):
        args = _FusedBase._cotangents(ctx, dhs, dc_last)
        x, w_ih, bias, w_hh = args[:4]
        dx, dwih, db, dwhh = lstm_fused_bwd(*args)
        return (dx, dwih.to(w_ih.dtype), db.to(bias.dtype),
                dwhh.to(w_hh.dtype), None)


class LSTMSemiFused(_FusedBase):
    """The half-fused tier: backward ``lstm_semi_bwd`` (K4-bwd) emits dgx,
    and dX, dW_ih and db come from it through ``semi_input_grads``."""

    @staticmethod
    def backward(ctx, dhs, dc_last):
        args = _FusedBase._cotangents(ctx, dhs, dc_last)
        x, w_ih, bias, w_hh = args[:4]
        dgx, dwhh = lstm_semi_bwd(*args)
        dx, dwih, db = semi_input_grads(x, w_ih, dgx)
        return (dx, dwih.to(w_ih.dtype), db.to(bias.dtype),
                dwhh.to(w_hh.dtype), None)
