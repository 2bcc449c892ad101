"""LSTM recurrence over precomputed gates: kernels K1-fwd and K1-bwd, their
plain PyTorch versions, and the autograd seam between them.

Counterpart of ``mlvae_tpu/ops/lstm_pallas.py`` ``_run_fwd``, ``_run_bwd``
and the ``lstm_layer`` custom VJP: the input projection ``x @ W_ih^T + b``
stays outside (a plain ``torch.matmul``), and the recurrence
``gates = gx[t] + h_{t-1} @ W_hh^T`` in torch gate order (i, f, g, o) runs
here with zero initial state and f32 carries. ``reverse`` processes
t = T-1 .. 0 by indexing; outputs stay in natural time order.

``lstm_layer_fwd`` and ``lstm_layer_bwd`` run the CUDA kernels
(``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``) for CUDA tensors and the plain
versions ``lstm_layer_ref`` and ``lstm_layer_bwd_ref`` for CPU tensors
only. ``LSTMRecurrence`` joins them as one differentiable function.
"""
from __future__ import annotations

import ctypes

import torch

from mlvae_tpu_torch import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

LSTM_FWD = _build.register(_build.Kernel(
    "lstm_fwd", "lstm_fwd", "mlvae_lstm_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]))
LSTM_BWD = _build.register(_build.Kernel(
    "lstm_bwd", "lstm_bwd", "mlvae_lstm_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]))


def _gate_acts(gates: torch.Tensor, H: int):
    return (torch.sigmoid(gates[:, 0 * H:1 * H]),
            torch.sigmoid(gates[:, 1 * H:2 * H]),
            torch.tanh(gates[:, 2 * H:3 * H]),
            torch.sigmoid(gates[:, 3 * H:4 * H]))


def lstm_layer_ref(gx: torch.Tensor, w_hh: torch.Tensor,
                   reverse: bool = False):
    """Plain recurrence: gx (T, B, 4H), w_hh (4H, H) -> (hs (T, B, H) in
    gx's dtype, cs (T, B, H) f32)."""
    T, B, G = gx.shape
    H = G // 4
    w_t = w_hh.float().t()
    h = gx.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    hs = gx.new_empty((T, B, H))
    cs = gx.new_empty((T, B, H), dtype=torch.float32)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = _gate_acts(gx[t].float() + h @ w_t, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[t] = h.to(hs.dtype)
        cs[t] = c
    return hs, cs


def lstm_layer_bwd_ref(gx: torch.Tensor, w_hh: torch.Tensor,
                       hs: torch.Tensor, cs: torch.Tensor, dhs: torch.Tensor,
                       dc_last: torch.Tensor, reverse: bool = False):
    """Plain BPTT (the work of K1-bwd): the saved trajectories hs, cs
    (T, B, H), the cotangents dhs (T, B, H) and dc_last (B, H) of the final
    cell state -> (dgx (T, B, 4H) in gx's dtype, dW_hh (4H, H) f32).

    Walks the processing order backward from dh = 0, dc = dc_last,
    recomputing the gates from ``hs`` (h_{t-1} = c_{t-1} = 0 at the first
    processed step), with ``_bptt_dgates``' step math."""
    T, B, G = gx.shape
    H = G // 4
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
        i, f, g, o = _gate_acts(gx[t].float() + h_prev @ w_t, H)
        dh = dhs[t].float() + dh
        tanh_c = torch.tanh(cs[t].float())
        d_o = dh * tanh_c
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc * g * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g),
                            d_o * o * (1.0 - o)], dim=1)
        dc = dc * f
        dgx[t] = dgates.to(dgx.dtype)
        dh = dgates @ w
        dw += dgates.t() @ h_prev
    return dgx, dw


def _check_cuda_f32(name: str, tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(x.device) for x in tensors})}; all "
                         "must be on one CUDA device")
    if any(x.dtype != torch.float32 for x in tensors):
        raise NotImplementedError(
            f"{name}: the kernel takes f32 only (got "
            f"{sorted({str(x.dtype) for x in tensors})}); bf16 streams come "
            "with the AMP training slice")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")


def lstm_layer_fwd(gx: torch.Tensor, w_hh: torch.Tensor,
                   reverse: bool = False):
    """K1-fwd: same contract as ``lstm_layer_ref``. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise. The launch
    refuses an H that is not a multiple of 16 (four units per block, K split
    four ways) and one whose H/4 blocks cannot all be resident at once,
    above 528 on an H100's 132 SMs."""
    if gx.device.type == "cpu":
        return lstm_layer_ref(gx, w_hh, reverse)
    _check_cuda_f32("lstm_layer_fwd", (gx, w_hh))
    if gx.dim() != 3 or gx.shape[2] % 4 or w_hh.shape != (gx.shape[2],
                                                         gx.shape[2] // 4):
        raise ValueError(f"lstm_layer_fwd: gx {tuple(gx.shape)} and w_hh "
                         f"{tuple(w_hh.shape)} are not (T, B, 4H), (4H, H)")
    T, B, G = gx.shape
    H = G // 4
    hs = torch.empty((T, B, H), device=gx.device, dtype=torch.float32)
    cs = torch.empty_like(hs)
    # h ping-pong buffer (h_0 = 0) and the step barrier's counter
    hbuf = torch.zeros((2, H, B), device=gx.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
    if T:
        LSTM_FWD(gx.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                 cs.data_ptr(), hbuf.data_ptr(), barrier.data_ptr(), T, B, H,
                 int(reverse), _build.stream_handle(gx.device))
    return hs, cs


def lstm_layer_bwd(gx: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor,
                   cs: torch.Tensor, dhs: torch.Tensor,
                   dc_last: torch.Tensor, reverse: bool = False):
    """K1-bwd: same contract as ``lstm_layer_bwd_ref``. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise. The launch
    refuses an H that is not a multiple of 16 and, as K1-fwd's, one whose
    H/4 blocks cannot all be resident at once, above 528 on an H100."""
    if gx.device.type == "cpu":
        return lstm_layer_bwd_ref(gx, w_hh, hs, cs, dhs, dc_last, reverse)
    _check_cuda_f32("lstm_layer_bwd", (gx, w_hh, hs, cs, dhs, dc_last))
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
    if hs.data_ptr() % 16:
        raise ValueError("lstm_layer_bwd: hs must be 16-byte aligned (the "
                         "kernel reads it as float4)")
    dgx = torch.empty_like(gx)
    dw = torch.zeros((G, H), device=gx.device, dtype=torch.float32)
    if T and B:
        # each block's split-K share of dh_{t-1}, ping-ponged between
        # steps; the dh carry (zero at the start) and the dc carry (from
        # dc_last), each entry touched by one thread only; the step
        # barrier's counter
        part = torch.empty((2, H // 4, B, H), device=gx.device,
                           dtype=torch.float32)
        dh_buf = torch.zeros((B, H), device=gx.device, dtype=torch.float32)
        dc_buf = dc_last.clone()
        barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
        LSTM_BWD(gx.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                 dhs.data_ptr(), dgx.data_ptr(), dw.data_ptr(),
                 part.data_ptr(), dh_buf.data_ptr(), dc_buf.data_ptr(),
                 barrier.data_ptr(), T, B, H, int(reverse),
                 _build.stream_handle(gx.device))
    return dgx, dw


class LSTMRecurrence(torch.autograd.Function):
    """The differentiable recurrence (the JAX package's ``lstm_layer``
    custom VJP): ``apply(gx, w_hh, reverse) -> (hs (T, B, H), c_last
    (B, H))``, c_last being the cell state after the last PROCESSED step
    (t=0 when ``reverse``). Forward is ``lstm_layer_fwd`` and saves
    (w_hh, gx, hs, cs); backward is ``lstm_layer_bwd``. A cotangent that
    autograd leaves undefined is zeros."""

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
