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

``gru_layer_fwd`` / ``gru_layer_bwd`` run ``csrc/gru_fwd.cu`` /
``csrc/gru_bwd.cu`` for CUDA tensors and ``gru_layer_ref`` /
``gru_layer_bwd_ref`` for CPU tensors only; ``GRURecurrence`` joins them.
"""
from __future__ import annotations

import ctypes

import torch

from mlvae_tpu_torch import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

GRU_FWD = _build.register(_build.Kernel(
    "gru_fwd", "gru_fwd", "mlvae_gru_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]))
GRU_BWD = _build.register(_build.Kernel(
    "gru_bwd", "gru_bwd", "mlvae_gru_bwd",
    [_P] * 12 + [_I, _I, _I, _I, _I, _P]))

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
                      hs32, dhs: torch.Tensor, reverse: bool = False):
    """Plain BPTT (the work of K5-bwd): the forward's inputs, its hs (and
    hs32 under bf16), the cotangents dhs (T, B, H) -> (dgx (T, B, 3H) in
    gx's dtype, dW_hh (3H, H) f32, db_hh (3H,) f32).

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
        dh = dh * z + dgh_w @ w
        dw += dgh_w.t() @ h_prev
        db += dgh.sum(0)
    return dgx, dw, db


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
    plain version; CUDA tensors launch the kernel or raise. The launch
    refuses an H whose H/4 blocks cannot all be resident at once (above
    528 on an H100's 132 SMs)."""
    if gx.device.type == "cpu":
        return gru_layer_ref(gx, w_hh, b_hh, reverse)
    _check("gru_layer_fwd", gx, w_hh, b_hh)
    T, B, G = gx.shape
    H = G // 3
    bf16 = gx.dtype == torch.bfloat16
    hs = torch.empty((T, B, H), device=gx.device, dtype=gx.dtype)
    hs32 = torch.empty((T, B, H), device=gx.device,
                       dtype=torch.float32) if bf16 else None
    if T and B:
        # h ping-pong buffer (h_0 = 0) and the step barrier's counter
        hbuf = torch.zeros((2, H, B), device=gx.device, dtype=torch.float32)
        barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
        GRU_FWD(gx.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                hs.data_ptr(), hs32.data_ptr() if bf16 else None,
                hbuf.data_ptr(), barrier.data_ptr(), T, B, H, int(reverse),
                int(bf16), _build.stream_handle(gx.device))
    return hs, hs32


def gru_layer_bwd(gx: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  hs: torch.Tensor, hs32, dhs: torch.Tensor,
                  reverse: bool = False):
    """K5-bwd: same contract as ``gru_layer_bwd_ref``. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
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
    dgx = torch.empty_like(gx)
    dw = torch.zeros((G, H), device=gx.device, dtype=torch.float32)
    db = torch.zeros((G,), device=gx.device, dtype=torch.float32)
    if T and B:
        # each block's split-K share of dgh @ W_hh, ping-ponged between
        # steps; the dh carry (zero at the start), each entry touched by one
        # thread only; the step barrier's counter
        part = torch.empty((2, H // 4, B, H), device=gx.device,
                           dtype=torch.float32)
        dh_buf = torch.zeros((B, H), device=gx.device, dtype=torch.float32)
        barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
        GRU_BWD(gx.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                hs.data_ptr(), hs32.data_ptr() if bf16 else None,
                dhs.data_ptr(), dgx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                part.data_ptr(), dh_buf.data_ptr(), barrier.data_ptr(),
                T, B, H, int(reverse), int(bf16),
                _build.stream_handle(gx.device))
    return dgx, dw, db


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
