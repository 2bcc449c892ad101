"""The K-unrolled LSTM forwards (K7a, K7b), their plain PyTorch versions,
and the checks of their wrappers: the port's counterpart of the JAX
package's ``ops/lstm_unroll_exp.py``, an experiment that processes K
consecutive time steps per iteration of the recurrence.

- ``run_fwd_k`` (K7a, ``csrc/lstm_unroll_fwd.cu``): K1-fwd's recurrence
  over precomputed gates, gx (T, B, 4H) and W_hh (4H, H) in f32 or bf16,
  with the gates of K steps staged at once. The result does not depend on
  K; in f32 it is bit-identical to K1-fwd (``ops.lstm.lstm_layer_fwd``),
  and in bf16 its K=1 is the one-step twin of the plain arm.
- ``run_fwd_fused_k`` (K7b): K3/K4-fwd's recurrence with the input
  projection inside, x (T, B, In), W_ih (4H, In) and W_hh in one stream
  dtype and an f32 bias, the input products of K steps formed ahead of
  their barriers; bit-identical to K3/K4-fwd (``ops.lstm.lstm_fused_fwd``)
  of its dtype. bf16 streams run ``csrc/lstm_unroll_fused_fwd.cu``; f32
  streams the K entry point of K3/K4-fwd's f32 build
  (``csrc/lstm_fused_fwd_f32.cu``), registered as its own kernel.

Both are forward only, as the JAX module is. The contract is the JAX one:
T a multiple of K (else ``ValueError``, on every device), hs in the stream
dtype and cs f32, zero initial state, ``reverse`` processing t = T-1 .. 0
with outputs in natural time order. CPU tensors take the plain versions;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops.lstm import (_check_fused, lstm_fused_fwd_ref,
                                      lstm_layer_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int

LSTM_UNROLL_FWD = _build.register(_build.Kernel(
    "lstm_unroll_fwd", "lstm_unroll_fwd", "mlvae_lstm_unroll_fwd",
    [_P] * 6 + [_I] * 6 + [_P]))
LSTM_UNROLL_FUSED_FWD = _build.register(_build.Kernel(
    "lstm_unroll_fused_fwd", "lstm_unroll_fused_fwd",
    "mlvae_lstm_unroll_fused_fwd", [_P] * 7 + [_I] * 6 + [_P]))
LSTM_UNROLL_FUSED_FWD_F32 = _build.register(_build.Kernel(
    "lstm_unroll_fused_fwd_f32", "lstm_fused_fwd_f32",
    "mlvae_lstm_unroll_fused_fwd_f32", [_P] * 8 + [_I] * 6 + [_P]))


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


def check_fwd_k(gx: torch.Tensor, w_hh: torch.Tensor, K: int) -> None:
    """K7a's inputs: one CUDA device, gx and w_hh both f32 or both bf16,
    contiguous, (T, B, 4H) and (4H, H) with T a multiple of K, gx aligned
    for the kernel's 16-byte (f32) or 8-byte (bf16) copies."""
    _check_k(gx.shape[0], K)
    dev = gx.device
    if dev.type != "cuda" or w_hh.device != dev:
        raise ValueError(f"run_fwd_k: tensors on {gx.device} and "
                         f"{w_hh.device}; both must be on one CUDA device")
    if gx.dtype not in (torch.float32, torch.bfloat16) \
            or w_hh.dtype != gx.dtype:
        raise ValueError(f"run_fwd_k: gx and w_hh must be both f32 or both "
                         f"bf16 (got {gx.dtype}, {w_hh.dtype})")
    if not (gx.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("run_fwd_k: every tensor must be contiguous")
    if gx.dim() != 3 or gx.shape[2] % 4 or w_hh.shape != (gx.shape[2],
                                                         gx.shape[2] // 4):
        raise ValueError(f"run_fwd_k: gx {tuple(gx.shape)} and w_hh "
                         f"{tuple(w_hh.shape)} are not (T, B, 4H), (4H, H)")
    if gx.data_ptr() % (4 * gx.element_size()):
        raise ValueError("run_fwd_k: gx must be aligned to four elements")


def run_fwd_k(gx: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
              K: int = 2):
    """K7a: same contract as ``run_fwd_k_ref``. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. The launch refuses an
    H that is not a multiple of 16, one whose H/4 blocks cannot all be
    resident at once (above 528 on an H100's 132 SMs), and a (K, B, H)
    whose one group of staged gates does not fit in shared memory."""
    if gx.device.type == "cpu":
        return run_fwd_k_ref(gx, w_hh, reverse, K)
    check_fwd_k(gx, w_hh, K)
    T, B, G = gx.shape
    H = G // 4
    hs = torch.empty((T, B, H), device=gx.device, dtype=gx.dtype)
    cs = torch.empty((T, B, H), device=gx.device, dtype=torch.float32)
    # h ping-pong buffer (h_0 = 0) and the step barrier's counter
    hbuf = torch.zeros((2, H, B), device=gx.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=gx.device, dtype=torch.int32)
    if T and B:
        LSTM_UNROLL_FWD(gx.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                        cs.data_ptr(), hbuf.data_ptr(), barrier.data_ptr(),
                        T, B, H, K, int(gx.dtype == torch.bfloat16),
                        int(reverse), _build.stream_handle(gx.device))
    return hs, cs


def check_fwd_fused_k(x, w_ih, bias, w_hh, K: int):
    """K7b's inputs: T a multiple of K, then K3/K4-fwd's checks
    (``ops.lstm._check_fused``). Returns the stream dtype."""
    _check_k(x.shape[0], K)
    return _check_fused("run_fwd_fused_k", x, w_ih, bias, w_hh)


def run_fwd_fused_k(x: torch.Tensor, w_ih: torch.Tensor, bias: torch.Tensor,
                    w_hh: torch.Tensor, reverse: bool = False, K: int = 2):
    """K7b: same contract as ``run_fwd_fused_k_ref``. CPU tensors take the
    plain version; CUDA tensors launch the build of the stream dtype or
    raise. As K3/K4-fwd, the H/4 blocks must all be resident at once
    (H <= 528 on an H100)."""
    if x.device.type == "cpu":
        return run_fwd_fused_k_ref(x, w_ih, bias, w_hh, reverse, K)
    dtype = check_fwd_fused_k(x, w_ih, bias, w_hh, K)
    T, B, In = x.shape
    H = w_hh.shape[1]
    hs = torch.empty((T, B, H), device=x.device, dtype=dtype)
    cs = torch.empty((T, B, H), device=x.device, dtype=torch.float32)
    barrier = torch.zeros((1,), device=x.device, dtype=torch.int32)
    if not (T and B):
        return hs, cs
    stream = _build.stream_handle(x.device)
    if dtype == torch.float32:
        # the input products of a group of K steps, each cell thread's own
        xg = torch.empty((K, B, 4 * H), device=x.device, dtype=torch.float32)
        LSTM_UNROLL_FUSED_FWD_F32(
            x.data_ptr(), w_ih.data_ptr(), bias.data_ptr(), w_hh.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), xg.data_ptr(), barrier.data_ptr(),
            T, B, In, H, K, int(reverse), stream)
    else:
        LSTM_UNROLL_FUSED_FWD(x.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
                              w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                              barrier.data_ptr(), T, B, In, H, K,
                              int(reverse), stream)
    return hs, cs
