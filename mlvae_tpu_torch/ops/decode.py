"""MD Viterbi decoding: joint DP over (phoneme l, frame t, MD state beta).

Counterpart of ``mlvae_tpu/ops/decode.py`` (the batched DP and its numpy
oracle) and ``ops/decode_pallas.py`` (kernels K2-lattice and
K2-backtrace, one kernel here: ``csrc/md_viterbi.cu``, one launch a
decode). Recurrence, with ``b`` the MD state:

    e[t, l, b]   = log p(y_l | x_t)[b] - log p(y_l)[b]
    dp[0, 0, b]  = w * log_pi[0, b] + e[0, 0, b]
    dp[l, t, b]  = max( (dp[l, t-1, b] + log_pb[t, 0]) + e,            hold
                        dp[l-1, t-1, 0] + ((log_pb[t, 1] + w*log_pi[t, b]) + e),
                        dp[l-1, t-1, 1] + ((log_pb[t, 1] + w*log_pi[t, b]) + e) )

Candidate order is (hold, from-correct, from-incorrect) and the first
maximum wins; ``NEG_INF = -1e30``; steps with ``t >= t_len`` are masked;
when both end states tie the backtrace starts from beta 1. Every version
here is bit-exact against the others and against the JAX package.

``log_pb[..., 0]`` is log p(boundary) and scores the *hold* transition: a
deliberate parity with the reference decoder (see the JAX module).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from mlvae_tpu_torch import _build

LOG_EPS = 1e-5
NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int

VITERBI = _build.register(_build.Kernel(
    "md_viterbi", "md_viterbi", "mlvae_md_viterbi",
    [_P] * 12 + [_I] * 4 + [_P]))

# the kernel's launch plan (``make_plan`` in csrc/md_viterbi.cu)
MAX_L = 512              # phonemes a row: 16 carry slots a lane
RING_FLOATS = 4096       # one half of the emissions' ring
MAX_CHUNK = 32           # steps a half holds at most
CHOICE_BYTES = 64 * 1024  # the choices stay in shared memory up to this


def viterbi_plan(T: int, L: int) -> dict:
    """What K2's launch takes at T steps and L phonemes, as the kernel
    computes it: carry slots a lane (ceil(L / 32) rounded up to a power of
    2, the build), steps a half of the ring holds, whether the (T, L, 2)
    int8 choices stay in shared memory for the backtrace ("shared") or
    are read back from global memory ("global"), and the shared memory
    bytes (the ring, y, the backtrace's two bits a step, the choices where
    kept). Refuses (``ValueError``) L above 512."""
    if T < 1 or not 1 <= L <= MAX_L:
        raise ValueError(f"K2 takes T >= 1 and 1 to {MAX_L} phonemes, not "
                         f"T={T}, L={L}")
    slots = 1
    while slots < -(-L // 32):
        slots *= 2
    step = 2 * L + 4
    chunk = min(MAX_CHUNK, RING_FLOATS // step)
    shared = 2 * T * L <= CHOICE_BYTES
    words = -(-T // 128) * 4       # a bit a step, whole 16 bytes
    smem = 4 * (2 * chunk * step + -(-L // 4) * 4 + 2 * words) \
        + (-(-2 * T * L // 16) * 16 if shared else 0)
    return {"slots": slots, "chunk": chunk,
            "choices": "shared" if shared else "global", "smem_bytes": smem}


def viterbi_launch_plan(T: int, L: int) -> dict:
    """``viterbi_plan`` as the kernel's ``mlvae_md_viterbi_plan`` entry
    point computes it, with the build's registers and local memory bytes
    a thread. Builds the library; needs the card. Not a launch: it counts
    nowhere."""
    fn = getattr(_build.library(VITERBI.source), "mlvae_md_viterbi_plan")
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    code = fn(T, L, out)
    if code:
        raise RuntimeError(f"md_viterbi plan: CUDA error {code}")
    return {"slots": out[0], "chunk": out[1],
            "choices": "shared" if out[2] else "global",
            "smem_bytes": out[3], "registers": out[4],
            "local_bytes": out[5]}


def clamped_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=LOG_EPS))


def clamped_log_np(x):
    return np.log(np.maximum(x, LOG_EPS))


def build_viterbi_inputs(phn_out, boundary_v, pi_logits, prior):
    """Sigmoid posteriors, prior, boundary and pi as [p, 1-p] pairs,
    clamp-logged at 1e-5 (``mlvae_tpu/ops/decode.py`` of the same name)."""
    p = torch.sigmoid(phn_out)
    log_p_yx = clamped_log(torch.stack([p, 1 - p], dim=3))
    log_p_y = clamped_log(torch.stack([prior, 1 - prior], dim=1))
    log_p_b = clamped_log(torch.stack([boundary_v, 1 - boundary_v], dim=2))
    log_p_pi = clamped_log(torch.softmax(pi_logits, dim=-1))
    return log_p_yx, log_p_y, log_p_b, log_p_pi


def _emissions(log_p_yx, log_p_y, y):
    """e (B, T, L, 2): the canonical phonemes' log posteriors over prior."""
    B, T, N, _ = log_p_yx.shape
    L = y.shape[1]
    idx = y.long()[:, None, :, None].expand(B, T, L, 2)
    sel = torch.gather(log_p_yx, 2, idx)
    return sel - log_p_y[y.long()][:, None, :, :]


def md_viterbi_lattice_ref(log_p_yx, log_p_y, y, log_p_b, lpi_w, t_lens,
                           l_lens):
    """Plain forward lattice (the work of K2-lattice): ``lpi_w`` is log pi
    with the weight folded in. Returns (paths (T, B, L, 2) int64 choices,
    beta0 (B,) the starting MD state of the backtrace)."""
    B, T, N, _ = log_p_yx.shape
    L = y.shape[1]
    dev = log_p_yx.device
    e = _emissions(log_p_yx, log_p_y, y)                 # (B, T, L, 2)
    l_idx = torch.arange(L, device=dev)[None, :, None]
    dp = torch.where(l_idx == 0, lpi_w[:, 0][:, None, :] + e[:, 0],
                     torch.full((), NEG_INF, device=dev))  # (B, L, 2)
    neg = torch.full((B, 1, 2), NEG_INF, device=dev)
    paths = torch.zeros((T, B, L, 2), dtype=torch.int64, device=dev)
    for t in range(1, T):
        e_t = e[:, t]
        hold = dp + log_p_b[:, t, None, 0:1] + e_t
        prev = torch.cat([neg, dp[:, :-1]], dim=1)
        sw = log_p_b[:, t, None, 1:2] + lpi_w[:, t, None, :] + e_t
        fc = prev[..., 0:1] + sw
        fi = prev[..., 1:2] + sw
        new = torch.maximum(hold, torch.maximum(fc, fi))
        path = torch.where((hold >= fc) & (hold >= fi), 0,
                           torch.where(fc >= fi, 1, 2))
        valid = (t < t_lens)[:, None, None]
        dp = torch.where(valid, new, dp)
        paths[t] = torch.where(valid, path, 0)
    d_last = dp[torch.arange(B, device=dev), l_lens.long() - 1]
    return paths, torch.where(d_last[:, 0] > d_last[:, 1], 0, 1)


def md_viterbi_backtrace_ref(paths, beta0, t_lens, l_lens):
    """Plain backtrace (the work of K2-backtrace) over the lattice's
    choices. Returns (boundary (B, T), flvl_md (B, T), plvl_md (B, L))."""
    T, B, L, _ = paths.shape
    dev = beta0.device
    b_idx = torch.arange(B, device=dev)
    lanes = torch.arange(L, device=dev)[None, :]
    last_l = l_lens.long() - 1
    plvl = torch.where(lanes == last_l[:, None], beta0[:, None], 0)
    boundary = torch.zeros((B, T), dtype=torch.int64, device=dev)
    flvl = torch.zeros((B, T), dtype=torch.int64, device=dev)
    l_cur, beta, md = last_l.clone(), beta0.clone(), beta0.clone()
    for t in range(T - 1, 0, -1):
        # a slot outside [0, L) reads as "hold" (see csrc/md_viterbi.cu)
        inside = (l_cur >= 0) & (l_cur < L)
        p = torch.where(inside, paths[t, b_idx, l_cur.clamp(0, L - 1), beta],
                        0)
        is_b = (p > 0).long()
        new_md = torch.where(p == 1, 0, torch.where(p == 2, 1, md))
        l_cur = l_cur - is_b
        beta = torch.where(is_b == 1, new_md, beta)
        plvl = torch.where((is_b == 1)[:, None] & (lanes == l_cur[:, None]),
                           new_md[:, None], plvl)
        boundary[:, t] = is_b
        flvl[:, t - 1] = new_md
        md = new_md
    boundary[:, 0] = 1
    flvl[b_idx, t_lens.long() - 1] = beta0
    return boundary.int(), flvl.int(), plvl.int()


def fold_weight(log_p_pi, weight):
    """w * log pi, computed once outside the lattice as the TPU wrapper
    does (the same f32 product the JAX scan forms at every step)."""
    return log_p_pi * torch.full((), weight, dtype=torch.float32,
                                 device=log_p_pi.device)


def md_viterbi_batch_ref(log_p_yx, log_p_y, y, log_p_b, log_p_pi, t_lens,
                         l_lens, weight=1.0):
    """Plain batched decode. Shapes: log_p_yx (B, T, N, 2), log_p_y (N, 2),
    y (B, L) int, log_p_b / log_p_pi (B, T, 2), t_lens / l_lens (B,) int.
    Returns (boundary (B, T), flvl_md (B, T), plvl_md (B, L)), int32."""
    dev = log_p_yx.device
    log_p_yx, log_p_y, log_p_b, log_p_pi = (
        a.float() for a in (log_p_yx, log_p_y, log_p_b, log_p_pi))
    t_lens = t_lens.to(dev, torch.int64)
    l_lens = l_lens.to(dev, torch.int64)
    paths, beta0 = md_viterbi_lattice_ref(log_p_yx, log_p_y, y, log_p_b,
                                          fold_weight(log_p_pi, weight),
                                          t_lens, l_lens)
    return md_viterbi_backtrace_ref(paths, beta0, t_lens, l_lens)


def md_viterbi_batch_cuda(log_p_yx, log_p_y, y, log_p_b, log_p_pi, t_lens,
                          l_lens, weight=1.0):
    """K2 on the card, one launch; the contract of ``md_viterbi_batch_ref``.
    Raises on what the kernel does not take (L above 512, float inputs
    not 8-byte aligned)."""
    B, T, N, two = log_p_yx.shape
    L = y.shape[1]
    dev = log_p_yx.device
    if dev.type != "cuda" or two != 2:
        raise ValueError(f"md_viterbi_batch_cuda: log_p_yx "
                         f"{tuple(log_p_yx.shape)} on {dev}; needs "
                         "(B, T, N, 2) on a CUDA device")
    floats = {"log_p_yx": log_p_yx, "log_p_y": log_p_y, "log_p_b": log_p_b,
              "log_p_pi": log_p_pi}
    shapes = {"log_p_y": (N, 2), "log_p_b": (B, T, 2), "log_p_pi": (B, T, 2)}
    for name, a in floats.items():
        if a.device != dev or a.dtype != torch.float32 \
                or not a.is_contiguous() or a.data_ptr() % 8:
            raise ValueError(f"md_viterbi_batch_cuda: {name} must be a "
                             f"contiguous, 8-byte aligned f32 tensor on "
                             f"{dev}")
        if name in shapes and tuple(a.shape) != shapes[name]:
            raise ValueError(f"md_viterbi_batch_cuda: {name} is "
                             f"{tuple(a.shape)}, expected {shapes[name]}")
    if tuple(y.shape) != (B, L) or tuple(t_lens.shape) != (B,) \
            or tuple(l_lens.shape) != (B,):
        raise ValueError("md_viterbi_batch_cuda: y must be (B, L) and the "
                         "lengths (B,)")
    viterbi_plan(T, L)
    y32 = y.to(dev, torch.int32).contiguous()
    t32 = t_lens.to(dev, torch.int32).contiguous()
    l32 = l_lens.to(dev, torch.int32).contiguous()
    # the weight scales every lpi use: fold it in here, outside the kernel
    lpi_w = fold_weight(log_p_pi, weight).contiguous()
    return md_viterbi_cuda(log_p_yx, log_p_y, y32, log_p_b, lpi_w, t32,
                           l32)[:3]


def md_viterbi_cuda(log_p_yx, log_p_y, y32, log_p_b, lpi_w, t32, l32):
    """K2 on checked, contiguous inputs (int32 ``y32``, ``t32``, ``l32``;
    ``lpi_w`` weighted), one launch. Returns (boundary (B, T), flvl_md
    (B, T), plvl_md (B, L), int32; the lattice's choices paths (B, T, L,
    2) int8 and beta0 (B,) int32)."""
    B, T, N, _ = log_p_yx.shape
    L = y32.shape[1]
    dev = y32.device
    paths = torch.empty((B, T, L, 2), dtype=torch.int8, device=dev)
    beta0 = torch.empty((B,), dtype=torch.int32, device=dev)
    boundary = torch.empty((B, T), dtype=torch.int32, device=dev)
    flvl = torch.empty((B, T), dtype=torch.int32, device=dev)
    plvl = torch.empty((B, L), dtype=torch.int32, device=dev)
    VITERBI(log_p_yx.data_ptr(), log_p_y.data_ptr(), y32.data_ptr(),
            log_p_b.data_ptr(), lpi_w.data_ptr(), t32.data_ptr(),
            l32.data_ptr(), paths.data_ptr(), beta0.data_ptr(),
            boundary.data_ptr(), flvl.data_ptr(), plvl.data_ptr(), B, T, N,
            L, _build.stream_handle(dev))
    return boundary, flvl, plvl, paths, beta0


def md_viterbi_lattice_cuda(log_p_yx, log_p_y, y32, log_p_b, lpi_w, t32,
                            l32):
    """K2's lattice outputs, the contract of K2-lattice: (paths (B, T, L,
    2) int8, beta0 (B,) int32), from one launch of ``md_viterbi_cuda``."""
    return md_viterbi_cuda(log_p_yx, log_p_y, y32, log_p_b, lpi_w, t32,
                           l32)[3:]


def md_viterbi_batch(log_p_yx, log_p_y, y, log_p_b, log_p_pi, t_lens,
                     l_lens, weight=1.0):
    """Batched decode: the kernels for CUDA tensors, the plain version for
    CPU tensors."""
    if log_p_yx.device.type == "cpu":
        return md_viterbi_batch_ref(log_p_yx, log_p_y, y, log_p_b, log_p_pi,
                                    t_lens, l_lens, weight)
    return md_viterbi_batch_cuda(log_p_yx, log_p_y, y, log_p_b, log_p_pi,
                                 t_lens, l_lens, weight)


def md_viterbi_np(log_p_yx, log_p_y, y, log_p_b, log_p_pi, T_i, L_i,
                  weight=1.0):
    """Single-utterance numpy oracle; same recurrence and tie-breaking.
    Returns (boundary (T_i,), flvl (T_i,), plvl (L_i,))."""
    y = np.asarray(y[:L_i], np.int64)
    e = log_p_yx[:T_i, y, :] - log_p_y[y][None]  # (T, L, 2)
    dp = np.full((L_i, 2), -np.inf)
    dp[0] = weight * log_p_pi[0] + e[0, 0]
    paths = np.zeros((T_i, L_i, 2), np.int8)
    for t in range(1, T_i):
        hold = dp + log_p_b[t, 0] + e[t]
        prev = np.vstack([np.full((1, 2), -np.inf), dp[:-1]])
        switch_base = log_p_b[t, 1] + weight * log_p_pi[t][None, :] + e[t]
        from_c = prev[:, 0:1] + switch_base
        from_i = prev[:, 1:2] + switch_base
        cands = np.stack([hold, from_c, from_i], axis=0)
        dp = cands.max(axis=0)
        paths[t] = cands.argmax(axis=0)

    l, t = L_i - 1, T_i - 1
    beta = 0 if dp[l, 0] > dp[l, 1] else 1
    boundary_idx = []
    flvl = [beta]
    plvl = [beta]
    while t > 0:
        p = paths[t, l, beta]
        if p == 1:
            l -= 1
            boundary_idx.append(t)
            flvl.append(0)
            plvl.append(0)
            beta = 0
        elif p == 2:
            l -= 1
            boundary_idx.append(t)
            flvl.append(1)
            plvl.append(1)
            beta = 1
        else:
            flvl.append(flvl[-1])
        t -= 1
    boundary_idx.append(0)
    if l != 0 or t != 0:
        raise ValueError(f"backtrace ended at l={l}, t={t}, not at 0, 0")
    flvl.reverse()
    plvl.reverse()
    boundary = np.zeros(T_i, np.int64)
    boundary[boundary_idx] = 1
    return boundary, np.asarray(flvl), np.asarray(plvl)
