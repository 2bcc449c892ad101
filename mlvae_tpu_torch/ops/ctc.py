"""CTC loss, greedy decoding and forced-alignment segmentation (counterpart
of ``mlvae_tpu/ops/ctc.py``).

``ctc_loss`` is the SpeechBrain signature (relative lengths) with torch's
``reduction='mean'``: each utterance's loss divided by its label count,
then the batch averaged. It is always computed in f32. The JAX package
computes it with ``optax.ctc_loss`` outside any Pallas kernel; the port
computes the same forward algorithm with plain torch ops, step for step as
``optax.ctc_loss_with_forward_probs`` does: the inputs normalized again by
a ``log_softmax`` (the recipe feeds log-probabilities, which optax treats
as logits: the value is unchanged, and the gradient with respect to them
is optax's, ``exp(x) - occupancy``), the blank and label states as two
arrays of log-alphas, ``log(0)`` as ``log_epsilon = -1e5`` so that every
value stays finite, and padded frames carrying the previous alphas
through, so that their gradient is exactly 0. An infeasible utterance
(|y| plus its repeated neighbours longer than the input) contributes
loss 0 and gradient 0, as torch's ``zero_infinity=True``. Autograd
differentiates the recursion: it runs the same on the CPU and the card,
its backward is deterministic, and no cuDNN CTC is involved (cuDNN's
CTC, which ``F.ctc_loss`` takes under its conditions, has other numerics,
and ``F.ctc_loss``'s CUDA backward is not deterministic).

``ctc_greedy_decode``, ``ctc_forced_alignment`` and
``ctc_segmentation_boundaries`` are host-side numpy, the port's own copies:
argmax, collapse and drop blanks; a Viterbi over the CTC topology that
returns each label's start frame; and the start frames as a boundary
indicator sequence with the reference's bump-right collision rule.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mlvae_tpu_torch.utils.tensor import abs_lengths

LOG_EPSILON = -1e5   # optax's log(+0)


def _ctc_per_seq(logits: torch.Tensor, logit_pad: torch.Tensor,
                 labels: torch.Tensor, label_pad: torch.Tensor,
                 blank_id: int) -> torch.Tensor:
    """``optax.ctc_loss``: logits (B, T, K) f32, paddings (B, T) and
    (B, N) of 0/1, labels (B, N) int -> (B,) negative log-likelihoods."""
    B, T, K = logits.shape
    N = labels.shape[1]
    eps = LOG_EPSILON
    logprobs = F.log_softmax(logits, dim=-1)
    labellens = N - label_pad.sum(dim=1).to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    lp_phi = logprobs[:, :, blank_id].t()                        # (T, B)
    idx = labels.long()[:, None, :].expand(B, T, N)
    lp_emit = torch.gather(logprobs, 2, idx).transpose(0, 1)     # (T, B, N)
    pads = logit_pad.t()                                          # (T, B)

    phi = torch.full((B, N + 1), eps, dtype=logits.dtype,
                     device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((B, N), eps, dtype=logits.dtype, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=1)

    for t in range(T):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + eps * repeat)
        e, p = lp_emit[t], lp_phi[t][:, None]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e, emit + e)
        next_phi = prev_phi + p
        next_phi = update_phi(next_phi, emit + p + eps * (1.0 - repeat))
        pad = pads[t][:, None]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, labellens[:, None])[:, 0]


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             input_lens: torch.Tensor, target_lens: torch.Tensor,
             blank_index: int = 0, reduction: str = "mean") -> torch.Tensor:
    """CTC of ``log_probs`` (B, T, K) against ``targets`` (B, L), both
    lengths relative (rounded to frames as ``abs_lengths`` rounds them);
    ``reduction`` ``mean`` (torch's), ``batchmean`` or anything else for
    the per-utterance losses."""
    log_probs = log_probs.float()
    B, T, _ = log_probs.shape
    L = targets.shape[1]
    in_abs = abs_lengths(input_lens, T)
    tgt_abs = abs_lengths(target_lens, L)
    dev = log_probs.device
    logit_pad = (torch.arange(T, device=dev)[None, :]
                 >= in_abs[:, None]).float()
    label_pad = (torch.arange(L, device=dev)[None, :]
                 >= tgt_abs[:, None]).float()
    per_seq = _ctc_per_seq(log_probs, logit_pad, targets, label_pad,
                           blank_index)
    valid = 1.0 - label_pad
    repeats = ((targets[:, 1:] == targets[:, :-1]).float()
               * valid[:, 1:]).sum(dim=1)
    feasible = in_abs >= tgt_abs + repeats
    per_seq = torch.where(feasible, per_seq, torch.zeros_like(per_seq))
    if reduction == "mean":
        return torch.mean(per_seq / torch.clamp(tgt_abs, min=1))
    if reduction == "batchmean":
        return torch.mean(per_seq)
    return per_seq


def ctc_greedy_decode(probabilities, seq_lens, blank_id: int = 0
                      ) -> List[List[int]]:
    """Host side: each utterance's argmax over its frames (the relative
    length rounded in f32, as the loss rounds it), repeats collapsed,
    blanks dropped."""
    probs = np.asarray(probabilities)
    T = probs.shape[1]
    lens = np.round(np.asarray(seq_lens, np.float32) * np.float32(T))
    out = []
    for i in range(probs.shape[0]):
        ids = probs[i, :int(lens[i])].argmax(-1)
        out.append([int(x) for j, x in enumerate(ids)
                    if (j == 0 or x != ids[j - 1]) and x != blank_id])
    return out


def ctc_forced_alignment(log_probs: np.ndarray, labels: Sequence[int],
                         blank_id: int = 0) -> np.ndarray:
    """Viterbi alignment of ``labels`` to ``log_probs`` (T, K) over the CTC
    topology (blank, y0, blank, y1, ..., blank; stay, advance, or skip a
    blank between different labels). Returns each label's start frame,
    shape (L,)."""
    y = list(labels)
    L = len(y)
    T = log_probs.shape[0]
    S = 2 * L + 1
    state_label = np.full(S, blank_id, np.int64)
    state_label[1::2] = y

    NEG = -1e30
    dp = np.full(S, NEG)
    dp[0] = log_probs[0, blank_id]
    if S > 1:
        dp[1] = log_probs[0, state_label[1]]
    allow_skip = np.zeros(S, bool)
    allow_skip[1::2] = True
    same = np.zeros(S, bool)
    same[3::2] = state_label[3::2] == state_label[1:-2:2]
    allow_skip &= ~same

    back = np.zeros((T, S), np.int8)  # 0 stay, 1 from s-1, 2 from s-2
    for t in range(1, T):
        stay = dp
        prev1 = np.concatenate([[NEG], dp[:-1]])
        prev2 = np.concatenate([[NEG, NEG], dp[:-2]])
        prev2 = np.where(allow_skip, prev2, NEG)
        cands = np.stack([stay, prev1, prev2])
        best = cands.argmax(0)
        dp = cands.max(0) + log_probs[t, state_label]
        back[t] = best

    s = S - 1 if L == 0 or dp[S - 1] >= dp[S - 2] else S - 2
    starts = np.zeros(L, np.int64)
    path = np.zeros(T, np.int64)
    for t in range(T - 1, -1, -1):
        path[t] = s
        if t > 0:
            s = s - back[t, s]
    for l in range(L):
        idx = np.where(path == 2 * l + 1)[0]
        starts[l] = idx[0] if len(idx) else (starts[l - 1] if l else 0)
    return starts


def ctc_segmentation_boundaries(pout: np.ndarray, labels: Sequence[int],
                                blank_id: int = 0) -> np.ndarray:
    """(T, K) log posteriors and the canonical labels -> a binary boundary
    sequence (T,): the first segment starts at frame 0, and a start that
    collides with an earlier one moves right."""
    T = pout.shape[0]
    starts = ctc_forced_alignment(pout, labels, blank_id)
    boundary = np.zeros(T, np.float32)
    for i, start in enumerate(starts):
        idx = 0 if i == 0 else int(start)
        while idx < T and boundary[idx] == 1:
            idx += 1
        if idx < T:
            boundary[idx] = 1
    return boundary
