"""HMM forced aligner (counterpart of ``mlvae_tpu/modules/hmm_aligner.py``;
YAML alias of ``speechbrain.alignment.aligner.HMMAligner`` as the
HMM_DNN_ALI recipe uses it).

A left-to-right HMM with ``states_per_phoneme`` states a phoneme and
stay/advance transitions:

* ``forward_score``, the differentiable training loss, is the forward
  algorithm's log-sum-exp recursion in torch ops, one step a frame over
  the whole batch, whose gradient autograd forms;
* ``viterbi`` (targets and diagnostics, no gradient) is the host-side
  numpy max-product with backtracking, copied from the JAX module, with
  the alignment store of the viterbi-training round trip
  (``store_alignments``, ``get_prev_alignments``) and ``calc_accuracy``.

No TPU kernel computes any of it (the JAX module's recursion is a
``lax.scan``), so none is ported.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from mlvae_tpu_torch.utils.tensor import to_host

NEG = -1e30


def _abs_lengths_np(rel_lens, max_len: int) -> np.ndarray:
    """Host-side ``abs_lengths``: f32 product, rounded half to even."""
    return np.round(np.asarray(to_host(rel_lens), np.float32)
                    * np.float32(max_len)).astype(np.int32)


class HMMAligner:
    def __init__(self, states_per_phoneme: int = 3,
                 batch_reduction: str = "mean",
                 input_len_norm: bool = True,
                 target_len_norm: bool = False,
                 hop_samples: int = 320, **kwargs):
        self.states_per_phoneme = int(states_per_phoneme)
        self.batch_reduction = batch_reduction
        self.input_len_norm = input_len_norm
        self.target_len_norm = target_len_norm
        # frame hop in samples for calc_accuracy's end -> frame conversion
        # (20 ms at 16 kHz)
        self.hop_samples = int(hop_samples)
        self.align_dict: Dict[str, np.ndarray] = {}

    # -- state expansion ----------------------------------------------------
    def expand_phns_by_states_per_phoneme(self, phns, phn_lens=None):
        """(B, L) phoneme ids -> (B, L*S) HMM state ids (p*S .. p*S+S-1):
        a tensor for a tensor, a numpy array otherwise."""
        S = self.states_per_phoneme
        if isinstance(phns, torch.Tensor):
            states = phns.long()[:, :, None] * S + torch.arange(
                S, device=phns.device)
            return states.reshape(phns.shape[0], -1)
        phns = np.asarray(phns, np.int64)
        return (phns[:, :, None] * S + np.arange(S)).reshape(phns.shape[0],
                                                             -1)

    # -- forward / viterbi --------------------------------------------------
    def __call__(self, pout, pout_lens, states, state_rel_lens, mode):
        if mode == "forward":
            return self.forward_score(pout, pout_lens, states, state_rel_lens)
        if mode == "viterbi":
            return self.viterbi(pout, pout_lens, states, state_rel_lens)
        raise ValueError(f"unknown mode: {mode}")

    def _reduce(self, scores):
        if self.batch_reduction == "mean":
            return scores.mean()
        if self.batch_reduction == "sum":
            return scores.sum()
        return scores

    def forward_score(self, pout: torch.Tensor, pout_lens: torch.Tensor,
                      states: torch.Tensor,
                      state_rel_lens: torch.Tensor) -> torch.Tensor:
        """The batch's forward-algorithm log-likelihood of ``states`` under
        (B, T, K) log-posteriors ``pout``, per ``batch_reduction``. An
        utterance's alpha stops moving after its last frame; its score is
        alpha at its last state, divided by its frames
        (``input_len_norm``) and its states (``target_len_norm``)."""
        B, T, _ = pout.shape
        Smax = states.shape[1]
        S = self.states_per_phoneme
        dev = pout.device
        t_lens = torch.round(pout_lens.float() * T).to(torch.int32)
        s_lens = torch.round(state_rel_lens.float() * (Smax // S)).to(
            torch.int32) * S
        # log p(state s emits frame t), (B, T, Smax)
        emis = torch.gather(pout, 2, states.long().to(dev)[:, None, :]
                            .expand(B, T, Smax))
        first = torch.arange(Smax, device=dev)[None, :] == 0
        alpha = torch.where(first, emis[:, 0],
                            torch.full_like(emis[:, 0], NEG))
        neg = torch.full((B, 1), NEG, dtype=pout.dtype, device=dev)
        valid = torch.arange(T, device=dev)[None, :] < t_lens[:, None]
        for t in range(1, T):
            prev = torch.cat([neg, alpha[:, :-1]], dim=1)
            new = torch.logaddexp(alpha, prev) + emis[:, t]
            alpha = torch.where(valid[:, t:t + 1], new, alpha)
        scores = torch.gather(alpha, 1, (s_lens - 1).long()[:, None])[:, 0]
        if self.input_len_norm:
            scores = scores / t_lens
        if self.target_len_norm:
            scores = scores / torch.clamp(s_lens, min=1)
        return self._reduce(scores)

    def viterbi(self, pout, pout_lens, states, state_rel_lens):
        """Host-side max-product alignment. Returns (scores, alignments):
        each utterance's best path of HMM state ids, cut to its length."""
        pout = to_host(pout)
        states = to_host(states)
        B, T, _ = pout.shape
        S = self.states_per_phoneme
        t_lens = _abs_lengths_np(pout_lens, T)
        s_lens = _abs_lengths_np(state_rel_lens, states.shape[1] // S) * S

        scores = np.zeros(B, np.float32)
        alignments: List[np.ndarray] = []
        for b in range(B):
            T_b, S_b = int(t_lens[b]), int(s_lens[b])
            st = states[b, :S_b]
            emis = pout[b, :T_b][:, st]  # (T_b, S_b)
            dp = np.full(S_b, NEG)
            dp[0] = emis[0, 0]
            back = np.zeros((T_b, S_b), np.int8)
            for t in range(1, T_b):
                prev = np.concatenate([[NEG], dp[:-1]])
                adv = prev > dp
                back[t] = adv.astype(np.int8)
                dp = np.where(adv, prev, dp) + emis[t]
            s = S_b - 1
            path = np.zeros(T_b, np.int64)
            for t in range(T_b - 1, -1, -1):
                path[t] = st[s]
                if t > 0:
                    s -= int(back[t, s])
            score = dp[S_b - 1]
            if self.input_len_norm:
                score = score / max(T_b, 1)
            if self.target_len_norm:
                score = score / max(S_b, 1)
            scores[b] = score
            alignments.append(path)
        if self.batch_reduction == "mean":
            red = np.mean(scores)
        elif self.batch_reduction == "sum":
            red = np.sum(scores)
        else:
            red = scores
        return red, alignments

    # -- the alignment store (viterbi training) ------------------------------
    def store_alignments(self, ids, alignments):
        for utt_id, ali in zip(ids, alignments):
            self.align_dict[utt_id] = np.asarray(ali)

    def get_prev_alignments(self, ids, pout, pout_lens, states, state_lens):
        """The stored alignments as (B, T) NLL targets; an utterance not
        aligned yet gets the uniform left-to-right split of its states."""
        B, T = np.shape(pout)[:2]
        t_lens = _abs_lengths_np(pout_lens, T)
        states = to_host(states)
        S = self.states_per_phoneme
        s_lens = _abs_lengths_np(state_lens, states.shape[1] // S) * S
        out = np.zeros((B, T), np.int64)
        for b, utt_id in enumerate(ids):
            T_b, S_b = int(t_lens[b]), int(s_lens[b])
            if utt_id in self.align_dict:
                ali = self.align_dict[utt_id][:T_b]
            else:
                idx = np.minimum((np.arange(T_b) * S_b) // max(T_b, 1),
                                 S_b - 1)
                ali = states[b, idx]
            out[b, :len(ali)] = ali
        return out

    # -- the accuracy metric ------------------------------------------------
    def calc_accuracy(self, alignments, ends, phns):
        """Each utterance's frame accuracy (in %) of the aligned phonemes
        against the true segmentation (ends in samples, converted to
        frames with ``hop_samples``)."""
        S = self.states_per_phoneme
        hop = self.hop_samples
        accs = []
        for ali, end_seq, phn_seq in zip(alignments, ends, phns):
            ali = np.asarray(ali)
            T = len(ali)
            aligned_phn = ali // S
            gt = np.zeros(T, np.int64)
            end_frames = [min(int(e) // hop, T) for e in np.asarray(end_seq)]
            start = 0
            for phn, end in zip(np.asarray(phn_seq).reshape(-1), end_frames):
                gt[start:end] = int(phn)
                start = end
            accs.append(float((aligned_phn == gt).mean()) * 100
                        if T else 0.0)
        return accs
