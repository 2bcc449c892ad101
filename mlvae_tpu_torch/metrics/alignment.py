"""Sequence alignment for PER-style scoring (the port's own copy of
``mlvae_tpu/metrics/alignment.py``): a predicted phoneme sequence aligned
to the ground truth by edit distance, the canonical sequence projected
through the alignment, and insertions dropped so that the three sequences
keep one length. Host-side Python."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def edit_alignment(ref: Sequence, hyp: Sequence) -> List[Tuple[str, int, int]]:
    """Levenshtein alignment ops: ('=', i, j), ('S', i, j), ('D', i, None),
    ('I', None, j), in order."""
    n, m = len(ref), len(hyp)
    dist = np.zeros((n + 1, m + 1), np.int64)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            dist[i, j] = min(dist[i - 1, j] + 1, dist[i, j - 1] + 1,
                             dist[i - 1, j - 1] + cost)
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + (
                0 if ref[i - 1] == hyp[j - 1] else 1):
            ops.append(("=" if ref[i - 1] == hyp[j - 1] else "S",
                        i - 1, j - 1))
            i, j = i - 1, j - 1
        elif j > 0 and dist[i, j] == dist[i, j - 1] + 1:
            ops.append(("I", None, j - 1))
            j -= 1
        else:
            ops.append(("D", i - 1, None))
            i -= 1
    ops.reverse()
    return ops


def align_sequences(gt_phn_seq, pred_phn_seq, gt_cnncl_seq,
                    empty_value: int = -1):
    """(gt, pred, cnncl) lists of one length: a substitution keeps both
    sides, a deletion puts ``empty_value`` into pred, an insertion is
    dropped."""
    ops = edit_alignment(list(gt_phn_seq), list(pred_phn_seq))
    gt_out, pred_out, cn_out = [], [], []
    for op, i, j in ops:
        if op == "I":
            continue
        gt_out.append(gt_phn_seq[i])
        cn_out.append(gt_cnncl_seq[i])
        pred_out.append(empty_value if op == "D" else pred_phn_seq[j])
    return gt_out, pred_out, cn_out


def batch_align_sequences(gt_phn_seqs, pred_phn_seqs, gt_cnncl_seqs,
                          empty_value: int = -1):
    gts, preds, cns = [], [], []
    for g, p, c in zip(gt_phn_seqs, pred_phn_seqs, gt_cnncl_seqs):
        go, po, co = align_sequences(g, p, c, empty_value)
        gts.append(go)
        preds.append(po)
        cns.append(co)
    return gts, preds, cns
