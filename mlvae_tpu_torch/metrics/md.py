"""Mispronunciation-detection scoring (the port's own copy of
``mlvae_tpu/metrics/md.py``).

It keeps the reference's INVERTED counting convention: TP counts matching
zeros (correct pronunciations), while PRE, REC and F1 are computed over
the ones (mispronunciations, counted as TN, FN and FP in that scheme). F1
is recomputed from the MEAN precision and recall at summarize time. Also
the IOU-weighted soft scores against the decoded boundaries, the
per-class PER split, the saved sequences and the results-table writer.
Host-side numpy, on trimmed per-utterance sequences.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from mlvae_tpu_torch.metrics.base import BaseMetricStats

EPS = 1e-6


def _to_binary_array(x, name="input"):
    x = np.asarray(x).astype(np.int64).squeeze()
    x = np.atleast_1d(x)
    if x.ndim > 1:
        raise ValueError(f"{name}: only one-dimension input is allowed")
    if not np.all((x == 0) | (x == 1)):
        raise ValueError(f"{name}: only binary input values are supported")
    return x


def binary_seq_md_scoring(prediction, target) -> Dict[str, float]:
    prediction = _to_binary_array(prediction, "prediction")
    target = _to_binary_array(target, "target")
    if len(prediction) != len(target):
        raise ValueError(
            f"Inconsistent lengths: {len(prediction)} != {len(target)}"
        )
    # reference's inverted convention: TP = matching zeros, TN = matching ones
    TP = float(np.sum((1 - prediction) * (1 - target)))
    TN = float(np.sum(prediction * target))
    FP = float(np.sum((1 - prediction) * target))
    FN = float(np.sum(prediction * (1 - target)))
    ACC = (TP + TN) / (TP + TN + FP + FN + EPS) * 100
    PRE = TN / (TN + FN + EPS) * 100
    REC = TN / (TN + FP + EPS) * 100
    F1 = 2 * PRE * REC / (PRE + REC + EPS)
    return {"ACC": ACC, "PRE": PRE, "REC": REC, "F1": F1}


def boundary_seq_to_segments(boundary_seq) -> np.ndarray:
    """Binary start indicators -> (L, 2) [start, end) pairs; final end is the
    phoneme count (reference quirk, ``data_utils.py:159-181``)."""
    idx = np.where(np.asarray(boundary_seq) == 1)[0]
    seg = [[idx[i], idx[i + 1]] for i in range(len(idx) - 1)]
    seg.append([idx[-1], len(idx)])
    return np.asarray(seg, np.float64)


def segment_iou(pred_seg, gt_seg) -> np.ndarray:
    assert len(pred_seg) == len(gt_seg)
    ious = []
    for (ps, pe), (gs, ge) in zip(pred_seg, gt_seg):
        inter = max(0.0, min(pe, ge) - max(ps, gs))
        union = max(pe, ge) - min(ps, gs)
        ious.append(inter / (union + 1e-5))
    return np.asarray(ious)


def boundary_md_scoring(pred_boundary_seq, gt_boundary_seq, pred_md_lbl_seq,
                        gt_md_lbl_seq, tol: int = 5) -> Dict[str, float]:
    pred_b = _to_binary_array(pred_boundary_seq)
    gt_b = _to_binary_array(gt_boundary_seq)
    pred_md = _to_binary_array(pred_md_lbl_seq)
    gt_md = _to_binary_array(gt_md_lbl_seq)
    assert len(pred_b) == len(gt_b)
    n_pred = int(pred_b.sum())
    n_gt = int(gt_b.sum())
    assert n_pred == n_gt == len(pred_md) == len(gt_md)

    iou = segment_iou(boundary_seq_to_segments(pred_b),
                      boundary_seq_to_segments(gt_b))
    ave_iou = float(iou.mean()) * 100
    cmask, mmask = gt_md == 0, gt_md == 1
    correct_iou = float(iou[cmask].mean()) * 100 if cmask.any() else 0.0
    misp_iou = float(iou[mmask].mean()) * 100 if mmask.any() else 0.0

    TP = float(np.sum((1 - pred_md) * (1 - gt_md)))
    soft_TN = float(np.sum(pred_md * gt_md * iou))
    soft_TP = float(np.sum((1 - pred_md) * (1 - gt_md) * iou))
    TN = float(np.sum(pred_md * gt_md))
    FP = float(np.sum((1 - pred_md) * gt_md))
    FN = float(np.sum(pred_md * (1 - gt_md)))

    ACC = (soft_TP + soft_TN) / (TP + TN + FP + FN + EPS) * 100
    PRE = soft_TN / (TN + FN + EPS) * 100
    REC = soft_TN / (TN + FP + EPS) * 100
    F1 = 2 * PRE * REC / (PRE + REC + EPS)
    return {
        "soft_ACC": ACC, "soft_PRE": PRE, "soft_REC": REC, "soft_F1": F1,
        "ave_iou": ave_iou, "correct_iou": correct_iou, "misp_iou": misp_iou,
    }


def per_scoring(pred_phn_seq, gt_phn_seq, gt_cnncl_seq) -> Dict[str, float]:
    pred = np.asarray(pred_phn_seq).astype(np.int64)
    gt = np.asarray(gt_phn_seq).astype(np.int64)
    cn = np.asarray(gt_cnncl_seq).astype(np.int64)
    if not len(pred) == len(gt) == len(cn):
        raise ValueError("Inconsistent lengths")
    eps = 1e-5

    def per(p, t):
        return float(np.sum(p != t)) / (len(p) + eps) * 100

    cmask = gt == cn
    return {
        "correct_per": per(pred[cmask], gt[cmask]),
        "misp_per": per(pred[~cmask], gt[~cmask]),
    }


def batch_seq_md_scoring(
    pred_md_lbl_seqs=None,
    pred_phn_seqs=None,
    gt_md_lbl_seqs=None,
    gt_phn_seqs=None,
    gt_cnncl_seqs=None,
    pred_boundary_seqs=None,
    gt_boundary_seqs=None,
    boundary_md_scoring_tol: int = 5,
):
    def derive_md(phns, cnncls):
        if phns is None or cnncls is None:
            raise ValueError("need phn+cnncl seqs to derive MD labels")
        return [
            [int(p != c) for p, c in zip(ps, cs)]
            for ps, cs in zip(phns, cnncls)
        ]

    if pred_md_lbl_seqs is None:
        pred_md_lbl_seqs = derive_md(pred_phn_seqs, gt_cnncl_seqs)
    if gt_md_lbl_seqs is None:
        gt_md_lbl_seqs = derive_md(gt_phn_seqs, gt_cnncl_seqs)
    if len(pred_md_lbl_seqs) != len(gt_md_lbl_seqs):
        raise ValueError("Inconsistent batch size")

    scores = []
    for i in range(len(pred_md_lbl_seqs)):
        s = binary_seq_md_scoring(pred_md_lbl_seqs[i], gt_md_lbl_seqs[i])
        if pred_boundary_seqs is not None:
            s.update(boundary_md_scoring(
                pred_boundary_seqs[i], gt_boundary_seqs[i],
                pred_md_lbl_seqs[i], gt_md_lbl_seqs[i],
                boundary_md_scoring_tol,
            ))
        if pred_phn_seqs is not None and gt_phn_seqs is not None \
                and gt_cnncl_seqs is not None:
            s.update(per_scoring(pred_phn_seqs[i], gt_phn_seqs[i],
                                 gt_cnncl_seqs[i]))
        scores.append(s)

    seqs = {
        "gt_phn_seqs": [], "gt_cnncl_seqs": [], "gt_md_lbl_seqs": [],
        "pred_phn_seqs": [], "pred_md_lbl_seqs": [],
    }
    for i in range(len(scores)):
        L = len(pred_md_lbl_seqs[i])

        def get(x):
            return [7] * L if x is None else list(np.asarray(x[i]).tolist())

        seqs["gt_phn_seqs"].append(get(gt_phn_seqs))
        seqs["gt_cnncl_seqs"].append(get(gt_cnncl_seqs))
        seqs["gt_md_lbl_seqs"].append(get(gt_md_lbl_seqs))
        seqs["pred_phn_seqs"].append(get(pred_phn_seqs))
        seqs["pred_md_lbl_seqs"].append(get(pred_md_lbl_seqs))
    return scores, seqs


class MDMetricStats(BaseMetricStats):
    def __init__(self):
        super().__init__(metric_fn=batch_seq_md_scoring)
        self.saved_seqs: Dict[str, List] = {}

    def append(self, ids, **kwargs):
        self.ids.extend(ids)
        scores, seqs = self.metric_fn(**kwargs)
        self.scores_list.extend(scores)
        if not self.metric_keys:
            self.metric_keys = list(self.scores_list[0].keys())
        seqs["utt_ids"] = list(ids)
        if not self.saved_seqs:
            self.saved_seqs = seqs
        else:
            for key in self.saved_seqs:
                self.saved_seqs[key].extend(seqs[key])

    def summarize(self, field: Optional[str] = None):
        means = super().summarize()
        # F1 recomputed from mean PRE/REC (reference md_metric_stats.py:31-45)
        means["F1"] = (2 * means["PRE"] * means["REC"]) / (
            means["PRE"] + means["REC"] + EPS
        )
        means = {k: round(v, 2) for k, v in means.items()}
        return means if field is None else means[field]

    def write_seqs_to_file(self, path, label_encoder=None):
        with open(path, "w") as f:
            write_md_results_batch(
                f, self.scores_list, label_encoder=label_encoder,
                **self.saved_seqs,
            )


# -- result-table writer (parity with md_metric_stats.py:410-550) -----------

def write_md_results(fp, scores, utt_id, gt_phn_seq, gt_cnncl_seq,
                     gt_md_lbl_seq, pred_phn_seq=None, pred_md_lbl_seq=None,
                     label_encoder=None):
    if pred_phn_seq is None and pred_md_lbl_seq is None:
        raise ValueError("need a prediction to write")
    L = len(gt_phn_seq)
    if pred_phn_seq is None:
        pred_phn_seq = ["NA"] * L
    if pred_md_lbl_seq is None:
        pred_md_lbl_seq = [int(c != p) for c, p in
                           zip(gt_cnncl_seq, pred_phn_seq)]
    correctness = ["c" if g == p else "x"
                   for g, p in zip(gt_md_lbl_seq, pred_md_lbl_seq)]

    def decode(seq):
        if label_encoder is None:
            return [str(x) for x in seq]
        return ["**" if int(x) == -1 else label_encoder.ind2lab[int(x)]
                for x in seq]

    rows = [
        ("phn", decode(gt_phn_seq)),
        ("cnncl", decode(gt_cnncl_seq)),
        ("md_lbl", [str(x) for x in gt_md_lbl_seq]),
        ("pred_phn", decode(pred_phn_seq) if pred_phn_seq[0] != "NA"
         else list(pred_phn_seq)),
        ("pred_md_lbl", [str(x) for x in pred_md_lbl_seq]),
        ("correctness", correctness),
    ]
    fp.write(f"ID: {utt_id}\n")
    tmpl = "{:11s}: |" + "|".join(["{:^4s}"] * L) + "|\n"
    for name, cells in rows:
        fp.write(tmpl.format(name, *cells))
    for k, v in scores.items():
        fp.write(f"{k}: {v}\n")
    fp.write("\n")


def write_md_results_batch(fp, scores_list, utt_ids, gt_phn_seqs,
                           gt_cnncl_seqs, gt_md_lbl_seqs,
                           pred_phn_seqs=None, pred_md_lbl_seqs=None,
                           label_encoder=None):
    B = len(utt_ids)
    pred_phn_seqs = pred_phn_seqs or [None] * B
    pred_md_lbl_seqs = pred_md_lbl_seqs or [None] * B
    for i in range(B):
        write_md_results(
            fp, scores_list[i], utt_ids[i], gt_phn_seqs[i], gt_cnncl_seqs[i],
            gt_md_lbl_seqs[i], pred_phn_seqs[i], pred_md_lbl_seqs[i],
            label_encoder,
        )
