"""External DNN-HMM and forced-alignment scoring (counterpart of
``mlvae_tpu/metrics/dnn_hmm.py``): per utterance the boundary metrics,
the MD metrics against an all-correct prediction (forced alignment,
``compute_fa_metrics``) or the external system's labels
(``compute_asr_metrics``), and the IOU-weighted boundary-MD metrics, each
averaged over the set."""
from __future__ import annotations

from typing import Dict

import numpy as np

from mlvae_tpu_torch.metrics.boundary import boundary_scoring
from mlvae_tpu_torch.metrics.md import (binary_seq_md_scoring,
                                        boundary_md_scoring)


def _accumulate(metrics: Dict, sample_metrics: Dict):
    for key, value in sample_metrics.items():
        metrics.setdefault(key, []).append(float(value))


def _score(dataset, boundary_key: str, pred_md) -> Dict[str, float]:
    metrics: Dict = {}
    for sample in dataset:
        out = {}
        pred_b = np.asarray(sample[boundary_key])
        gt_b = np.asarray(sample["gt_boundary_seq"])
        for k, v in boundary_scoring(pred_b, gt_b).items():
            out["boundary." + k] = v
        gt_md = np.asarray(sample["plvl_gt_md_lbl_seq"])
        md = pred_md(sample, gt_md)
        for k, v in binary_seq_md_scoring(md, gt_md).items():
            out["MD." + k] = v
        for k, v in boundary_md_scoring(pred_b, gt_b, md, gt_md).items():
            out["boundary_MD." + k] = v
        _accumulate(metrics, out)
    return {k: float(np.mean(v)) for k, v in metrics.items()}


def compute_fa_metrics(dataset) -> Dict[str, float]:
    """The forced alignment's boundaries, every phoneme called correct."""
    return _score(dataset, "fa_boundary_seq",
                  lambda sample, gt_md: np.zeros_like(gt_md))


def compute_asr_metrics(dataset) -> Dict[str, float]:
    """The external system's boundaries and MD labels."""
    return _score(dataset, "ext_dnn_hmm_boundary_seq",
                  lambda sample, gt_md: np.asarray(
                      sample["ext_plvl_dnn_hmm_md_lbl_seq"]))


def compute_dnn_hmm_metrics(dataset):
    fa = compute_fa_metrics(dataset)
    for key, value in fa.items():
        print(f"fa.{key}: {round(value, 2)}")
    asr = compute_asr_metrics(dataset)
    for key, value in asr.items():
        print(f"asr.{key}: {round(value, 2)}")
    return {"fa": fa, "asr": asr}
