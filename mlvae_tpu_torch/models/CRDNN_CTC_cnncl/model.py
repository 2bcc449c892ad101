"""CRDNN_CTC_cnncl (counterpart of
``mlvae_tpu/models/CRDNN_CTC_cnncl/model.py``): CRDNN_CTC with the CTC
trained on the canonical phoneme sequence."""
from __future__ import annotations

from mlvae_tpu_torch.models.CRDNN_CTC.model import SBModel as CRDNN_CTC


class SBModel(CRDNN_CTC):
    CTC_TARGET_KEY = "gt_cnncl_seq"
