"""w2v_CRDNN_CTC (counterpart of
``mlvae_tpu/models/w2v_CRDNN_CTC/model.py``): a small CRDNN and CTC over
the fine-tuned trunk's features (no normalizer). Its LSTM is at H=32:
K1's narrow build in f32, ``nn.rnn.lstm_scan`` (the JAX package's
bf16-carry scan) under ``--bf16``. A step's draws are the trunk's, then
the CRDNN's."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from mlvae_tpu_torch.models.CRDNN_CTC.model import _LOG_SOFTMAX
from mlvae_tpu_torch.models.CRDNN_CTC.model import SBModel as CRDNN_CTC
from mlvae_tpu_torch.models.md_model import grad_if
from mlvae_tpu_torch.models.w2v_common import W2VMixin


class SBModel(W2VMixin, CRDNN_CTC):
    USED_BATCH_KEYS = CRDNN_CTC.USED_BATCH_KEYS | {"wav"}

    def compute_forward(self, batch: Dict, noise: Optional[Dict] = None,
                        generator: Optional[torch.Generator] = None,
                        train: bool = False, epoch: int = 1):
        noise = noise or {}
        with grad_if(train):
            w2v = self._w2v_feats(batch, noise, generator, train)
            out = self.output(self.crdnn(w2v, train=train,
                                         generator=generator, noise=noise))
            act = self.hparams.get("log_softmax", _LOG_SOFTMAX)
            return {"pout": act(out)}
