"""w2v_MD_VAE_sfl_resi (counterpart of
``mlvae_tpu/models/w2v_MD_VAE_sfl_resi/model.py``): each branch takes the
normalized fbank features concatenated with its projection of the
trunk's features; the trunk is fine-tuned (``freeze: False``), so its
dropout draws lead each training step."""
from __future__ import annotations

import torch

from mlvae_tpu_torch.models.w2v_MD_VAE_sfl.model import SBModel as W2V_SFL


class SBModel(W2V_SFL):
    def _branch_inputs(self, feats, target, batch, noise, generator, train):
        inputs = super()._branch_inputs(feats, target, batch, noise,
                                        generator, train)
        return {k: None if v is None else torch.cat([feats, v], dim=-1)
                for k, v in inputs.items()}
