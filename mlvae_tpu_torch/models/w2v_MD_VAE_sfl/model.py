"""w2v_MD_VAE_sfl (counterpart of
``mlvae_tpu/models/w2v_MD_VAE_sfl/model.py``): MD_VAE_sfl's REINFORCE
step over the frozen trunk's projections, as w2v_MD_VAE feeds them."""
from __future__ import annotations

from mlvae_tpu_torch.models.MD_VAE_sfl.model import SBModel as MD_VAE_sfl
from mlvae_tpu_torch.models.w2v_MD_VAE.model import w2v_branch_inputs
from mlvae_tpu_torch.models.w2v_common import W2VMixin


class SBModel(W2VMixin, MD_VAE_sfl):
    USED_BATCH_KEYS = MD_VAE_sfl.USED_BATCH_KEYS | {"wav"}
    PHN_FC_NAME = "phn_recog_out_fc"

    def _branch_inputs(self, feats, target, batch, noise, generator, train):
        return w2v_branch_inputs(self, target, batch, noise, generator,
                                 train)
