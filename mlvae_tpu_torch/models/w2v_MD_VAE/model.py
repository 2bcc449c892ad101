"""w2v_MD_VAE (counterpart of ``mlvae_tpu/models/w2v_MD_VAE/model.py``):
MD_VAE over wav2vec2 features. Each branch takes an FC projection of the
frozen trunk's features (``phn_recog_in_fc``, ``b_detector_in_fc`` and,
where the target runs the VAE, ``w2v_feat_fc``); the decoder still
reconstructs the normalized fbank features; two optimizers split the
trunk from the rest (``model.yaml:162-182``). A fine-tuned trunk's draws
come first in a step (``W2VMixin.step_draws``)."""
from __future__ import annotations

from mlvae_tpu_torch.models.MD_VAE.model import SBModel as MD_VAE
from mlvae_tpu_torch.models.MD_VAE.model import Target
from mlvae_tpu_torch.models.w2v_common import W2VMixin


def w2v_branch_inputs(model, target, batch, noise, generator, train):
    """The three projections of the trunk's features, the VAE's where the
    target runs it."""
    w2v = model._w2v_feats(batch, noise, generator, train)
    vae_in = model.w2v_feat_fc(w2v) \
        if target in (Target.VAE, Target.TEST) else None
    return {"phn_in": model.phn_recog_in_fc(w2v),
            "bdet_in": model.b_detector_in_fc(w2v), "vae_in": vae_in}


class SBModel(W2VMixin, MD_VAE):
    USED_BATCH_KEYS = MD_VAE.USED_BATCH_KEYS | {"wav"}
    PHN_FC_NAME = "phn_recog_out_fc"

    def _branch_inputs(self, feats, target, batch, noise, generator, train):
        return w2v_branch_inputs(self, target, batch, noise, generator,
                                 train)
