"""MD_VAE_joint (counterpart of ``mlvae_tpu/models/MD_VAE_joint/model.py``):
MD_VAE with its three branches trained together in every epoch.

The target is VAE in every TRAIN and VALID stage (no cycle) and TEST in
TEST; no loss is detached, so the recognizer's and the boundary
detector's losses train them inside the VAE step. VALID is evaluated only
in every 10th epoch (its statistics, its log line and its checkpoint), and
an evaluated VALID stage saves its MD results as TEST does.
"""
from __future__ import annotations

from mlvae_tpu_torch.models.MD_VAE.model import SBModel as MDVAESBModel
from mlvae_tpu_torch.models.MD_VAE.model import Target
from mlvae_tpu_torch.training.brain import Stage


class SBModel(MDVAESBModel):
    TRAIN_CYCLE = (Target.VAE,)
    detach_inactive = False
    save_md_on_valid = True

    def to_run_evaluation(self, stage) -> bool:
        if stage == Stage.TRAIN:
            return False
        if stage == Stage.TEST:
            return True
        epoch = getattr(self, "_stage_epoch", None)
        if epoch is None:
            raise ValueError("epoch cannot be None")
        return epoch % 10 == 0
