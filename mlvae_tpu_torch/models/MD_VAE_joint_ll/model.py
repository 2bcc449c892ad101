"""MD_VAE_joint_ll (counterpart of
``mlvae_tpu/models/MD_VAE_joint_ll/model.py``): MD_VAE_joint with the
recognizer's and the boundary detector's losses detached, as MD_VAE
detaches the branches a target does not train, and VALID evaluated in
every epoch; MD results are saved in TEST only.
"""
from __future__ import annotations

from mlvae_tpu_torch.models.MD_VAE_joint.model import \
    SBModel as MDVAEJointSBModel
from mlvae_tpu_torch.training.brain import Stage


class SBModel(MDVAEJointSBModel):
    detach_inactive = True
    save_md_on_valid = False

    def to_run_evaluation(self, stage) -> bool:
        return stage in (Stage.VALID, Stage.TEST)
