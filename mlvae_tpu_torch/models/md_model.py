"""Shared recipe base (counterpart of ``mlvae_tpu/models/md_model.py``):
the optimizers by module and the weighted total loss with KLD weights
annealed by the training-set size."""
from __future__ import annotations

import warnings
from typing import Dict

from mlvae_tpu_torch.training.brain import Brain

KLD_N_SAMPLES_DEFAULT = 2249  # the reference's L2-ARCTIC training-set size


class MDModel(Brain):
    def init_optimizers(self):
        """``hparams["optimizer"]`` for every module, or
        ``hparams["optimizers"]``: a list or dict whose entries are an
        optimizer, or ``{"opt_class": optimizer, "modules": [...]}``. One
        state per optimizer and top-level module."""
        if "optimizers" in self.hparams:
            opt_info = self.hparams["optimizers"]
            if isinstance(opt_info, (list, tuple)):
                opt_info = {f"optimizer_{i}": o
                            for i, o in enumerate(opt_info)}
        elif "optimizer" in self.hparams:
            opt_info = {"optimizer": self.hparams["optimizer"]}
        else:
            raise ValueError("No optimizers defined.")
        self.optimizers, self.opt_states = {}, {}
        for name, info in opt_info.items():
            if isinstance(info, dict):
                opt = info["opt_class"]
                module_names = list(info.get("modules", [])) or None
            else:
                opt, module_names = info, None
            self.optimizers[name] = (opt, module_names)
            self.opt_states[name] = self._init_opt_state(opt, module_names)

    def weighted_total(self, losses: Dict):
        """Sum of ``weight * loss`` in the losses' order; a ``*_kld``
        weight is divided by ``kld_n_samples / batch_size``."""
        total = 0.0
        for key, value in losses.items():
            weight_key = key.replace("_loss", "_weight")
            weight = self.hparams.get(weight_key, "none")
            if weight == "none":
                warnings.warn(f"{weight_key} not found, use 1 as default")
                weight = 1.0
            if "_kld" in weight_key:
                n_samples = self.hparams.get("kld_n_samples",
                                             KLD_N_SAMPLES_DEFAULT)
                weight = weight / (n_samples / self.hparams["batch_size"])
            total = total + weight * value
        return total
