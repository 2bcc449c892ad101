"""The train step (counterpart of ``mlvae_tpu/training/brain.py``
``_make_train_step_raw``, ``_global_norm`` and ``fit_batch``).

A recipe subclasses :class:`Brain` and implements ``compute_forward`` and
``compute_objectives``. One step is: forward and masked losses, backward,
the global gradient norm over every module, a clip by
``min(1, max_grad_norm / (gnorm + 1e-12))``, the grads REPLACED by zeros on
a non-finite loss or norm, and one optimizer state per top-level module. A
module whose grads are all zero (its losses were detached under the
current target, or the step was non-finite) is inactive: it skips both its
optimizer-state advance and its update. A module that autograd never
reached counts as all zero. The decisions stay on the device; nothing
waits for the host.

AMP (``auto_mix_prec``, from ``run_opts["bf16"]`` or
``run_opts["auto_mix_prec"]``) follows the JAX Brain's ``_cast_floats``
rule, not ``torch.autocast``'s per-op lists: the forward runs on a bf16
copy of every float parameter, made by a differentiable cast so that its
grad reaches the f32 master parameter, and on the batch's float arrays
of ndim >= 2 cast to bf16 (the 1-D relative lengths never are). Buffers
(the normalizer's running statistics) stay f32. The predictions' float
leaves go back to f32 before ``compute_objectives``, which receives the
uncast batch. Master parameters, grads and optimizer states stay f32.
The AMP step's forward and backward run with cuBLAS's reduced-precision
bf16 reduction off, so that a split-K GEMM sums in f32 as the JAX
package's products do.

The rest of the JAX Brain's fit loop (validation, checkpoints, loggers,
the scanned epoch) is not ported yet.
"""
from __future__ import annotations

import contextlib
from enum import Enum, auto
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.func import functional_call


class Stage(Enum):
    TRAIN = auto()
    TEST = auto()


def global_norm(flat_grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([(g * g).sum() for g in flat_grads]).sum().sqrt()


def cast_floats(tree, dtype, min_ndim: int = 0):
    """Cast the float tensors of a nested dict / tuple / list to ``dtype``;
    tensors with fewer than ``min_ndim`` dims (relative lengths, counters)
    keep theirs (the JAX Brain's ``_cast_floats``)."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype, min_ndim) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_floats(v, dtype, min_ndim) for v in tree)
    if (isinstance(tree, torch.Tensor) and tree.is_floating_point()
            and tree.dim() >= min_ndim):
        return tree.to(dtype)
    return tree


@contextlib.contextmanager
def f32_gemm_sums():
    """cuBLAS's bf16 GEMMs sum in f32 inside the block, split-K included
    (``allow_bf16_reduced_precision_reduction`` off); restored after."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


class Brain(nn.Module):
    max_grad_norm = 5.0   # the JAX Brain's default

    def __init__(self, hparams: Dict, run_opts: Optional[Dict] = None):
        super().__init__()
        self.hparams = dict(hparams)
        self.run_opts = dict(run_opts or {})
        self.auto_mix_prec = bool(self.run_opts.get(
            "bf16", self.run_opts.get("auto_mix_prec", False)))
        # name -> (optimizer, module names or None for all); the recipe's
        # init_optimizers fills them
        self.optimizers: Dict = {}
        self.opt_states: Dict = {}
        self.step = 0

    # -- the recipe's contract ----------------------------------------------
    def compute_forward(self, batch: Dict, noise: Optional[Dict] = None,
                        generator: Optional[torch.Generator] = None,
                        train: bool = False, epoch: int = 1):
        """Returns the predictions dict with its per-element ``losses``."""
        raise NotImplementedError

    def compute_objectives(self, predictions: Dict, batch: Dict):
        """Returns (total loss, per-key losses)."""
        raise NotImplementedError

    def prepare_batch(self, batch: Dict) -> Dict:
        return batch

    def forward(self, *args, **kwargs):
        """``compute_forward``; the AMP step calls it through
        ``torch.func.functional_call`` with the bf16 parameters."""
        return self.compute_forward(*args, **kwargs)

    def on_stage_start(self, stage: Stage, epoch: Optional[int] = None):
        pass

    # -- optimizers -----------------------------------------------------------
    def param_modules(self) -> Dict[str, nn.Module]:
        """Top-level modules that hold parameters, by sorted name (running
        statistics such as the normalizer's are buffers, not parameters)."""
        return {name: m for name, m in sorted(self.named_children())
                if next(m.parameters(), None) is not None}

    def _opt_module_keys(self, module_names) -> List[str]:
        return (list(self.param_modules()) if module_names is None
                else list(module_names))

    def _init_opt_state(self, opt, module_names) -> Dict:
        """One optimizer state PER MODULE, so that a module left inactive
        this step keeps its state untouched."""
        mods = self.param_modules()
        return {mk: opt.init(list(mods[mk].parameters()))
                for mk in self._opt_module_keys(module_names)}

    # -- the step ----------------------------------------------------------
    def train_step(self, batch: Dict, epoch: int,
                   noise: Optional[Dict] = None,
                   generator: Optional[torch.Generator] = None):
        """One fused step; returns (loss, losses), detached. Afterwards each
        reached parameter's ``.grad`` holds the gradient as applied:
        clipped, or zeros after a non-finite step."""
        for p in self.parameters():
            p.grad = None
        kwargs = dict(noise=noise, generator=generator, train=True,
                      epoch=epoch)
        with (f32_gemm_sums() if self.auto_mix_prec
              else contextlib.nullcontext()):
            if self.auto_mix_prec:
                params = {name: p.to(torch.bfloat16) if p.is_floating_point()
                          else p for name, p in self.named_parameters()}
                preds = cast_floats(functional_call(
                    self, params, (cast_floats(batch, torch.bfloat16, 2),),
                    kwargs), torch.float32)
            else:
                preds = self.compute_forward(batch, **kwargs)
            loss, losses = self.compute_objectives(preds, batch)
            loss.backward()

        modules = self.param_modules()
        grads: Dict[str, Optional[torch.Tensor]] = {}
        for mk, mod in modules.items():
            ps = list(mod.parameters())
            grads[mk] = None if all(p.grad is None for p in ps) else \
                torch.cat([(p.grad if p.grad is not None
                            else torch.zeros_like(p)).reshape(-1)
                           for p in ps])
        with torch.no_grad():
            reached = [g for g in grads.values() if g is not None]
            gnorm = global_norm(reached) if reached else \
                torch.zeros((), device=loss.device)
            finite = torch.isfinite(loss) & torch.isfinite(gnorm)
            clip = torch.clamp(self.max_grad_norm / (gnorm + 1e-12), max=1.0)
            for mk, g in grads.items():
                if g is None:
                    continue
                # REPLACE on a non-finite step: NaN * 0 would stay NaN
                g = torch.where(finite, g * clip, torch.zeros_like(g))
                grads[mk] = g
                offset = 0
                for p in modules[mk].parameters():
                    p.grad = g[offset:offset + p.numel()].view_as(p)
                    offset += p.numel()
            for name in sorted(self.optimizers):
                opt, module_names = self.optimizers[name]
                for mk in self._opt_module_keys(module_names):
                    g = grads[mk]
                    if g is None:   # never reached: all zero, inactive
                        continue
                    opt.step(list(modules[mk].parameters()), g,
                             self.opt_states[name][mk], active=(g != 0).any())
        return loss.detach(), {k: v.detach() for k, v in losses.items()}

    def fit_batch(self, batch: Dict, epoch: int,
                  noise: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None):
        """One training batch of ``epoch``: the stage's target is set from
        the epoch, the batch checked, the step taken. ``noise`` replays the
        step's draws by name; otherwise they come from ``generator``.
        Returns (loss, losses)."""
        self.on_stage_start(Stage.TRAIN, epoch)
        batch = self.prepare_batch(batch)
        out = self.train_step(batch, epoch, noise=noise, generator=generator)
        self.step += 1
        return out
