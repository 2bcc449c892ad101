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

The loops (``fit``, ``_fit_epochs``, ``evaluate``, ``evaluate_batch``)
follow the JAX Brain's per-batch loop: each TRAIN epoch, then a VALID
pass over the validation set every epoch, each batch prepared on the host
(``prepare_batch``), moved onto the run's device (``to_device_batch``)
and stepped; the epoch's mean loss is fetched once at the epoch's end and
logged with its wall time and utterance-seconds a second. ``evaluate``
restores the best checkpoint and runs the TEST pass, and logs its restore,
eval and write seconds. A step's draws come from ``self.generator``, or
from ``self.noise_source`` when it is set: it is called once per step,
train and eval alike, with the step's ``draws`` list (``MDVAE.draws``),
and returns the step's ``noise``, so a test can replay another run's
draws through the loops as it does through ``fit_batch``. A batch's
features are ``feat``, or ``kaldi_feat`` where a batch has no ``feat``
(``batch_feats``, the JAX Brain's fallback); the recipe names the keys
its step reads (``used_batch_keys``), and ``to_device_batch`` moves
those only. ``step_draws`` lists a step's draws from its device batch
(``draws`` at the features' B and T, unless a recipe needs more of the
batch).

Run options of the JAX Brain that the port does not have yet raise
``NotImplementedError`` (``check_run_opts``): the scanned epoch, the
device-batch cache, data and tensor parallelism, ZeRO-1, asynchronous
checkpoints, checkpoints without optimizer state and the profiler.
"""
from __future__ import annotations

import contextlib
import logging
import time
from enum import Enum, auto
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mlvae_tpu_torch.data.batch import DataLoader, prefetch

logger = logging.getLogger(__name__)

_ITEM12 = "ROADMAP queue 1 item 12 (parallelism and scale)"
# run option -> the values the port takes; any other value raises
UNPORTED_RUN_OPTS = {
    "scan_epoch": (False,),
    "scan_chunk": (),
    "data_parallel": (False,),
    "num_devices": (None, 1),
    "tensor_parallel": (None, 1),
    "zero1": (False,),
    "async_ckpt": (False,),
    "cache_device_batches": (False,),
    "device_batch_cache_mb": (),
    "profile": (False,),
    "ckpt_opt_state": (True,),
}


def check_run_opts(run_opts: Dict) -> None:
    """Raise ``NotImplementedError`` for a run option the port does not
    support yet, rather than ignore it."""
    for key, allowed in UNPORTED_RUN_OPTS.items():
        if key in run_opts and run_opts[key] not in allowed:
            raise NotImplementedError(
                f"run option --{key} {run_opts[key]} is not ported; it "
                f"waits in {_ITEM12}")


class Stage(Enum):
    TRAIN = auto()
    VALID = auto()
    TEST = auto()


def batch_feats(batch):
    """A batch's (features, relative lengths): ``feat``, or ``kaldi_feat``
    in a batch without it (the JAX Brain's fallback)."""
    return batch["feat"] if "feat" in batch else batch["kaldi_feat"]


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
    max_grad_norm = 5.0   # the JAX Brain's default; run_opts override it
    # Keys of the batch the step reads (None: all); the recipe sets them,
    # so that ``to_device_batch`` moves nothing else
    USED_BATCH_KEYS: Optional[set] = None
    # prediction keys the host-side evaluation reads (None: all)
    EVAL_PRED_KEYS: Optional[frozenset] = None

    def __init__(self, hparams: Dict, run_opts: Optional[Dict] = None,
                 checkpointer=None, label_encoder=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hparams = dict(hparams)
        self.run_opts = dict(run_opts or {})
        check_run_opts(self.run_opts)
        self.auto_mix_prec = bool(self.run_opts.get(
            "bf16", self.run_opts.get("auto_mix_prec", False)))
        self.max_grad_norm = float(self.run_opts.get("max_grad_norm",
                                                     self.max_grad_norm))
        self.debug = bool(self.run_opts.get("debug", False))
        self.debug_batches = int(self.run_opts.get("debug_batches", 2))
        self.allow_stale_ckpt = bool(self.run_opts.get("allow_stale_ckpt",
                                                       False))
        self.checkpointer = checkpointer
        self.label_encoder = label_encoder
        # the step draws' generator, and the optional replay of them
        self.generator = generator
        self.noise_source: Optional[Callable] = None
        # name -> (optimizer, module names or None for all); the recipe's
        # init_optimizers fills them
        self.optimizers: Dict = {}
        self.opt_states: Dict = {}
        self.step = 0
        self.avg_train_loss = 0.0
        self.stats_loggers: Dict = {}
        self._batch_ids: List = []

    # -- the recipe's contract ----------------------------------------------
    def compute_forward(self, batch: Dict, noise: Optional[Dict] = None,
                        generator: Optional[torch.Generator] = None,
                        train: bool = False, epoch: int = 1):
        """Returns the predictions dict with its per-element ``losses``."""
        raise NotImplementedError

    def compute_objectives(self, predictions: Dict, batch: Dict):
        """Returns (total loss, per-key losses)."""
        raise NotImplementedError

    def prepare_batch(self, batch):
        """Host-side checks of a batch before it moves to the device."""
        return batch

    def used_batch_keys(self) -> Optional[set]:
        """The batch keys the step reads (``USED_BATCH_KEYS``; None: all)."""
        return self.USED_BATCH_KEYS

    def draws(self, B: int, T: int, train: bool = False) -> List:
        """The draws of one forward (see ``MDVAE.draws``); none here."""
        return []

    def step_draws(self, dev_batch: Dict, train: bool) -> List:
        """The draws of one step on ``dev_batch``: ``draws`` at its
        features' B and T."""
        B, T = batch_feats(dev_batch)[0].shape[:2]
        return self.draws(B, T, train)

    def evaluate_predictions(self, predictions: Dict, batch, stage):
        """Host-side hook after each VALID/TEST batch (metrics etc.)."""

    def forward(self, *args, **kwargs):
        """``compute_forward``; the AMP step calls it through
        ``torch.func.functional_call`` with the bf16 parameters."""
        return self.compute_forward(*args, **kwargs)

    def set_stage(self, stage: Stage, epoch: Optional[int] = None):
        """What the forward depends on for ``stage`` (a recipe's training
        target); ``on_stage_start`` calls it, and so does ``fit_batch``."""

    def on_stage_start(self, stage: Stage, epoch: Optional[int] = None):
        self.set_stage(stage, epoch)
        self.stats_loggers = {}

    def on_stage_end(self, stage: Stage, stage_loss, epoch=None):
        pass

    def on_fit_start(self):
        self.init_optimizers()

    def on_evaluate_start(self, max_key=None, min_key=None):
        pass

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

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
        self.set_stage(Stage.TRAIN, epoch)
        batch = self.prepare_batch(batch)
        out = self.train_step(batch, epoch, noise=noise, generator=generator)
        self.step += 1
        return out

    # -- the loops -----------------------------------------------------------
    def to_device_batch(self, batch) -> Dict:
        """A host batch (a ``PaddedBatch``, or a dict of (array, relative
        lengths)) -> a dict of (tensor, relative lengths) on the run's
        device, with the keys the step reads (float64 arrays as f32) and
        the utterance ids under ``id``."""
        dev = self.device
        used = self.used_batch_keys()
        out = {"id": list(batch["id"])}
        for key in batch.keys():
            if key == "id" or (used is not None and key not in used):
                continue
            arr, lens = batch[key]
            arr = np.asarray(arr)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            out[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(
                    dev, non_blocking=True)
                for a in (arr, np.asarray(lens, np.float32)))
        return out

    def _next_noise(self, dev_batch: Dict, train: bool) -> Optional[Dict]:
        """The step's replayed draws from ``noise_source``, on the device;
        None (draw from ``self.generator``) without one."""
        if self.noise_source is None:
            return None
        noise = self.noise_source(self.step_draws(dev_batch, train))

        def on_dev(v):
            if isinstance(v, list):
                return [on_dev(x) for x in v]
            return v.to(self.device)
        return {k: on_dev(v) for k, v in (noise or {}).items()}

    def _record_losses(self, losses: Dict[str, torch.Tensor]) -> None:
        for key, value in losses.items():
            stats = self.stats_loggers.get(key + "_stats")
            if stats is not None:
                stats.append(value)

    def current_epoch(self) -> int:
        counter = self.hparams.get("epoch_counter")
        return counter.current if counter is not None else 0

    def make_dataloader(self, dataset, stage: Stage, **loader_kwargs):
        """Duration-ordered batches; ``shuffle`` shuffles the order of the
        batches (not their samples) and only while training."""
        kwargs = dict(loader_kwargs)
        shuffle = bool(kwargs.pop("shuffle", False)) and stage == Stage.TRAIN
        return DataLoader(dataset, shuffle=shuffle, **kwargs)

    def train_batch(self, batch, epoch: int) -> torch.Tensor:
        """One TRAIN batch of the loop: host checks, the move to the
        device, the step; returns the loss on the device."""
        batch = self.prepare_batch(batch)
        dev_batch = self.to_device_batch(batch)
        # a recipe that runs more device work on the batch after its step
        # (HMM_DNN_ALI's realignment) reuses both
        self._last_prepared_batch, self._last_dev_batch = batch, dev_batch
        self._batch_ids = batch["id"]
        loss, losses = self.train_step(
            dev_batch, epoch, noise=self._next_noise(dev_batch, True),
            generator=self.generator)
        self.step += 1
        self._record_losses(losses)
        return loss

    @torch.no_grad()
    def eval_forward(self, dev_batch: Dict, epoch: int = 1,
                     noise: Optional[Dict] = None,
                     generator: Optional[torch.Generator] = None):
        """The current stage's forward without training, as the JAX
        package's jitted eval step returns it: (predictions restricted to
        ``EVAL_PRED_KEYS``, total loss, per-key losses)."""
        preds = self.compute_forward(dev_batch, noise=noise,
                                     generator=generator, epoch=epoch)
        loss, losses = self.compute_objectives(preds, dev_batch)
        keys = self.EVAL_PRED_KEYS
        if keys is not None:
            preds = {k: v for k, v in preds.items() if k in keys}
        return preds, loss, losses

    def eval_step(self, batch: Dict, noise: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None):
        """One TEST eval step on a device batch (``eval_forward`` under
        the TEST stage)."""
        self.set_stage(Stage.TEST)
        return self.eval_forward(batch, noise=noise, generator=generator)

    def evaluate_batch(self, batch, stage: Stage) -> float:
        """One VALID or TEST batch: the forward, the losses recorded, the
        host-side evaluation; returns the loss."""
        batch = self.prepare_batch(batch)
        dev_batch = self.to_device_batch(batch)
        self._batch_ids = batch["id"]
        preds, loss, losses = self.eval_forward(
            dev_batch, self.current_epoch(),
            noise=self._next_noise(dev_batch, False),
            generator=self.generator)
        self._record_losses(losses)
        self.evaluate_predictions(preds, batch, stage)
        return float(loss)

    def fit(self, epoch_counter, train_set, valid_set=None,
            train_loader_kwargs=None, valid_loader_kwargs=None,
            progressbar=None):
        self.on_fit_start()
        train_loader = self.make_dataloader(
            train_set, Stage.TRAIN, **(train_loader_kwargs or {}))
        valid_loader = None
        if valid_set is not None:
            valid_loader = self.make_dataloader(
                valid_set, Stage.VALID, **(valid_loader_kwargs or {}))
        self._fit_epochs(epoch_counter, train_loader, valid_loader)

    def _fit_epochs(self, epoch_counter, train_loader, valid_loader):
        hop_s = float(self.hparams.get("hop_length", 20)) / 1000.0
        self.epoch_log: List[Dict] = []
        for epoch in epoch_counter:
            self.train()
            self.on_stage_start(Stage.TRAIN, epoch)
            t0 = time.time()
            losses, frames = [], 0
            for i, batch in enumerate(prefetch(train_loader)):
                losses.append(self.train_batch(batch, epoch))
                feats, lens = batch_feats(batch)
                frames += int(np.round(np.asarray(lens)
                                       * feats.shape[1]).sum())
                if self.debug and i + 1 >= self.debug_batches:
                    break
            # the epoch's one wait for the card
            self.avg_train_loss = float(np.mean(
                [float(l) for l in losses])) if losses else 0.0
            wall = time.time() - t0
            rate = frames * hop_s / max(wall, 1e-9)
            logger.info("epoch %d train: %.4f (%.1fs, %.0f utt-sec/sec)",
                        epoch, self.avg_train_loss, wall, rate)
            self.epoch_log.append({"epoch": epoch, "loss": self.avg_train_loss,
                                   "seconds": wall, "utt_sec_per_sec": rate,
                                   "batches": len(losses)})
            self.on_stage_end(Stage.TRAIN, self.avg_train_loss, epoch)

            if valid_loader is not None:
                self.eval()
                self.on_stage_start(Stage.VALID, epoch)
                tv = time.time()
                vlosses = []
                for i, batch in enumerate(prefetch(valid_loader)):
                    vlosses.append(self.evaluate_batch(batch, Stage.VALID))
                    if self.debug and i + 1 >= self.debug_batches:
                        break
                avg = float(np.mean(vlosses)) if vlosses else 0.0
                logger.info("epoch %d valid: %.4f (%.1fs)", epoch, avg,
                            time.time() - tv)
                self.epoch_log[-1]["valid_loss"] = avg
                self.on_stage_end(Stage.VALID, avg, epoch)

    def evaluate(self, test_set, max_key=None, min_key=None,
                 test_loader_kwargs=None, progressbar=None) -> float:
        """The TEST pass from the best checkpoint by ``max_key`` /
        ``min_key``; ``self.evaluate_timing`` keeps the restore, eval and
        write seconds that the log line gives."""
        t0 = time.time()
        self.on_evaluate_start(max_key=max_key, min_key=min_key)
        t_restore = time.time()
        self.eval()
        epoch = self.current_epoch()
        self.on_stage_start(Stage.TEST, epoch)
        loader = self.make_dataloader(test_set, Stage.TEST,
                                      **(test_loader_kwargs or {}))
        losses = []
        for i, batch in enumerate(prefetch(loader)):
            losses.append(self.evaluate_batch(batch, Stage.TEST))
            if self.debug and i + 1 >= self.debug_batches:
                break
        avg = float(np.mean(losses)) if losses else 0.0
        t_eval = time.time()
        self.on_stage_end(Stage.TEST, avg, epoch)
        self.evaluate_timing = {"restore": t_restore - t0,
                                "eval": t_eval - t_restore,
                                "write": time.time() - t_eval,
                                "batches": len(losses)}
        logger.info("evaluate timing: restore %.1fs, eval %.1fs, write "
                    "%.1fs", *(self.evaluate_timing[k]
                               for k in ("restore", "eval", "write")))
        return avg
