"""Shared recipe base (counterpart of ``mlvae_tpu/models/md_model.py``):
the optimizers by module, the weighted total loss with KLD weights
annealed by the training-set size, the loss statistics of
``hparams["metric_keys"]``, the train log and scalar sink, the checkpoint
on every VALID stage under ``max_key`` / ``min_key``, the resume from the
newest checkpoint, and the TEST metric and statistics files.

A checkpoint holds the JAX package's trees: ``params`` (every parameter,
keyed by its module path), ``states`` (the normalizer's running
statistics) and ``opt__<name>`` (each optimizer's state per module, in
the layout of ``optax.inject_hyperparams`` of the optimizer: ``count``,
``hyperparams`` and the inner states, e.g. Adam's ``inner_state[0]`` with
``count``, ``mu`` and ``nu``, Adadelta's ``inner_state[1]`` with ``e_g``
and ``e_x``, SGD's ``inner_state[0].trace`` with momentum), so that either
package resumes or evaluates from the other's checkpoints.
"""
from __future__ import annotations

import contextlib
import logging
import warnings
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from mlvae_tpu_torch.convert import (STATE_MODULES, load_jax_checkpoint,
                                     stack_layers, unstack_layers)
from mlvae_tpu_torch.metrics.loss import LossMetricStats
from mlvae_tpu_torch.nn.norm import InputNormalization
from mlvae_tpu_torch.training.brain import Brain, Stage
from mlvae_tpu_torch.training.checkpointer import (CheckpointKeyMismatch,
                                                   DeviceSnapshot,
                                                   checkpoint_has)
from mlvae_tpu_torch.training.loggers import FileTrainLogger, ScalarWriter

logger = logging.getLogger(__name__)

KLD_N_SAMPLES_DEFAULT = 2249  # the reference's L2-ARCTIC training-set size


def keystr(parts) -> str:
    """A module path as ``jax.tree_util.keystr`` writes a dict path."""
    return "".join(f"['{p}']" for p in parts)


def grad_if(train: bool):
    """The forward's context: autograd while training, none otherwise."""
    return contextlib.nullcontext() if train else torch.no_grad()


def dropout_draws(name: str, lstm, B: int, T: int):
    """An LSTM's dropout keep-masks as named draws (see ``MDVAE.draws``):
    one (T, B, width) mask a gap between layers."""
    return [(name, "bernoulli", s, 1.0 - lstm.dropout, torch.float32)
            for s in lstm.dropout_shapes(B, T)]


def pi_vae_draws(model, B: int, T: int, train: bool):
    """The draws of one π sample and the hierarchical VAE and decoder on
    it (MD_VAE's and test_h_vae's): π's Gumbel noise (training only; bf16
    under AMP, as ``jax.random.categorical`` draws it for bf16 logits),
    the encoder's three, the decoder's dropout masks (training only)."""
    lat, nc = model.hparams["latent_size"], model.hparams["num_components"]
    f32 = torch.float32
    out = []
    if train:
        out.append(("pi_gumbel", "gumbel", (B, T, 2), None,
                    torch.bfloat16 if model.auto_mix_prec else f32))
    out += [("vanilla_eps", "normal", (B, T, lat), None, f32),
            ("gumbel_g", "gumbel", (B, T, nc), None, f32),
            ("gmm_eps", "normal", (B, T, lat * nc), None, f32)]
    if train:
        out += dropout_draws("decoder_dropout", model.decoder.rnn, B, T)
    return out


def moment_to_numpy(t: torch.Tensor) -> np.ndarray:
    """An optimizer moment as the JAX checkpointer writes it: bf16 as its
    raw 16-bit words (``|V2``, what ``np.asarray`` of an ml_dtypes bf16
    array saves), any other dtype as itself."""
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).cpu().numpy().view("V2")
    return t.detach().cpu().numpy()


def moment_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """The inverse of ``moment_to_numpy``."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def as_optimizer(info):
    """A YAML optimizer entry (``!name:torch.optim.Adam`` gives a partial
    of the port's ``Adam``) -> an optimizer with ``init`` and ``step``."""
    return info if hasattr(info, "init") else info()


class _NoWrites:
    """The train log and scalar sink of a rank that does not write."""

    def log_stats(self, *args, **kwargs):
        pass

    def add_scalar(self, *args, **kwargs):
        pass


class MDModel(Brain):
    # modules of the recipe's YAML ``modules`` that hold no parameters (the
    # CTC recipes' and LSTM_FC's normalizer): the JAX package keeps an
    # optimizer state for each all the same (its counts and
    # hyperparameters, no moments, never advanced), which the checkpoint
    # carries
    stateless_opt_modules: tuple = ()
    # a recipe whose YAML selects on a metric it never emits (HMM_DNN_ALI)
    # evaluates the newest checkpoint as its normal path: the guard of
    # ``on_evaluate_start`` lets that selection through
    ALLOW_KEYLESS_CKPT = False

    def adopt_modules(self, modules: Dict) -> None:
        """The recipe's modules as children by their names; those without
        parameters keep an optimizer state in the checkpoint
        (``stateless_opt_modules``)."""
        for name, module in modules.items():
            setattr(self, name, module)
        self.stateless_opt_modules = tuple(
            name for name, module in modules.items()
            if next(module.parameters(), None) is None)

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
                opt = as_optimizer(info["opt_class"])
                module_names = list(info.get("modules", [])) or None
            else:
                opt, module_names = as_optimizer(info), None
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

    # -- hooks ---------------------------------------------------------------
    def on_fit_start(self):
        super().on_fit_start()
        out_dir = Path(self.hparams["output_dir"])
        if self.is_writer:
            self.train_logger = FileTrainLogger(out_dir / "train_log.txt")
            self.scalar_writer = ScalarWriter(out_dir)
            with open(out_dir / "modules.txt", "w") as f:
                for name, module in self.named_children():
                    f.write(f"{name}: {module!r}\n")
        else:   # rank 0 alone writes
            self.train_logger = self.scalar_writer = _NoWrites()
        if self.checkpointer is not None:   # resume from the newest
            ckpt = self.checkpointer.find_checkpoint()
            if ckpt is not None:
                self._restore(ckpt, with_opt=True)
                logger.info("resumed from %s (epoch %s)", ckpt.path,
                            ckpt.meta.get("epoch"))

    def on_stage_start(self, stage: Stage, epoch=None):
        self.set_stage(stage, epoch)
        self.stats_loggers = {}
        for key in self.hparams.get("metric_keys", []):
            if key.endswith("_loss"):
                self.stats_loggers[key + "_stats"] = LossMetricStats(key)

    def collect_metrics(self, stage_loss) -> Dict[str, float]:
        log_metrics = {"loss": round(float(stage_loss), 3)}
        for metric_key in self.hparams.get("metric_keys", []):
            parts = metric_key.split(".")
            stats = self.stats_loggers.get(f"{parts[0].lower()}_stats")
            if stats is None:
                continue
            try:
                if len(parts) == 1:
                    for k, v in stats.summarize(None).items():
                        log_metrics[f"{metric_key}.{k}"] = round(float(v), 2)
                else:
                    log_metrics[metric_key] = round(
                        float(stats.summarize(parts[1])), 2)
            except ValueError:
                pass  # no data appended this stage
        return log_metrics

    def on_stage_end(self, stage: Stage, stage_loss, epoch=None):
        stage_name = stage.name.lower()
        if epoch is None:
            epoch = self.current_epoch()
        log_metrics = self.collect_metrics(stage_loss)

        if stage in (Stage.TRAIN, Stage.VALID):
            self.train_logger.log_stats(
                stats_meta={"stage": stage_name, "epoch": epoch},
                **{f"{stage_name}_stats": log_metrics})
            for k, v in log_metrics.items():
                self.scalar_writer.add_scalar(f"{k}/{stage_name}", v,
                                              global_step=epoch)
            if stage == Stage.VALID and self.checkpointer is not None:
                max_keys, min_keys = [], []
                if self.hparams.get("max_key") is not None:
                    max_keys.append(self.hparams["max_key"])
                if self.hparams.get("min_key") is not None:
                    min_keys.append(self.hparams["min_key"])
                if not max_keys and not min_keys:
                    raise ValueError("no max_key or min_key provided")
                meta = dict(log_metrics)
                meta["epoch"] = epoch
                # every rank gathers its shards, rank 0 writes
                state = self.checkpoint_snapshot(asynchronous=bool(
                    getattr(self.checkpointer, "async_save", False)))
                if self.is_writer:
                    self.checkpointer.save_and_keep_only(
                        state, meta=meta, max_keys=max_keys,
                        min_keys=min_keys)

        if stage == Stage.TEST and self.is_writer:
            out_dir = Path(self.hparams["output_dir"]) / "test_output"
            out_dir.mkdir(parents=True, exist_ok=True)
            log_str = ", ".join(f"{k}: {v}" for k, v in log_metrics.items())
            logger.info("Best epoch: %s, %s", epoch, log_str)
            with open(out_dir / "test_metrics.txt", "w") as f:
                f.write(f"Epoch: {epoch}\n")
                values = []
                for k, v in log_metrics.items():
                    f.write(f"{k}: {v}\n")
                    values.append(str(v))
                f.write(f"Epoch: {epoch}\t" + "\t".join(values) + "\n")
            for stats_key, stats in self.stats_loggers.items():
                name = stats_key.replace("_stats", "")
                try:
                    with open(out_dir / f"{name}.txt", "w") as f:
                        stats.write_stats(f)
                except ValueError:
                    pass

    def on_evaluate_start(self, max_key=None, min_key=None):
        """Restore the best checkpoint by ``max_key`` / ``min_key``:
        parameters and the normalizer's statistics, and the epoch counter
        from its meta. A checkpoint from epoch 1 of a longer run, or one
        picked without its key, is refused unless ``--debug`` or
        ``--allow_stale_ckpt`` (the second also where the recipe sets
        ``ALLOW_KEYLESS_CKPT``)."""
        self.place_on_mesh()
        if self.checkpointer is None:
            return
        ckpt = self.checkpointer.find_checkpoint(max_key=max_key,
                                                 min_key=min_key)
        if ckpt is None:
            return
        self._restore(ckpt, with_opt=False)
        logger.info("recovered checkpoint %s", ckpt.path)
        if self.allow_stale_ckpt or self.debug:
            return
        limit = getattr(self.hparams.get("epoch_counter"), "limit", None)
        epoch = ckpt.meta.get("epoch")
        if (limit is not None and limit > 1 and epoch is not None
                and int(epoch) <= 1):
            raise RuntimeError(
                f"evaluate would use checkpoint {ckpt.path.name} from epoch "
                f"{epoch} of a {limit}-epoch config: the training run that "
                f"produced it almost certainly failed. Re-run training, or "
                f"pass --allow_stale_ckpt to evaluate it anyway.")
        if ((max_key or min_key)
                and self.checkpointer.last_selection_fell_back
                and not self.ALLOW_KEYLESS_CKPT):
            raise RuntimeError(
                f"no checkpoint records the selection key "
                f"{max_key or min_key!r}; evaluating the newest checkpoint "
                f"instead could silently score the wrong model. Pass "
                f"--allow_stale_ckpt to accept the newest checkpoint.")

    # -- checkpoint state ----------------------------------------------------
    def checkpoint_state(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The trees of a checkpoint, flat and keyed as the JAX package's
        ``jax.tree_util.keystr`` writes them."""
        return self.checkpoint_snapshot().fetch()

    def checkpoint_snapshot(self, asynchronous: bool = False
                            ) -> DeviceSnapshot:
        """The tensors of a checkpoint on their way to the host (a
        collective under a mesh: every rank gathers its shards), and how
        ``checkpoint_state``'s trees are made of them; ``asynchronous``:
        the copy from the card runs on a side stream (``--async_ckpt``)."""
        tensors = {f"sd/{k}": v for k, v in self.full_state_dict().items()}
        if self.ckpt_opt_state:
            for name in self.opt_states:
                opt = self.optimizers[name][0]
                for mk, _ in self._opt_layout(name):
                    st = self.opt_states[name][mk]
                    for key in ["count", *opt.SCALARS]:
                        tensors[f"opt/{name}/{mk}/{key}"] = st[key]
                    for key in opt.MOMENTS:
                        tensors[f"opt/{name}/{mk}/{key}"] = \
                            self.full_moment(name, mk, key)
        elif not getattr(self, "_warned_no_opt_ckpt", False):
            self._warned_no_opt_ckpt = True
            logger.warning(
                "--ckpt_opt_state False: optimizer state excluded from "
                "checkpoints; a resumed run restarts with fresh optimizer "
                "moments")
        return DeviceSnapshot(tensors, self._checkpoint_trees,
                              asynchronous=asynchronous)

    def _checkpoint_trees(self, host: Dict[str, torch.Tensor]
                          ) -> Dict[str, Dict[str, np.ndarray]]:
        params, states = {}, {}
        flat = stack_layers({k[len("sd/"):]: v.numpy()
                             for k, v in host.items() if k.startswith("sd/")})
        for key, value in flat.items():
            path = key.split(".")
            target = states if path[0] in STATE_MODULES else params
            target[keystr(path)] = value
        state = {"params": params, "states": states}
        if self.ckpt_opt_state:
            for name in self.opt_states:
                state[f"opt__{name}"] = self._opt_tree(
                    name, lambda mk, key, n=name: host[f"opt/{n}/{mk}/{key}"])
        return state

    def _opt_layout(self, name):
        """(module key, its parameters' names and whole shapes) per state of
        optimizer ``name``, in the order of the state's flat moments."""
        out = []
        for mk in self.opt_states[name]:
            shapes = []
            for n, shape, dim in self._moment_layout(mk):
                shape = list(shape)
                if dim is not None:
                    shape[dim] *= self.mesh.n_model
                shapes.append((n, tuple(shape)))
            out.append((mk, shapes))
        return out

    def _opt_tree(self, name, tensor=None) -> Dict[str, np.ndarray]:
        """Optimizer ``name``'s states in the layout the optimizer names
        (``training/optim.py``): per module the outer ``count``, the
        injected hyperparameters (f32), its ``SCALARS`` again under their
        inner paths and its ``MOMENTS`` per parameter. ``tensor(mk, key)``
        gives a state's tensor (whole moments); the live states without
        it."""
        opt = self.optimizers[name][0]
        if tensor is None:
            def tensor(mk, key):
                return (self.full_moment(name, mk, key)
                        if key in opt.MOMENTS
                        else self.opt_states[name][mk][key])
        f32 = np.float32
        out = {}
        for mk, params in self._opt_layout(name):
            count = np.asarray(tensor(mk, "count").cpu().numpy(), np.int32)
            out[f"['{mk}'].count"] = count
            for k, v in opt.hyperparams().items():
                out[f"['{mk}'].hyperparams['{k}']"] = np.asarray(v, f32)
            for key, path in opt.SCALARS.items():
                out[f"['{mk}'].{path}"] = np.asarray(
                    tensor(mk, key).cpu().numpy(), np.int32)
            for key, path in opt.MOMENTS.items():
                flat = moment_to_numpy(tensor(mk, key))
                offset, per_param = 0, {}
                for pname, shape in params:
                    n = int(np.prod(shape))
                    per_param[pname] = flat[offset:offset + n].reshape(shape)
                    offset += n
                for pname, value in stack_layers(per_param).items():
                    out[f"['{mk}'].{path}"
                        + keystr([mk] + pname.split("."))] = value
        if self.optimizers[name][1] is None:
            for mk in self.stateless_opt_modules:
                out[f"['{mk}'].count"] = np.asarray(0, np.int32)
                for k, v in opt.hyperparams().items():
                    out[f"['{mk}'].hyperparams['{k}']"] = np.asarray(v, f32)
                for path in opt.SCALARS.values():
                    out[f"['{mk}'].{path}"] = np.asarray(0, np.int32)
        return out

    def _set_opt_tree(self, name, tree: Dict[str, np.ndarray]) -> None:
        opt = self.optimizers[name][0]
        for mk, params in self._opt_layout(name):
            st = self.opt_states[name][mk]
            st["count"].copy_(torch.as_tensor(tree[f"['{mk}'].count"]))
            names = list(stack_layers({p: None for p, _ in params}))
            for key, path in opt.MOMENTS.items():
                per_param = unstack_layers({
                    p: tree[f"['{mk}'].{path}" + keystr([mk] + p.split("."))]
                    for p in names})
                flat = np.concatenate([per_param[p].reshape(-1)
                                       for p, _ in params])
                self.set_full_moment(name, mk, key, moment_from_numpy(flat))

    def _restore(self, ckpt, with_opt: bool) -> None:
        """Parameters and running statistics from ``ckpt`` (and the
        optimizer states with ``with_opt``), and the epoch counter from its
        meta. Every parameter must be in the checkpoint; running statistics
        only where it saved them."""
        self.place_on_mesh()
        missing, unexpected = self.load_state_dict(
            self.local_state_dict(load_jax_checkpoint(ckpt.path)),
            strict=False)
        bad = [k for k in missing if k.split(".")[0] not in STATE_MODULES]
        if bad or unexpected:
            raise ValueError(f"checkpoint {ckpt.path} does not fit the model:"
                             f" missing {bad[:3]}, unexpected "
                             f"{unexpected[:3]}")
        if with_opt:
            names = [n for n in self.opt_states
                     if checkpoint_has(ckpt, f"opt__{n}")]
            try:
                restored = self.checkpointer.load_checkpoint(
                    ckpt, {f"opt__{n}": self._opt_tree(n) for n in names})
            except CheckpointKeyMismatch as e:
                if not e.rec_name.startswith("opt__"):
                    raise
                # the optimizer-state layout changed: resume the parameters
                # and statistics with fresh moments, loudly (the JAX
                # MDModel.on_fit_start's fallback)
                logger.warning(
                    "checkpoint %s predates the current optimizer-state "
                    "layout (%s); resuming with freshly initialized "
                    "optimizer state", ckpt.path, e)
                names = []
            for n in names:
                self._set_opt_tree(n, restored[f"opt__{n}"])
        epoch = ckpt.meta.get("epoch")
        counter = self.hparams.get("epoch_counter")
        if epoch is not None and counter is not None:
            counter.current = int(epoch)


class RecipeModel(MDModel):
    """A recipe as ``cli.train`` / ``cli.test`` build it from its YAML: the
    modules by their YAML names, ``hparams["normalizer"]`` (sized to
    ``input_size``; a fresh one where the YAML has none), its checkpointer
    and epoch counter, the run's step generator and the label encoder."""

    def __init__(self, modules: Dict, hparams: Dict, run_opts=None,
                 checkpointer=None, label_encoder=None,
                 generator: torch.Generator = None, device=None):
        super().__init__(hparams, run_opts, checkpointer=checkpointer,
                         label_encoder=label_encoder, generator=generator)
        norm = self.hparams.get("normalizer")
        self.normalizer = norm if isinstance(norm, InputNormalization) \
            else InputNormalization(device=device)
        self.normalizer.ensure_size(self.hparams["input_size"])
        self.adopt_modules(modules)
