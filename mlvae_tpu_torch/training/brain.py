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

Data and tensor parallelism (``--data_parallel``, ``--tensor_parallel``,
``--zero1``) run on the ranks that ``parallel.mesh.launch`` starts
(``cli.train`` and ``cli.test`` start them); ``self.mesh`` is the rank's
place, and one process is a mesh of one rank (``mesh.solo``), whose
collectives return their input: one process and the ranks run one step.
A step on N data ranks gives what one process gives on the same padded
global batch with the same seed (up to the order of float sums):

* the global batch is padded to a multiple of the data axis by repeating
  its last row (``pad_batch``, the JAX Brain's ``to_device_batch``), and
  each rank runs the forward on its rows at the global T
  (``shard_batch``), so the kernels' routes are those of a one-process
  run at B/N;
* the step's draws are the global batch's, from the replayed
  ``noise_source`` or drawn from ``self.generator`` at the global shapes
  in the order of ``step_draws`` (``draw_noise``: one process and every
  rank draw the same), and each rank takes its rows (``local_noise``);
* the predictions are all-gathered over the data group before
  ``compute_objectives`` (``gather_predictions``, differentiable: the
  backward hands each rank its rows' gradient), so every masked mean
  takes the global normaliser and every rank holds the global loss; the
  normalizer and the wav2vec2 whole-tensor norms reduce over the data
  group in the forward;
* each module's flat gradient is reduce-scattered over the data group,
  the global norm summed from the pieces, and the clip, the non-finite
  skip and the inactive-module rule decided from global values, so every
  rank takes the same decisions; then the pieces are all-gathered and
  every rank runs the optimizer (replicated), or each rank runs it on its
  piece and the update is all-gathered (``--zero1``,
  ``parallel/zero1.py``). Tensor-split modules all-reduce their shards'
  gradients over the data group instead.

At evaluation the gathered predictions are trimmed of the padding rows
before ``evaluate_predictions`` (``trim_replica_padding``). Rank 0 alone
writes (``is_writer``).

The JAX Brain's run options:

* ``--cache_device_batches`` (on by default) keeps each batch's device
  copy, ``pad_batch(to_device_batch(prepare_batch(b)))`` as
  ``augment_device_batch`` leaves it, keyed by its utterance ids and the
  keys the step reads, under ``--device_batch_cache_mb`` (2048), a budget
  that ``_autoscale_cache_budget`` shrinks where the model's state needs
  most of the card (``torch.cuda.mem_get_info``; ``MLVAE_HBM_BYTES`` off
  the card, ``MLVAE_HBM_TIGHT`` forcing the tight mode either way). No
  step writes into a batch in place, so a cached batch serves every
  epoch.
* ``--scan_epoch`` (off under ``--debug`` and without the cache) runs
  each TRAIN, VALID and TEST epoch in runs of at most ``--scan_chunk``
  (32) consecutive same-shape batches, in the per-batch loop's order with
  its draws, one wait for the card a chunk (for the chunk ``depth`` back:
  3, or 1 in the tight mode) and the VALID / TEST host hooks
  (``evaluate_predictions``) replayed per batch after their chunk. On the
  card each step of a run is a CUDA graph (``training/step_graphs.py``)
  captured at the second batch of its shapes, stage, target and epoch and
  replayed; an epoch's graphs share one memory pool and the
  ``STEP_GRAPHS_KEPT`` most recently used stay. A replay copies its batch
  from the device-batch cache into the graph's inputs, so the JAX Brain's
  stacked-input cache (its ``lax.scan`` reads a run as one (K, ...)
  stack) has no counterpart here. On the CPU, and over gloo (whose
  collectives cannot be captured), the same chunks run eagerly
  (``scan_dispatch``).
* ``--async_ckpt`` sets the checkpointer's worker-thread saver
  (``training/checkpointer.py``); ``fit`` waits at each TRAIN epoch until
  no snapshot's copy can see the epoch's in-place updates
  (``wait_device_release``) and closes the checkpointer at its end, also
  when it raises.
* ``--profile`` traces epoch 1's TRAIN stage with ``torch.profiler`` into
  ``<output_dir>/profile/`` and appends each epoch's step times to
  ``<output_dir>/step_times.jsonl`` (``utils/profiling.py``).
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import OrderedDict, deque
from enum import Enum, auto
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mlvae_tpu_torch.data.batch import DataLoader, prefetch
from mlvae_tpu_torch.parallel import mesh as M
from mlvae_tpu_torch.parallel import zero1
from mlvae_tpu_torch.training.step_graphs import (StepGraph, clone_tree,
                                                  tree_signature)
from mlvae_tpu_torch.utils.profiling import StepTimer, trace

logger = logging.getLogger(__name__)

# the step graphs a scanned epoch keeps, the most recently used
STEP_GRAPHS_KEPT = 8


class Stage(Enum):
    TRAIN = auto()
    VALID = auto()
    TEST = auto()


def batch_feats(batch):
    """A batch's (features, relative lengths): ``feat``, or ``kaldi_feat``
    in a batch without it (the JAX Brain's fallback)."""
    return batch["feat"] if "feat" in batch else batch["kaldi_feat"]


def draw_noise(draws: List, generator: Optional[torch.Generator],
               device) -> Dict:
    """Named draws (``Brain.draws``' list) made from ``generator``: a
    dropout mask, or a name that repeats, goes into a list; a
    ``bernoulli_split`` draw is a list of masks, one a shape."""
    from mlvae_tpu_torch.nn.dist import gumbel_noise
    names = [d[0] for d in draws]
    noise: Dict = {}
    kw = dict(generator=generator, device=device)
    for name, kind, shape, keep, dtype in draws:
        if kind == "bernoulli_split":
            noise[name] = [torch.rand(sh, **kw) < k
                           for sh, k in zip(shape, keep)]
            continue
        if kind == "bernoulli":
            v = torch.rand(shape, **kw) < keep
        elif kind == "uniform":
            v = torch.rand(shape, **kw)
        elif kind == "normal":
            v = torch.randn(shape, **kw)
        elif kind == "gumbel":
            v = gumbel_noise(shape, dtype=dtype, **kw)
        else:
            raise ValueError(f"unknown draw kind {kind!r} of {name!r}")
        if kind == "bernoulli" or names.count(name) > 1:
            noise.setdefault(name, []).append(v)
        else:
            noise[name] = v
    return noise


def _draw_shapes(draws: List) -> Dict[str, List[tuple]]:
    """name -> the shapes of its draws in order (a ``bernoulli_split``
    draw gives one a mask)."""
    out: Dict[str, List[tuple]] = {}
    for name, kind, shape, _, _ in draws:
        if kind == "bernoulli_split":
            out.setdefault(name, []).extend(tuple(s) for s in shape)
        else:
            out.setdefault(name, []).append(tuple(shape))
    return out


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


def _batch_signature(dev: Dict):
    """A device batch's keys, shapes and dtypes (its ids aside)."""
    return tree_signature({k: v for k, v in dev.items() if k != "id"})


def _tree_bytes(tree) -> int:
    """The bytes of a nested dict / list / tuple's tensors."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


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
        if checkpointer is not None and "async_ckpt" in self.run_opts:
            checkpointer.async_save = bool(self.run_opts["async_ckpt"])
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
        # data / tensor parallelism: this rank's place in the mesh (one
        # process: a mesh of one rank)
        self.mesh = M.solo()
        tp = int(self.run_opts.get("tensor_parallel") or 1)
        if self.run_opts.get("data_parallel", False) or tp > 1:
            self.mesh = M.current()
            if self.mesh is None:
                raise RuntimeError(
                    "--data_parallel / --tensor_parallel run on the ranks "
                    "that parallel.mesh.launch starts (cli.train and "
                    "cli.test start them)")
            if self.mesh.n_model != tp:
                raise ValueError(f"the mesh's model axis is "
                                 f"{self.mesh.n_model}, the run asks for "
                                 f"--tensor_parallel {tp}")
        self.zero1 = bool(self.run_opts.get("zero1", False))
        self.ckpt_opt_state = bool(self.run_opts.get("ckpt_opt_state", True))
        # (optimizer name, module) pairs whose moments are ZeRO-1 pieces
        self.zero1_keys: set = set()
        self._placed = False
        # the device-batch cache, the scanned epoch and the profiler
        self.cache_device_batches = bool(self.run_opts.get(
            "cache_device_batches", True))
        self._dev_batch_cache: Dict = {}
        self._dev_batch_cache_bytes = 0
        self.device_batch_cache_limit = int(self.run_opts.get(
            "device_batch_cache_mb", 2048)) * 1024 * 1024
        self._hbm_tight = False
        self.scan_epoch = bool(self.run_opts.get("scan_epoch", False))
        self.scan_chunk = int(self.run_opts.get("scan_chunk", 32) or 32)
        self._graphs: OrderedDict = OrderedDict()
        self._graph_pool = None
        self._warm: set = set()
        self._scan_logged = False
        # captures and replays of the card's step graphs, eager steps
        self.scan_stats = {"captures": 0, "replays": 0, "eager": 0,
                           "waits": 0}
        self.profile = bool(self.run_opts.get("profile", False))
        self._fitting = False

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
        features' B and T (none where the recipe has no ``draws``)."""
        if type(self).draws is Brain.draws:
            return []
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
        self.place_on_mesh()
        self.init_optimizers()
        self.setup_zero1()

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

    # -- data and tensor parallelism -------------------------------------
    @property
    def is_writer(self) -> bool:
        """Whether this process writes logs, checkpoints and outputs: rank
        0 of a mesh, or the one process."""
        return self.mesh.is_writer

    def tp_split_dims(self) -> Dict[str, int]:
        """Tensor-split parameter (full name) -> its split dim, from the
        modules' placement hook ``tensor_parallel_splits`` (the JAX
        modules' ``partition_specs``); empty without a model axis."""
        if self.mesh.n_model == 1:
            return {}
        out = {}
        for name, mod in self.named_children():
            if hasattr(mod, "tensor_parallel_splits"):
                out.update({f"{name}.{k}": d for k, d in
                            mod.tensor_parallel_splits().items()})
        return out

    def tp_modules(self) -> set:
        return {k.split(".")[0] for k in self.tp_split_dims()}

    def place_on_mesh(self) -> None:
        """Rank 0's parameters and buffers on every rank, then the
        tensor-split modules cut to this rank's shards (once)."""
        if self.mesh.world == 1 or self._placed:
            return
        M.replicate(list(self.parameters()) + list(self.buffers()))
        if self.mesh.n_model > 1:
            for name, mod in self.named_children():
                if hasattr(mod, "split_for_tp"):
                    mod.split_for_tp(self.mesh)
                    logger.info("tensor-parallel placement for module %r "
                                "(model axis %d)", name, self.mesh.n_model)
        self._placed = True

    def setup_zero1(self) -> None:
        """Under ``--zero1``, cut the moments of every module that is not
        tensor-split into this rank's pieces (``parallel/zero1.py``)."""
        self.zero1_keys = set()
        if not self.zero1:
            return
        if self.mesh.n_data <= 1:
            logger.warning("--zero1 requested but this run has no data axis "
                           "above 1; optimizer-state sharding is inactive")
            return
        tp_mods = self.tp_modules()
        for name, (opt, module_names) in self.optimizers.items():
            for mk in self._opt_module_keys(module_names):
                if mk in tp_mods:
                    continue
                zero1.shard_state(self.opt_states[name][mk], opt.MOMENTS,
                                  self.mesh)
                self.zero1_keys.add((name, mk))
        logger.info("ZeRO-1: optimizer state split over the %d-way data "
                    "axis for %d (optimizer, module) pairs",
                    self.mesh.n_data, len(self.zero1_keys))

    def full_state_dict(self, prefixes=None) -> Dict[str, torch.Tensor]:
        """``state_dict`` (its keys under ``prefixes``, all without) with
        every tensor-split parameter whole again (a collective over the
        model group under a model axis)."""
        from mlvae_tpu_torch.parallel.tp import unshard
        sd = {k: v for k, v in self.state_dict().items()
              if prefixes is None or any(k.startswith(p) for p in prefixes)}
        for key, dim in self.tp_split_dims().items():
            if key in sd:
                sd[key] = unshard(sd[key], dim, self.mesh)
        return sd

    def local_state_dict(self, sd: Dict[str, torch.Tensor]) -> Dict:
        """A whole ``state_dict`` cut to this rank's tensor-split shards."""
        from mlvae_tpu_torch.parallel.tp import shard
        sd = dict(sd)
        for key, dim in self.tp_split_dims().items():
            if key in sd:
                sd[key] = shard(sd[key], dim, self.mesh.n_model,
                                self.mesh.model_rank)
        return sd

    def _moment_layout(self, mk: str):
        """(parameter name, this rank's shape, split dim or None) per
        parameter of module ``mk``, in the order of its flat moments."""
        dims = self.tp_split_dims()
        return [(n, tuple(p.shape), dims.get(f"{mk}.{n}"))
                for n, p in getattr(self, mk).named_parameters()]

    def full_moment(self, name: str, mk: str, key: str) -> torch.Tensor:
        """Moment ``key`` of optimizer ``name``'s state of module ``mk``,
        flat over the whole parameters (ZeRO-1 pieces and tensor-split
        shards gathered: a collective under a mesh)."""
        from mlvae_tpu_torch.parallel.tp import unshard
        flat = self.opt_states[name][mk][key]
        layout = self._moment_layout(mk)
        if (name, mk) in self.zero1_keys:
            n = sum(int(np.prod(s)) for _, s, _ in layout)
            flat = zero1.gather_flat(flat, n, self.mesh)
        if all(d is None for _, _, d in layout):
            return flat
        parts, off = [], 0
        for _, shape, dim in layout:
            k = int(np.prod(shape))
            t = flat[off:off + k].view(shape)
            off += k
            parts.append((unshard(t, dim, self.mesh) if dim is not None
                          else t).reshape(-1))
        return torch.cat(parts)

    def set_full_moment(self, name: str, mk: str, key: str,
                        flat: torch.Tensor) -> None:
        """The inverse of ``full_moment``: a whole flat moment cut to this
        rank's shards and piece, into the state."""
        from mlvae_tpu_torch.parallel.tp import shard
        state = self.opt_states[name][mk]
        flat = flat.to(device=state[key].device, dtype=state[key].dtype)
        layout = self._moment_layout(mk)
        if any(d is not None for _, _, d in layout):
            n_model, m = self.mesh.n_model, self.mesh.model_rank
            parts, off = [], 0
            for _, shape, dim in layout:
                full = list(shape)
                if dim is not None:
                    full[dim] *= n_model
                k = int(np.prod(full))
                t = flat[off:off + k].view(full)
                off += k
                parts.append((shard(t, dim, n_model, m) if dim is not None
                              else t).reshape(-1))
            flat = torch.cat(parts)
        if (name, mk) in self.zero1_keys:
            flat = zero1.split_flat(flat, self.mesh)
        state[key].copy_(flat)

    def moment_shard_fraction(self) -> float:
        """The share of the optimizer moments' bytes this rank holds."""
        mods = self.param_modules()
        return zero1.moment_shard_fraction(
            (self.opt_states[name][mk], opt.MOMENTS,
             sum(p.numel() for p in mods[mk].parameters()))
            for name, (opt, names) in self.optimizers.items()
            for mk in self._opt_module_keys(names))

    def pad_batch(self, batch: Dict) -> Dict:
        """The batch padded to a multiple of the data axis by repeating its
        last row (ids too); unchanged on one data rank."""
        n = self.mesh.n_data
        if n == 1:
            return batch
        out = {}
        for key, value in batch.items():
            if key == "id":
                ids = list(value)
                out[key] = ids + ids[-1:] * ((-len(ids)) % n)
            else:
                out[key] = tuple(M.pad_rows(v, n) for v in value)
        return out

    def local_noise(self, batch: Dict, local: Dict, train: bool,
                    noise: Dict) -> Dict:
        """This rank's rows of the global batch's draws ``noise``. A
        draw's batch axis is the one whose size differs between the global
        and the local draws."""
        g_shapes = _draw_shapes(self.step_draws(batch, train))
        l_shapes = _draw_shapes(self.step_draws(local, train))
        n, r = self.mesh.n_data, self.mesh.data_rank

        def rows(v, gs, ls):
            axes = [i for i, (a, b) in enumerate(zip(gs, ls)) if a != b]
            if not axes:
                return v
            if len(axes) > 1 or gs[axes[0]] != ls[axes[0]] * n:
                raise ValueError(f"draw of shape {gs} has no batch axis of "
                                 f"the local shape {ls}")
            return v.narrow(axes[0], r * ls[axes[0]], ls[axes[0]])

        out = {}
        for name, value in noise.items():
            if name not in g_shapes:
                out[name] = value
                continue
            vals = value if isinstance(value, list) else [value]
            got = [rows(v, gs, ls) for v, gs, ls in
                   zip(vals, g_shapes[name], l_shapes[name])]
            out[name] = got if isinstance(value, list) else got[0]
        return out

    def gather_predictions(self, preds, n_local: int):
        """Every tensor of the predictions all-gathered over the data group
        along its batch axis (the first); differentiable."""
        if isinstance(preds, dict):
            return {k: self.gather_predictions(v, n_local)
                    for k, v in preds.items()}
        if isinstance(preds, (list, tuple)):
            return type(preds)(self.gather_predictions(v, n_local)
                               for v in preds)
        if isinstance(preds, torch.Tensor):
            if preds.dim() == 0 or preds.shape[0] != n_local:
                raise ValueError(
                    f"a prediction of shape {tuple(preds.shape)} is not "
                    f"batch-major over this rank's {n_local} rows; data "
                    "parallelism gathers the predictions along their first "
                    "axis")
            return M.gather_rows(preds, self.mesh)
        return preds

    def trim_replica_padding(self, preds, n: int):
        """The predictions of the ``n`` real rows (the JAX Brain's
        ``_trim_replica_padding``): the padding rows off every tensor whose
        first axis is the padded batch."""
        padded = M.padded_rows(n, self.mesh.n_data)
        if padded == n:
            return preds
        if isinstance(preds, dict):
            return {k: self.trim_replica_padding(v, n)
                    for k, v in preds.items()}
        if isinstance(preds, torch.Tensor) and preds.dim() >= 1 \
                and preds.shape[0] == padded:
            return preds[:n]
        return preds

    def _local_forward(self, batch: Dict, noise, generator, train: bool,
                       fn: Callable):
        """``fn(batch, noise, generator)`` on this rank's rows of the padded
        global batch, its predictions gathered over the data group. The
        draws are the global batch's, one process and every rank alike:
        ``noise``, or made from ``generator`` at the global shapes in the
        order of ``step_draws`` (``draw_noise``)."""
        batch = self.pad_batch(batch)
        if noise is None:
            noise = draw_noise(self.step_draws(batch, train), generator,
                               self.device)
        if self.mesh.n_data == 1:
            return fn(batch, noise, generator)
        local = M.shard_batch(batch, self.mesh)
        noise = self.local_noise(batch, local, train, noise)
        n_local = batch_feats(local)[0].shape[0]
        return self.gather_predictions(fn(local, noise, generator), n_local)

    def _reduce_grads(self, grads: Dict, loss: torch.Tensor):
        """The gradient rule (see the module docstring): (each module's
        gradient as this rank holds it after the reduction, the global
        norm, whether each module's gradient has a nonzero anywhere)."""
        mesh, tp_mods = self.mesh, self.tp_modules()
        tp_dims = self.tp_split_dims()
        red, data_sq, data_nz, model_sq, model_nz = {}, [], [], [], []
        rep_sq = []
        for mk, g in grads.items():
            if g is None:
                continue
            if mk in tp_mods:
                g = M.all_reduce(g, mesh.data_group)
                split = self._split_mask(mk, tp_dims, g)
                model_sq.append((g * g * split).sum())
                rep_sq.append((g * g * (1 - split)).sum())
                model_nz.append((g != 0).any().float())
            else:
                g = zero1.reduce_scatter_grad(g, mesh)
                data_sq.append((g * g).sum())
                data_nz.append((g != 0).any().float())
            red[mk] = g
        zero = torch.zeros((), device=loss.device)
        dv = M.all_reduce(torch.stack(data_sq + data_nz), mesh.data_group) \
            if data_sq else None
        mv = M.all_reduce(torch.stack(model_sq + model_nz),
                          mesh.model_group) if model_sq else None
        sq = [dv[:len(data_sq)].sum() if dv is not None else zero,
              mv[:len(model_sq)].sum() if mv is not None else zero,
              torch.stack(rep_sq).sum() if rep_sq else zero]
        gnorm = torch.stack(sq).sum().sqrt()
        flags = iter(list(dv[len(data_sq):]) if dv is not None else [])
        tflags = iter(list(mv[len(model_sq):]) if mv is not None else [])
        active = {mk: next(tflags if mk in tp_mods else flags) > 0
                  for mk in red}
        return red, gnorm, active

    def _split_mask(self, mk: str, tp_dims: Dict, g: torch.Tensor):
        """1 on the flat gradient's elements of module ``mk``'s
        tensor-split parameters, 0 on its replicated ones."""
        parts = [torch.full((p.numel(),), float(f"{mk}.{n}" in tp_dims),
                            device=g.device, dtype=g.dtype)
                 for n, p in getattr(self, mk).named_parameters()]
        return torch.cat(parts)

    # -- the step ----------------------------------------------------------
    def train_step(self, batch: Dict, epoch: int,
                   noise: Optional[Dict] = None,
                   generator: Optional[torch.Generator] = None):
        """One fused step; returns (loss, losses), detached. Afterwards each
        reached parameter's ``.grad`` holds the gradient as applied:
        clipped, or zeros after a non-finite step (None under ``--zero1``,
        where a rank holds only its piece). ``batch`` and ``noise`` are the
        global batch's."""
        for p in self.parameters():
            p.grad = None
        kwargs = dict(train=True, epoch=epoch)

        def forward(b, nz, gen):
            if self.auto_mix_prec:
                params = {name: p.to(torch.bfloat16) if p.is_floating_point()
                          else p for name, p in self.named_parameters()}
                return cast_floats(functional_call(
                    self, params, (cast_floats(b, torch.bfloat16, 2),),
                    dict(kwargs, noise=nz, generator=gen)), torch.float32)
            return self.compute_forward(b, noise=nz, generator=gen,
                                        **kwargs)

        with (f32_gemm_sums() if self.auto_mix_prec
              else contextlib.nullcontext()):
            preds = self._local_forward(batch, noise, generator, True,
                                        forward)
            loss, losses = self.compute_objectives(preds,
                                                   self.pad_batch(batch))
            loss.backward()

        modules = self.param_modules()
        grads: Dict[str, Optional[torch.Tensor]] = {}
        for mk, mod in modules.items():
            ps = list(mod.parameters())
            grads[mk] = None if all(p.grad is None for p in ps) else \
                torch.cat([(p.grad if p.grad is not None
                            else torch.zeros_like(p)).reshape(-1)
                           for p in ps])
        self._update(modules, grads, loss)
        return loss.detach(), {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def _update(self, modules: Dict, grads: Dict, loss: torch.Tensor
                ) -> None:
        """The optimizers' step on the reduced gradients, replicated or
        ZeRO-1."""
        from mlvae_tpu_torch.training.optim import scatter_flat
        red, gnorm, active = self._reduce_grads(grads, loss)
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        clip = torch.clamp(self.max_grad_norm / (gnorm + 1e-12), max=1.0)
        zero1_mods = {mk for _, mk in self.zero1_keys}
        tp_mods = self.tp_modules()
        full = {}
        for mk, g in red.items():
            # REPLACE on a non-finite step: NaN * 0 would stay NaN
            red[mk] = torch.where(finite, g * clip, torch.zeros_like(g))
            # a module whose applied gradient is all zero (its losses
            # detached, or the step non-finite) is inactive
            active[mk] = active[mk] & finite
            params = list(modules[mk].parameters())
            if mk in zero1_mods:
                for p in params:
                    p.grad = None
                continue
            n = sum(p.numel() for p in params)
            g = red[mk] if mk in tp_mods else \
                M.all_gather_cat(red[mk], self.mesh.data_group)[:n]
            full[mk] = g
            offset = 0
            for p in params:
                p.grad = g[offset:offset + p.numel()].view_as(p)
                offset += p.numel()
        for name in sorted(self.optimizers):
            opt, module_names = self.optimizers[name]
            for mk in self._opt_module_keys(module_names):
                if mk not in red:   # never reached: all zero, inactive
                    continue
                params = list(modules[mk].parameters())
                state = self.opt_states[name][mk]
                if (name, mk) in self.zero1_keys:
                    n = sum(p.numel() for p in params)
                    update = zero1.gather_flat(
                        opt.delta(red[mk], state, active[mk]), n, self.mesh)
                    scatter_flat(params, update)
                else:
                    opt.step(params, full[mk], state, active=active[mk])

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

    def augment_device_batch(self, dev: Dict) -> Dict:
        """Hook: a recipe may add tensors derived from the device batch
        before it is cached (the w2v recipes' frozen-trunk features,
        ``models/w2v_common.py``); deterministic in the batch, since the
        result serves every epoch."""
        return dev

    def _cached_device_batch(self, batch) -> Dict:
        """``pad_batch(to_device_batch(batch))`` as ``augment_device_batch``
        leaves it, from the device-batch cache where it is on (keyed by
        the utterance ids and the keys the step reads, under
        ``device_batch_cache_limit`` bytes)."""
        if not self.cache_device_batches:
            return self.augment_device_batch(
                self.pad_batch(self.to_device_batch(batch)))
        used = self.used_batch_keys()
        key = (tuple(batch["id"]),
               tuple(sorted(used)) if used is not None else None)
        hit = self._dev_batch_cache.get(key)
        if hit is not None:
            return hit
        dev = self.augment_device_batch(
            self.pad_batch(self.to_device_batch(batch)))
        nbytes = _tree_bytes(dev)
        if self._dev_batch_cache_bytes + nbytes \
                <= self.device_batch_cache_limit:
            self._dev_batch_cache[key] = dev
            self._dev_batch_cache_bytes += nbytes
        return dev

    def _autoscale_cache_budget(self) -> None:
        """Shrink the device-batch cache budget where the model's state
        needs most of the card, and decide the tight mode (depth-1 scanned
        dispatch), as the JAX Brain does: the state's reserve is 4.5x the
        parameters' bytes and 2 GiB, tight where it passes 3/5 of the
        card, and the cache takes half of what is left (the JAX Brain's
        device-batch and stacked-input caches share that half). The
        card's memory comes from ``torch.cuda.mem_get_info``; off the card
        from ``MLVAE_HBM_BYTES`` (nothing to do without it).
        ``MLVAE_HBM_TIGHT`` forces the tight mode either way."""
        env = os.environ.get("MLVAE_HBM_TIGHT")
        if env is not None:
            self._hbm_tight = env.strip().lower() in ("1", "true", "yes")
        param_bytes = sum(p.numel() * p.element_size()
                          for p in self.parameters())
        dev = self.device
        if dev.type == "cuda":
            hbm = int(torch.cuda.mem_get_info(dev)[1])
        else:
            hbm = int(os.environ.get("MLVAE_HBM_BYTES") or 0)
            if not hbm:
                return
        reserve = 9 * param_bytes // 2 + 2 * 1024 ** 3
        if env is None:
            self._hbm_tight = reserve > (hbm * 3) // 5
        if self._hbm_tight:
            logger.info(
                "HBM-tight mode: depth-1 scan dispatch, single-snapshot "
                "async-ckpt queue (state reserve %d MiB vs HBM %d MiB)",
                reserve >> 20, hbm >> 20)
        budget = max(0, (hbm - reserve) // 2)
        if budget < self.device_batch_cache_limit:
            logger.info(
                "device batch cache budget %d -> %d MiB "
                "(params %d MiB, HBM %d MiB)",
                self.device_batch_cache_limit >> 20, budget >> 20,
                param_bytes >> 20, hbm >> 20)
            self.device_batch_cache_limit = int(budget)

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
        dev_batch = self._cached_device_batch(batch)
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
        preds = self._local_forward(
            dev_batch, noise, generator, False,
            lambda b, nz, gen: self.compute_forward(b, noise=nz,
                                                    generator=gen,
                                                    epoch=epoch))
        loss, losses = self.compute_objectives(preds,
                                               self.pad_batch(dev_batch))
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
        dev_batch = self._cached_device_batch(batch)
        self._batch_ids = batch["id"]
        preds, loss, losses = self.eval_forward(
            dev_batch, self.current_epoch(),
            noise=self._next_noise(dev_batch, False),
            generator=self.generator)
        self._record_losses(losses)
        self.evaluate_predictions(
            self.trim_replica_padding(preds, len(batch["id"])), batch, stage)
        return float(loss)

    def fit(self, epoch_counter, train_set, valid_set=None,
            train_loader_kwargs=None, valid_loader_kwargs=None,
            progressbar=None):
        # the fit scope: derived batches (the frozen-trunk features) are
        # cached only where batches come back every epoch
        self._fitting = True
        try:
            self.on_fit_start()
            self._autoscale_cache_budget()
            train_loader = self.make_dataloader(
                train_set, Stage.TRAIN, **(train_loader_kwargs or {}))
            valid_loader = None
            if valid_set is not None:
                valid_loader = self.make_dataloader(
                    valid_set, Stage.VALID, **(valid_loader_kwargs or {}))
            self.step_timer = StepTimer(hop_seconds=float(
                self.hparams.get("hop_length", 20)) / 1000.0)
            self._fit_epochs(epoch_counter, train_loader, valid_loader)
        except BaseException:
            # pending async saves persist all the same; the original
            # error is never masked by the flush's
            try:
                self.on_fit_end()
            except Exception:
                logger.exception("on_fit_end after fit failure")
            raise
        else:
            self.on_fit_end()
        finally:
            self._fitting = False

    def on_fit_end(self):
        """Flush the checkpointer's pending saves and stop its worker."""
        if self.checkpointer is not None and hasattr(self.checkpointer,
                                                     "close"):
            self.checkpointer.close()

    def use_scan(self) -> bool:
        """Whether this stage's epoch is scanned: ``--scan_epoch`` with the
        device-batch cache, off under ``--debug``."""
        return self.scan_epoch and self.cache_device_batches \
            and not self.debug

    def _fit_epochs(self, epoch_counter, train_loader, valid_loader):
        hop_s = float(self.hparams.get("hop_length", 20)) / 1000.0
        self.epoch_log: List[Dict] = []
        out_dir = self.hparams.get("output_dir")
        for epoch in epoch_counter:
            self.train()
            self.on_stage_start(Stage.TRAIN, epoch)
            # the epoch's steps update parameters and moments in place: an
            # async snapshot's copy must not see them
            waiter = getattr(self.checkpointer, "wait_device_release", None)
            if waiter is not None:
                waiter()
            self.step_timer.reset()
            t0 = time.time()
            use_scan = self.use_scan()
            tracing = self.profile and epoch == 1 and out_dir is not None
            with trace(Path(out_dir or ".") / "profile", enabled=tracing):
                if use_scan:
                    self.avg_train_loss, frames, n = \
                        self._fit_epoch_scanned(train_loader, epoch)
                else:
                    losses, frames = [], 0
                    for i, batch in enumerate(prefetch(train_loader)):
                        self.step_timer.start()
                        losses.append(self.train_batch(batch, epoch))
                        feats, lens = batch_feats(batch)
                        f = int(np.round(np.asarray(lens)
                                         * feats.shape[1]).sum())
                        self.step_timer.stop(f)
                        frames += f
                        if self.debug and i + 1 >= self.debug_batches:
                            break
                    n = len(losses)
                    # the epoch's one wait for the card
                    self.avg_train_loss = float(np.mean(
                        [float(l) for l in losses])) if losses else 0.0
            wall = time.time() - t0
            rate = frames * hop_s / max(wall, 1e-9)
            logger.info("epoch %d train: %.4f (%.1fs, %.0f utt-sec/sec)",
                        epoch, self.avg_train_loss, wall, rate)
            self.epoch_log.append({"epoch": epoch, "loss": self.avg_train_loss,
                                   "seconds": wall, "utt_sec_per_sec": rate,
                                   "batches": n})
            if self.profile and out_dir is not None and self.is_writer:
                self.step_timer.write(Path(out_dir) / "step_times.jsonl")
            self.on_stage_end(Stage.TRAIN, self.avg_train_loss, epoch)

            if valid_loader is not None:
                self.eval()
                self.on_stage_start(Stage.VALID, epoch)
                tv = time.time()
                if self.use_scan():
                    avg = self._eval_epoch_scanned(valid_loader, Stage.VALID)
                else:
                    vlosses = []
                    for i, batch in enumerate(prefetch(valid_loader)):
                        vlosses.append(self.evaluate_batch(batch,
                                                           Stage.VALID))
                        if self.debug and i + 1 >= self.debug_batches:
                            break
                    avg = float(np.mean(vlosses)) if vlosses else 0.0
                logger.info("epoch %d valid: %.4f (%.1fs)", epoch, avg,
                            time.time() - tv)
                self.epoch_log[-1]["valid_loss"] = avg
                self.on_stage_end(Stage.VALID, avg, epoch)

    # -- the scanned epoch ------------------------------------------------
    def scan_dispatch(self) -> str:
        """How a scanned epoch's steps run: ``"graph"`` (CUDA graphs) on
        the card, ``"eager"`` on the CPU and over gloo."""
        if self.device.type != "cuda" or (self.mesh.world > 1
                                          and self.mesh.backend == "gloo"):
            return "eager"
        return "graph"

    def _scan_depth(self) -> int:
        """Chunks in flight before the loop waits for the oldest: 3, or 1
        in the tight mode."""
        return 1 if self._hbm_tight else 3

    def _graph_key(self, kind: str, stage: Stage, sig, epoch: int, noise):
        """What a step graph bakes in: the batch's and the draws' shapes,
        the stage, the recipe's target, the epoch (KLD annealing, the
        normalizer's update) and the modules' mode."""
        return (kind, stage, sig, tree_signature(noise), epoch,
                getattr(self, "target", None),
                getattr(self, "training_type", None), self.training)

    def _reset_graphs(self) -> None:
        self._graphs.clear()
        self._warm.clear()
        self._graph_pool = None

    def _scan_step(self, kind: str, stage: Stage, sig, epoch: int,
                   dev: Dict, fn: Callable):
        """One step of a scanned epoch: its draws (replayed or from the
        generator, in the per-batch loop's order), then ``fn(batch,
        noise)`` eagerly, or on the card through its step graph (eager the
        first time a key is seen, captured the second time, replayed
        after); the outputs cloned."""
        train = kind == "train"
        noise = self._next_noise(dev, train)
        if noise is None:
            noise = draw_noise(self.step_draws(dev, train), self.generator,
                               self.device)
        mode = self.scan_dispatch()
        if not self._scan_logged:
            self._scan_logged = True
            logger.info("--scan_epoch: %s dispatch (%s)", mode,
                        "CUDA graphs of the steps" if mode == "graph"
                        else "the chunks' steps run eagerly: no CUDA "
                        "graphs on this device or process group")
        if mode == "eager":
            self.scan_stats["eager"] += 1
            return fn(dev, noise)
        key = self._graph_key(kind, stage, sig, epoch, noise)
        graph = self._graphs.get(key)
        if graph is None and key not in self._warm:
            self._warm.add(key)
            self.scan_stats["eager"] += 1
            return fn(dev, noise)
        if graph is None:
            # the epoch's graphs share one memory pool: each replay's
            # outputs are cloned before any other graph replays
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = StepGraph(fn, (dev, noise), pool=self._graph_pool)
            self._graphs[key] = graph
            if len(self._graphs) > STEP_GRAPHS_KEPT:
                self._graphs.popitem(last=False)
            self.scan_stats["captures"] += 1
        else:
            self._graphs.move_to_end(key)
        out = graph(dev, noise)
        self.scan_stats["replays"] += 1
        if train:
            # the graph's gradients are its pool's temporaries, which the
            # next replay of any graph rewrites
            for p in self.parameters():
                p.grad = None
        return clone_tree(out)

    def _scan_wait(self, pending: deque) -> None:
        """Bound the chunks in flight: wait for the chunk ``depth`` back."""
        depth = self._scan_depth()
        if len(pending) >= depth:
            marker = pending[-depth]
            if isinstance(marker, torch.cuda.Event):
                marker.synchronize()
            self.scan_stats["waits"] += 1

    def _chunk_marker(self):
        """What marks a chunk's end on the device (None off the card)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _fit_epoch_scanned(self, train_loader, epoch: int):
        """One TRAIN epoch in runs of at most ``scan_chunk`` consecutive
        same-shape batches (see the module docstring): the per-batch loop's
        batches, order, draws and steps, one wait a chunk. Returns (mean
        train loss, frames, batches)."""
        self._reset_graphs()
        losses: List = []
        markers: deque = deque()
        frames = 0
        step_fn = (lambda b, nz: self.train_step(b, epoch, noise=nz,
                                                 generator=self.generator))

        def dispatch(run, sig):
            for dev, f in run:
                self.step_timer.start()
                self._batch_ids = dev["id"]
                loss, step_losses = self._scan_step(
                    "train", Stage.TRAIN, sig, epoch, dev, step_fn)
                self.step += 1
                losses.append((loss, step_losses))
                self.step_timer.stop(f)
            markers.append(self._chunk_marker())
            self._scan_wait(markers)

        run: List = []
        run_sig = None
        for batch in train_loader:
            prepared = self.prepare_batch(batch)
            dev = self._cached_device_batch(prepared)
            feats, lens = batch_feats(batch)
            f = int(np.round(np.asarray(lens) * feats.shape[1]).sum())
            frames += f
            sig = _batch_signature(dev)
            if run and (sig != run_sig or len(run) >= self.scan_chunk):
                dispatch(run, run_sig)
                run = []
            run_sig = sig
            run.append((dev, f))
        if run:
            dispatch(run, run_sig)
        # the epoch's one fetch of its losses
        values = [float(l) for l, _ in losses]
        for _, step_losses in losses:
            self._record_losses(step_losses)
        self._reset_graphs()
        mean = float(np.mean(values)) if values else 0.0
        return mean, frames, len(values)

    def _eval_epoch_scanned(self, loader, stage: Stage) -> float:
        """One VALID or TEST epoch in runs of at most ``scan_chunk``
        same-shape batches: one wait a chunk, whose host hooks
        (``evaluate_predictions``) replay per batch while the next chunk
        runs."""
        epoch = self.current_epoch()
        self._reset_graphs()
        losses_all: List[float] = []
        inflight: deque = deque()
        fn = (lambda b, nz: self.eval_forward(b, epoch, noise=nz,
                                              generator=self.generator))

        def dispatch(run, sig):
            outs = [self._scan_step("eval", stage, sig, epoch, dev, fn)
                    for dev, _ in run]
            inflight.append(([hb for _, hb in run], outs,
                             self._chunk_marker()))

        def drain():
            host_batches, outs, marker = inflight.popleft()
            if marker is not None:
                marker.synchronize()
            self.scan_stats["waits"] += 1
            for host_batch, (preds, loss, losses) in zip(host_batches, outs):
                self._batch_ids = host_batch["id"]
                self._record_losses(losses)
                self.evaluate_predictions(
                    self.trim_replica_padding(preds, len(host_batch["id"])),
                    host_batch, stage)
                losses_all.append(float(loss))

        run: List = []
        run_sig = None
        for batch in loader:
            prepared = self.prepare_batch(batch)
            dev = self._cached_device_batch(prepared)
            sig = _batch_signature(dev)
            if run and (sig != run_sig or len(run) >= self.scan_chunk):
                dispatch(run, run_sig)
                run = []
                while len(inflight) > 1:
                    drain()
            run_sig = sig
            run.append((dev, prepared))
        if run:
            dispatch(run, run_sig)
        while inflight:
            drain()
        self._reset_graphs()
        self._scanned_batches = len(losses_all)
        return float(np.mean(losses_all)) if losses_all else 0.0

    def evaluate(self, test_set, max_key=None, min_key=None,
                 test_loader_kwargs=None, progressbar=None) -> float:
        """The TEST pass from the best checkpoint by ``max_key`` /
        ``min_key``; ``self.evaluate_timing`` keeps the restore, eval and
        write seconds that the log line gives."""
        t0 = time.time()
        self.on_evaluate_start(max_key=max_key, min_key=min_key)
        self._autoscale_cache_budget()
        t_restore = time.time()
        self.eval()
        epoch = self.current_epoch()
        self.on_stage_start(Stage.TEST, epoch)
        loader = self.make_dataloader(test_set, Stage.TEST,
                                      **(test_loader_kwargs or {}))
        if self.use_scan():
            avg = self._eval_epoch_scanned(loader, Stage.TEST)
            batches = self._scanned_batches
        else:
            losses = []
            for i, batch in enumerate(prefetch(loader)):
                losses.append(self.evaluate_batch(batch, Stage.TEST))
                if self.debug and i + 1 >= self.debug_batches:
                    break
            avg = float(np.mean(losses)) if losses else 0.0
            batches = len(losses)
        t_eval = time.time()
        self.on_stage_end(Stage.TEST, avg, epoch)
        self.evaluate_timing = {"restore": t_restore - t0,
                                "eval": t_eval - t_restore,
                                "write": time.time() - t_eval,
                                "batches": batches}
        logger.info("evaluate timing: restore %.1fs, eval %.1fs, write "
                    "%.1fs", *(self.evaluate_timing[k]
                               for k in ("restore", "eval", "write")))
        return avg

