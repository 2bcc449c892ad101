"""Dotted-name resolution for the port's YAML loader (counterpart of
``mlvae_tpu/hyperyaml/registry.py``).

The recipes name torch and SpeechBrain classes (``!new:torch.nn.LSTM``,
``!new:speechbrain.processing.features.InputNormalization``) and the
repo's own modules by short prefixes (``!new:modules.fc_block.FCBlock``).
Every alias the JAX package's registry knows maps here onto a port target,
or raises ``NotImplementedError`` naming the ROADMAP item that ports it;
``register`` adds names of the caller's own.
A ``torch.*`` or ``speechbrain.*`` name without an alias is refused: it
never falls through to a plain import of the library class, and nothing
resolves into the JAX package.
"""
from __future__ import annotations

import importlib
import pydoc
from typing import Any, Dict, Optional

# exact dotted name -> dotted target in the port
ALIASES: Dict[str, str] = {
    # seeding / determinism (config/run.yaml)
    "torch.manual_seed": "mlvae_tpu_torch.utils.seed.manual_seed",
    "torch.use_deterministic_algorithms":
        "mlvae_tpu_torch.utils.seed.use_deterministic_algorithms",
    # core nn (models/MD_VAE/model.yaml)
    "torch.nn.LSTM": "mlvae_tpu_torch.nn.rnn.LSTM",
    "torch.nn.GRU": "mlvae_tpu_torch.nn.rnn.GRU",
    "torch.nn.LeakyReLU": "mlvae_tpu_torch.nn.layers.LeakyReLU",
    "torch.optim.Adam": "mlvae_tpu_torch.training.optim.Adam",
    "torch.optim.Adadelta": "mlvae_tpu_torch.training.optim.Adadelta",
    "torch.optim.SGD": "mlvae_tpu_torch.training.optim.SGD",
    # the SpeechBrain surface the recipes use
    "speechbrain.utils.epoch_loop.EpochCounter":
        "mlvae_tpu_torch.training.epoch_loop.EpochCounter",
    "speechbrain.utils.checkpoints.Checkpointer":
        "mlvae_tpu_torch.training.checkpointer.Checkpointer",
    "speechbrain.processing.features.InputNormalization":
        "mlvae_tpu_torch.nn.norm.InputNormalization",
    "speechbrain.lobes.features.Fbank": "mlvae_tpu_torch.ops.fbank.Fbank",
    # the CTC recipes (models/CRDNN_CTC/model.yaml)
    "speechbrain.nnet.linear.Linear": "mlvae_tpu_torch.nn.sb_compat.SBLinear",
    "speechbrain.nnet.activations.Softmax":
        "mlvae_tpu_torch.nn.sb_compat.Softmax",
    "speechbrain.nnet.schedulers.NewBobScheduler":
        "mlvae_tpu_torch.training.schedulers.NewBobScheduler",
    "speechbrain.nnet.losses.ctc_loss": "mlvae_tpu_torch.ops.ctc.ctc_loss",
    "speechbrain.lobes.models.CRDNN.CRDNN":
        "mlvae_tpu_torch.modules.crdnn.CRDNN",
    "speechbrain.lobes.models.VanillaNN.VanillaNN":
        "mlvae_tpu_torch.modules.crdnn.VanillaNN",
    # HMM_DNN_ALI (models/HMM_DNN_ALI/model.yaml)
    "speechbrain.nnet.losses.nll_loss": "mlvae_tpu_torch.ops.losses.nll_loss",
    "speechbrain.alignment.aligner.HMMAligner":
        "mlvae_tpu_torch.modules.hmm_aligner.HMMAligner",
    # the w2v recipes (models/w2v_MD_VAE/model.yaml)
    "speechbrain.lobes.models.huggingface_wav2vec.HuggingFaceWav2Vec2":
        "mlvae_tpu_torch.modules.wav2vec2.Wav2Vec2Encoder",
    # stdlib passthrough used by the loader itself (``!ref <x.attr>``)
    "getattr": "builtins.getattr",
}

# aliases of the JAX registry whose targets the port has not ported yet
# (none now), by the ROADMAP item that ports them
UNPORTED: Dict[str, str] = {}

# dotted-name prefixes remapped into the port
PREFIX_REMAPS = [
    ("modules.", "mlvae_tpu_torch.modules."),
    ("utils.", "mlvae_tpu_torch.utils."),
    ("models.", "mlvae_tpu_torch.models."),
    ("datasets.", "mlvae_tpu_torch.data.datasets."),
]

# JAX-package modules under those prefixes that the port has not ported
# (none now)
UNPORTED_PREFIXES: Dict[str, str] = {}

# the JAX package's top-level name
JAX_PACKAGE = "mlvae_tpu"

# names under the JAX package that a YAML written for it may carry, by the
# rest of the dotted name -> the port's target (so that one override loads
# in both packages; nothing resolves into the JAX package)
JAX_PACKAGE_ALIASES: Dict[str, str] = {
    # the JAX augmenter's docstring names it so (ops/augment.py)
    "ops.augment.WaveAugment": "mlvae_tpu_torch.ops.augment.WaveAugment",
}

# top-level packages whose names never resolve by a plain import: the
# libraries the recipes name, and the JAX package and JAX itself
_REFUSED_PACKAGES = ("torch", "speechbrain", JAX_PACKAGE, "jax")

# programmatic registrations (tests, user extensions): a name -> an object
# or a dotted path of the port
_EXTRA: Dict[str, Any] = {}


def register(name: str, target: Any) -> None:
    """Register an object (or dotted path) under a YAML-visible name. A
    dotted path into the JAX package or JAX is refused."""
    if isinstance(target, str) and \
            target.split(".")[0] in (JAX_PACKAGE, "jax", "jaxlib"):
        raise ValueError(
            f"register({name!r}, {target!r}): the port never resolves a "
            "name into the JAX package or JAX")
    _EXTRA[name] = target


def _locate_dotted(path: str) -> Optional[Any]:
    obj = pydoc.locate(path)
    if obj is not None:
        return obj
    # pydoc.locate can fail on lazily importable modules: split by hand
    parts = path.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    return None


def locate(name: str) -> Optional[Any]:
    """A YAML dotted name -> a live object of the port, or None."""
    if name in _EXTRA:
        target = _EXTRA[name]
        return _locate_dotted(target) if isinstance(target, str) else target
    if name in ALIASES:
        return _locate_dotted(ALIASES[name])
    if name in UNPORTED:
        raise NotImplementedError(
            f"{name} has no port target yet; it waits in {UNPORTED[name]}")
    for prefix, item in UNPORTED_PREFIXES.items():
        if name.startswith(prefix):
            raise NotImplementedError(
                f"{name} has no port target yet; it waits in {item}")
    for prefix, replacement in PREFIX_REMAPS:
        if name.startswith(prefix):
            return _locate_dotted(replacement + name[len(prefix):])
    root, _, rest = name.partition(".")
    if root == JAX_PACKAGE and rest in JAX_PACKAGE_ALIASES:
        return _locate_dotted(JAX_PACKAGE_ALIASES[rest])
    if root in _REFUSED_PACKAGES:
        raise NotImplementedError(
            f"{name} has no alias in the port's registry; a torch, "
            f"SpeechBrain or JAX-package name resolves only through one")
    return _locate_dotted(name)
