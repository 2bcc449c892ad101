from mlvae_tpu_torch.hyperyaml.loader import (
    Placeholder,
    RefTag,
    TaggedValue,
    dump_hyperyaml,
    load_hyperpyyaml,
    load_hyperyaml,
    recursive_update,
    resolve_references,
)
from mlvae_tpu_torch.hyperyaml.registry import register

__all__ = [
    "load_hyperyaml",
    "load_hyperpyyaml",
    "recursive_update",
    "resolve_references",
    "TaggedValue",
    "Placeholder",
    "RefTag",
    "dump_hyperyaml",
    "register",
]
