from mlvae_tpu_torch.hyperyaml.loader import (
    load_hyperyaml,
    recursive_update,
    resolve_references,
)

__all__ = ["load_hyperyaml", "recursive_update", "resolve_references"]
