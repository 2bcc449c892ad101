"""Tensor parallelism of the wav2vec2 transformer trunk over the model
group (counterpart of ``mlvae_tpu/parallel/tp.py``).

The Megatron split of the JAX package's ``_W2V_LAYER_RULES``, on the
port's per-layer parameters (linear weights are (in, out)):

* column-split, each model rank holding ``1/M`` of the output features:
  q/k/v (so a rank runs ``heads / M`` heads) and ``ff_in``;
* row-split, each rank holding ``1/M`` of the input features: ``o`` and
  ``ff_out``, whose partial products are summed over the model group
  before their replicated biases are added, once;
* everything else (layer norms, the conv extractor, the positional conv,
  the projections, ``o_b``, ``ff_out_b``) replicated.

``copy_to_model`` (identity forward, all-reduce backward) goes before a
column-split product and ``reduce_from_model`` (all-reduce forward,
identity backward) after a row-split one. ``split_dims`` names each split
parameter with the dim it is split along; ``shard`` and ``unshard`` cut
and rebuild them, so that checkpoints keep the full JAX layout.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from mlvae_tpu_torch.parallel import mesh as M

# per-layer parameter -> the dim split over the model axis
W2V_LAYER_SPLITS = {"q_w": 1, "q_b": 0, "k_w": 1, "k_b": 0, "v_w": 1,
                    "v_b": 0, "o_w": 0, "ff_in_w": 1, "ff_in_b": 0,
                    "ff_out_w": 0}


def validate_tp(enc, n_model: int) -> Optional[str]:
    """An error string if the encoder cannot split ``n_model`` ways."""
    if enc.num_attention_heads % n_model:
        return (f"num_attention_heads={enc.num_attention_heads} not "
                f"divisible by model axis {n_model}")
    if enc.intermediate_size % n_model:
        return (f"intermediate_size={enc.intermediate_size} not divisible "
                f"by model axis {n_model}")
    return None


def wav2vec2_split_dims(enc) -> Dict[str, int]:
    """Parameter name (in the encoder) -> the dim split over the model
    axis."""
    return {f"layers.{i}.{name}": dim
            for i in range(len(enc.layers))
            for name, dim in W2V_LAYER_SPLITS.items()}


def shard(full: torch.Tensor, dim: int, n: int, m: int) -> torch.Tensor:
    """Model rank ``m``'s contiguous piece of ``full`` along ``dim``."""
    size = full.shape[dim] // n
    return full.narrow(dim, m * size, size).contiguous()


def unshard(piece: torch.Tensor, dim: int, mesh: "M.Mesh") -> torch.Tensor:
    """The full tensor from every model rank's piece (a collective)."""
    return M.all_gather_cat(piece, mesh.model_group, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return M.all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return M.all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: "M.Mesh") -> torch.Tensor:
    if mesh.n_model == 1 or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: "M.Mesh") -> torch.Tensor:
    if mesh.n_model == 1:
        return x
    if not torch.is_grad_enabled():
        return M.all_reduce(x, mesh.model_group)
    return _ReduceFromModel.apply(x, mesh.model_group)
