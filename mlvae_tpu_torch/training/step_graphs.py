"""CUDA graphs of the Brain's steps: on the card, the port's counterpart of
the JAX Brain's ``lax.scan`` over a run of same-shape batches
(``--scan_epoch``, ``training/brain.py``).

A :class:`StepGraph` captures one call of a step function (the train step,
or the eval forward) on static inputs, clones of a batch and its draws,
and replays it on another batch of the same shapes by copying that batch
and its draws into the static inputs first. The graph's outputs are its
own buffers, written again by every replay: a caller copies what it keeps
(``clone_tree``) before the next replay. What the step updates in place
(the parameters, the optimizer's ``count`` and moments, the normalizer's
running statistics) is updated by every replay; what it *replaces* (the
parameters' ``.grad``) lives in the graph's memory pool.

Several graphs may share one pool (``pool``): a capture then reuses the
memory that the earlier captures freed, which their replays still write.
That is safe as the Brain uses it: graphs replay one after another on one
stream, each replay's outputs are cloned before any other graph replays,
the static inputs are written just before their graph's replay, and no
``.grad`` is kept past a replay.

Nothing here draws: the step's draws are made outside the graph, in the
order the per-batch loop makes them, and passed in as static inputs.
Capture fails loudly (a host sync, a pageable copy, an uncapturable
launch): there is no eager fallback on the card.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def clone_tree(tree):
    """Every tensor of a nested dict / list / tuple cloned; anything else
    as it is."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def copy_tree_(dst, src) -> None:
    """``src``'s tensors copied into ``dst``'s, the same structure."""
    if isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"static inputs {sorted(dst)} != "
                             f"{sorted(src)}")
        for k in dst:
            copy_tree_(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError("static inputs differ in length")
        for d, s in zip(dst, src):
            copy_tree_(d, s)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


def tree_signature(tree) -> Tuple:
    """Shapes and dtypes of a tree's tensors, with its structure."""
    if isinstance(tree, dict):
        return tuple((k, tree_signature(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return tuple(tree_signature(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype))
    return ()


class StepGraph:
    """``fn(*inputs)`` captured once on clones of ``inputs`` (nothing
    runs at capture) into the memory pool ``pool`` (a private one by
    default); ``__call__`` replays it on new inputs."""

    def __init__(self, fn: Callable, inputs: Tuple, pool=None):
        self.static = clone_tree(tuple(inputs))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = fn(*self.static)
        self.replays = 0

    def __call__(self, *inputs):
        copy_tree_(self.static, tuple(inputs))
        self.graph.replay()
        self.replays += 1
        return self.outputs
