"""Loss helpers under SpeechBrain names (counterpart of
``mlvae_tpu/ops/losses.py``; ``!name:speechbrain.nnet.losses.nll_loss``)."""
from __future__ import annotations

import torch

from mlvae_tpu_torch.nn.dist import categorical_log_prob
from mlvae_tpu_torch.utils.tensor import apply_lens_to_loss


def nll_loss(log_probabilities: torch.Tensor, targets: torch.Tensor,
             length=None, reduction: str = "mean",
             allowed_len_diff: int = 3) -> torch.Tensor:
    """The NLL of (B, T) int ``targets`` under (B, T, K) log-probabilities,
    masked by the relative ``length``, with SpeechBrain's signature. A
    time-length mismatch of up to ``allowed_len_diff`` frames (pooling and
    rounding off-by-ones) is cut to the shorter of the two; a larger one
    raises ``ValueError``."""
    Tp, Tt = log_probabilities.shape[1], targets.shape[1]
    if Tp != Tt:
        if abs(Tp - Tt) > allowed_len_diff:
            raise ValueError(
                f"predictions/targets time mismatch {Tp} vs {Tt} exceeds "
                f"allowed_len_diff={allowed_len_diff}")
        T = min(Tp, Tt)
        log_probabilities = log_probabilities[:, :T]
        targets = targets[:, :T]
    nll = -categorical_log_prob(log_probabilities, targets)
    if length is None:
        # SpeechBrain reduces through an all-ones mask
        if reduction == "batch":
            return nll.mean(dim=tuple(range(1, nll.dim())))
        return nll.mean()
    return apply_lens_to_loss(nll, length, reduction)
