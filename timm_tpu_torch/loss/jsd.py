"""Jensen-Shannon divergence loss for AugMix (counterpart of
timm_tpu/loss/jsd.py)."""
from __future__ import annotations

import torch

from .cross_entropy import cross_entropy

__all__ = ['JsdCrossEntropy']


class JsdCrossEntropy:
    """Cross-entropy on the clean split plus ``alpha`` times the mean KL
    divergence of each split's softmax from their mixture. The batch is
    split-major (clean, aug1, ...), as the loader collates AugMix batches;
    the target is the clean split's (the loader tiles it). Pure tensor
    math: it reads nothing back to the host, so a train step graph can
    capture it."""

    def __init__(self, num_splits: int = 3, alpha: float = 12.0, smoothing: float = 0.1):
        self.num_splits = num_splits
        self.alpha = alpha
        self.smoothing = smoothing or 0.0

    def __call__(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        split_size = output.shape[0] // self.num_splits
        logits_split = torch.split(output, split_size, dim=0)

        loss = cross_entropy(logits_split[0], target[:split_size], smoothing=self.smoothing)
        probs = [torch.softmax(logits.float(), dim=-1) for logits in logits_split]
        mix = torch.clamp(sum(probs) / len(probs), 1e-7, 1.0)
        logp_mixture = torch.log(mix)
        kl = sum((p * (torch.log(torch.clamp(p, 1e-7, 1.0)) - logp_mixture)).sum(dim=-1).mean()
                 for p in probs)
        return loss + self.alpha * kl / len(probs)
