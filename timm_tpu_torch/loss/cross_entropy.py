"""Cross-entropy losses (counterpart of timm_tpu/loss/cross_entropy.py).

Losses are stateless callables: ``loss = fn(logits, target)`` returning a
scalar fp32 mean over the batch. Integer targets are class indices; float
targets of shape (B, C) are soft distributions. The log-softmax runs in fp32
whatever the logits' dtype, as in the JAX package.
"""
from __future__ import annotations

import torch

__all__ = ['LabelSmoothingCrossEntropy', 'SoftTargetCrossEntropy', 'cross_entropy']


def cross_entropy(logits: torch.Tensor, target: torch.Tensor, smoothing: float = 0.0) -> torch.Tensor:
    """CE over (B, C) logits; target (B,) int or (B, C) soft."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    if target.ndim == logits.ndim:
        loss = -(target * logprobs).sum(dim=-1)
    else:
        nll = -torch.gather(logprobs, -1, target.long()[:, None])[:, 0]
        if smoothing > 0.0:
            smooth = -logprobs.mean(dim=-1)
            loss = (1.0 - smoothing) * nll + smoothing * smooth
        else:
            loss = nll
    return loss.mean()


class LabelSmoothingCrossEntropy:
    """NLL with uniform label smoothing."""

    def __init__(self, smoothing: float = 0.1):
        if not smoothing < 1.0:
            raise ValueError(f'smoothing must be below 1.0; got {smoothing}')
        self.smoothing = smoothing

    def __call__(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return cross_entropy(x, target, smoothing=self.smoothing)


class SoftTargetCrossEntropy:
    """CE against a soft target distribution."""

    def __call__(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logprobs = torch.log_softmax(x.float(), dim=-1)
        return -(target * logprobs).sum(dim=-1).mean()
