"""Binary cross-entropy with soft-target support (counterpart of
timm_tpu/loss/binary_cross_entropy.py)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ['BinaryCrossEntropy', 'one_hot']


def one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """fp32 one-hot rows of integer targets, as a comparison: no host read
    (``F.one_hot`` reads the largest label back), so a graph can capture it."""
    classes = torch.arange(num_classes, device=target.device)
    return (target.long()[:, None] == classes).float()


class BinaryCrossEntropy:
    """BCE with logits over dense targets: integer targets become one-hot
    rows with ``smoothing`` (dense (B, C) targets, from mixup / cutmix, are
    taken as they are), ``target_threshold`` binarizes them, ``sum_classes``
    sums over classes before the batch mean. Computed in fp32; pure tensor
    math, so the captured train step can run it."""

    def __init__(
            self,
            smoothing: float = 0.1,
            target_threshold: Optional[float] = None,
            weight=None,
            reduction: str = 'mean',
            sum_classes: bool = False,
            pos_weight=None,
    ):
        if not 0.0 <= smoothing < 1.0:
            raise ValueError(f'smoothing must be in [0, 1); got {smoothing}')
        self.smoothing = smoothing
        self.target_threshold = target_threshold
        self.reduction = 'none' if sum_classes else reduction
        self.sum_classes = sum_classes
        self.weight = weight
        self.pos_weight = pos_weight

    def __call__(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        num_classes = x.shape[-1]
        if target.ndim == 1:
            off_value = self.smoothing / num_classes
            on_value = 1.0 - self.smoothing + off_value
            target = one_hot(target, num_classes) * (on_value - off_value) + off_value
        if self.target_threshold is not None:
            target = (target > self.target_threshold).to(x.dtype)
        x = x.float()
        target = target.float()
        log_p, log_not_p = F.logsigmoid(x), F.logsigmoid(-x)
        if self.pos_weight is not None:
            loss = -(self.pos_weight * target * log_p + (1.0 - target) * log_not_p)
        else:
            loss = -(target * log_p + (1.0 - target) * log_not_p)
        if self.weight is not None:
            loss = loss * self.weight
        if self.sum_classes:
            return loss.sum(dim=-1).mean()
        if self.reduction == 'mean':
            return loss.mean()
        if self.reduction == 'sum':
            return loss.sum()
        return loss
