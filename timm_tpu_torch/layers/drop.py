"""Stochastic depth and dropout (counterpart of timm_tpu/layers/drop.py).
Both are the identity in eval mode, which is all the serving path runs."""
from __future__ import annotations

from typing import List

import torch
from torch import nn

__all__ = ['DropPath', 'Dropout', 'calculate_drop_path_rates', 'drop_path']


def drop_path(x: torch.Tensor, drop_prob: float = 0.0, training: bool = False,
              scale_by_keep: bool = True) -> torch.Tensor:
    """Drop whole residual-branch outputs per sample."""
    if drop_prob == 0.0 or not training:
        return x
    keep_prob = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = x.new_empty(shape).bernoulli_(keep_prob)
    if scale_by_keep:
        mask.div_(keep_prob)
    return x * mask


class DropPath(nn.Module):
    def __init__(self, drop_prob: float = 0.0, scale_by_keep: bool = True):
        super().__init__()
        self.drop_prob = float(drop_prob)
        self.scale_by_keep = scale_by_keep

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return drop_path(x, self.drop_prob, self.training, self.scale_by_keep)


Dropout = nn.Dropout  # the JAX package's name for it


def calculate_drop_path_rates(drop_path_rate: float, depth: int) -> List[float]:
    """Linearly increasing per-block drop-path rates."""
    return [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
