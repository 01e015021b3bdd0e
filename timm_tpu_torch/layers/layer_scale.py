"""LayerScale (counterpart of timm_tpu/layers/layer_scale.py)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ['LayerScale']


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)
