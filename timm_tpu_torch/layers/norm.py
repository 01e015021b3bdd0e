"""LayerNorm over the channel (last) axis (counterpart of
timm_tpu/layers/norm.py ``LayerNorm``, default policy)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .linear import compute_dtype

__all__ = ['LayerNorm']


class LayerNorm(nn.Module):
    """LayerNorm with flax's numerics: the input, weight and bias are cast to
    the compute dtype (``dtype``, else the promotion of input and parameter
    dtypes); mean and variance are taken in fp32 as E[x^2] - E[x]^2, clamped
    at 0; the result is cast back to the compute dtype. So a bf16 ``dtype``
    gives a bf16 output, and ``dtype=None`` on a bf16 input gives fp32."""

    def __init__(self, num_channels: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = compute_dtype(x, self.compute_dtype, self.weight)
        xf = x.to(ct).float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min(xf.square().mean(dim=-1, keepdim=True) - mean.square(), 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(ct).float()
        y = (xf - mean) * mul + self.bias.to(ct).float()
        return y.to(ct)
