"""Normalization over the channel (last) axis (counterpart of
timm_tpu/layers/norm.py, default precision policy).

Activations are NHWC or NLC, so every '2d' variant is the same computation
as its 1d one and an alias of it, as in the JAX package. The dtype rules are
flax's and the JAX package's, module by module:

- ``LayerNorm`` and ``RmsNorm`` (flax ``nnx.LayerNorm`` / ``nnx.RMSNorm``):
  input and parameters are cast to the compute dtype (``dtype``, else the
  promotion of input and parameter dtypes), statistics are taken in fp32
  and the result is cast to the compute dtype. A bf16 ``dtype`` gives a bf16
  output; ``dtype=None`` on a bf16 input gives fp32.
- ``LayerNormFp32``: a ``LayerNorm`` pinned to fp32, so fp32 out.
- ``SimpleNorm``: statistics in fp32, the result cast back to the input's
  dtype, whatever the parameters.

The BatchNorm and GroupNorm modules come with ``norm_act.py`` (ROADMAP
A.5.6, the ResNet step).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .linear import compute_dtype

__all__ = ['LayerNorm', 'LayerNorm2d', 'LayerNormFp32', 'RmsNorm', 'RmsNorm2d', 'SimpleNorm',
           'SimpleNorm2d']


class LayerNorm(nn.Module):
    """LayerNorm with flax's numerics: mean and variance in fp32 as
    E[x^2] - E[x]^2, clamped at 0 (see the module docstring for dtypes)."""

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


LayerNorm2d = LayerNorm


class LayerNormFp32(LayerNorm):
    """LayerNorm pinned to fp32: fp32 statistics and an fp32 output."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__(num_channels, eps=eps, dtype=torch.float32)


class RmsNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, flax's ``nnx.RMSNorm`` (no bias)."""

    def __init__(self, num_channels: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = compute_dtype(x, self.compute_dtype, self.weight)
        xf = x.to(ct).float()
        mul = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * (mul * self.weight.to(ct).float())).to(ct)


RmsNorm2d = RmsNorm


class SimpleNorm(nn.Module):
    """x * rsqrt(var(x) + eps) * weight with the unbiased variance (ddof 1)
    and no mean subtraction of x itself; not RMSNorm. Output in x's dtype."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.var(dim=-1, keepdim=True, correction=1) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


SimpleNorm2d = SimpleNorm
