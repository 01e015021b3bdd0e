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
- ``GroupNorm`` (flax ``nnx.GroupNorm``): as LayerNorm, over (H, W) and the
  channels of each group.
- ``BatchNorm2d`` (flax ``nnx.BatchNorm`` with torch-style momentum, flax's
  decay = 1 - momentum). The compute dtype ``ct`` is ``dtype``, else the
  promotion of the input's and fp32. In training the batch statistics are
  taken in fp32 over every axis but the last as E[x^2] - E[x]^2, clamped
  at 0 (flax ``_compute_stats``, ``use_fast_variance``); the running
  statistics are blended in fp32 from their stored fp32 values,
  ``decay * old + (1 - decay) * batch``, with the biased batch variance;
  and ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` runs in fp32
  on x, scale and bias rounded to ``ct``, then is cast to ``ct``. In eval
  the running statistics, scale and bias are rounded to ``ct`` and the
  whole chain runs in ``ct`` (bf16 under a bf16 ``dtype``). There is no
  ``num_batches_tracked``. The statistics are ``running_mean`` and
  ``running_var`` buffers updated in place with no host read, so a CUDA
  graph capture of a train step records their update.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .linear import compute_dtype

__all__ = ['BatchNorm2d', 'GroupNorm', 'GroupNorm1', 'LayerNorm', 'LayerNorm2d', 'LayerNormFp32',
           'RmsNorm', 'RmsNorm2d', 'SimpleNorm', 'SimpleNorm2d']


class LayerNorm(nn.Module):
    """LayerNorm with flax's numerics: mean and variance in fp32 as
    E[x^2] - E[x]^2, clamped at 0 (see the module docstring for dtypes)."""

    def __init__(self, num_channels: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None,
                 affine: bool = True):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(num_channels)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = compute_dtype(x, self.compute_dtype, x if self.weight is None else self.weight)
        xf = x.to(ct).float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min(xf.square().mean(dim=-1, keepdim=True) - mean.square(), 0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight.to(ct).float()
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias.to(ct).float()
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


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
               weight: Optional[torch.Tensor], bias: Optional[torch.Tensor]) -> torch.Tensor:
    """flax ``_normalize`` in its order: (x - mean) * (rsqrt(var + eps) *
    scale) + bias, in the promotion of the operands' dtypes."""
    y = x - mean
    var = var + eps
    # rsqrt rounded once from fp32, as XLA rounds a bf16 op (torch's CPU
    # bf16 rsqrt is an ulp off where the correctly rounded one is not)
    mul = torch.rsqrt(var.float()).to(var.dtype)
    if weight is not None:
        mul = mul * weight
    y = y * mul
    if bias is not None:
        y = y + bias
    return y


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """flax's statistics dtype: x's promoted to at least fp32."""
    return torch.promote_types(x.dtype, torch.float32)


def _fast_stats(xf: torch.Tensor, dims) -> tuple:
    """flax ``_compute_stats`` with ``use_fast_variance``: fp32 E[x] and
    E[x^2] - E[x]^2 clamped at 0."""
    mean = xf.mean(dim=dims)
    var = torch.clamp_min(xf.square().mean(dim=dims) - mean.square(), 0.0)
    return mean, var


class GroupNorm(nn.Module):
    """flax ``nnx.GroupNorm`` over NHWC input: statistics per sample and
    group over (H, W) and the group's channels (see the module docstring)."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 affine: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f'{num_channels} channels do not split into {num_groups} groups')
        self.num_groups = num_groups
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(num_channels)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = compute_dtype(x, self.compute_dtype, x if self.weight is None else self.weight)
        x = x.to(ct)
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        grouped = x.to(_stats_dtype(x)).reshape(*x.shape[:-1], g, c // g)
        mean, var = _fast_stats(grouped, tuple(range(1, x.ndim - 1)) + (x.ndim,))
        shape = (b,) + (1,) * (x.ndim - 2) + (c,)
        mean = mean.repeat_interleave(c // g, dim=1).reshape(shape)
        var = var.repeat_interleave(c // g, dim=1).reshape(shape)
        w = None if self.weight is None else self.weight.to(ct)
        bias = None if self.bias is None else self.bias.to(ct)
        return _normalize(x, mean, var, self.eps, w, bias).to(ct)


class GroupNorm1(GroupNorm):
    """GroupNorm with one group: a LayerNorm over (H, W, C)."""

    def __init__(self, num_channels: int, **kwargs):
        super().__init__(num_channels, num_groups=1, **kwargs)


class BatchNorm2d(nn.Module):
    """flax ``nnx.BatchNorm`` over every axis but the last (N, H, W of NHWC
    input), with running statistics (see the module docstring)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if affine else None
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = compute_dtype(x, self.compute_dtype, self.running_mean)
        x = x.to(ct)
        w = None if self.weight is None else self.weight.to(ct)
        bias = None if self.bias is None else self.bias.to(ct)
        if not self.training:
            return _normalize(x, self.running_mean.to(ct), self.running_var.to(ct), self.eps,
                              w, bias).to(ct)
        mean, var = _fast_stats(x.to(_stats_dtype(x)), tuple(range(x.ndim - 1)))
        decay = 1.0 - self.momentum
        with torch.no_grad():
            self.running_mean.copy_(decay * self.running_mean + (1.0 - decay) * mean)
            self.running_var.copy_(decay * self.running_var + (1.0 - decay) * var)
        return _normalize(x, mean, var, self.eps, w, bias).to(ct)

    def extra_repr(self) -> str:
        return (f'{self.running_mean.numel()}, eps={self.eps}, momentum={self.momentum}, '
                f'affine={self.weight is not None}')
