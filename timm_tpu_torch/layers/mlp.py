"""MLP blocks (counterpart of timm_tpu/layers/mlp.py ``Mlp``,
``GlobalResponseNorm`` and ``GlobalResponseNormMlp``)."""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from .create_act import get_act_fn
from .drop import Dropout
from .linear import Linear

__all__ = ['GlobalResponseNorm', 'GlobalResponseNormMlp', 'Mlp']


class Mlp(nn.Module):
    """fc1 -> act -> drop -> fc2 -> drop, on channels-last input of any rank."""

    def __init__(
            self,
            in_features: int,
            hidden_features: Optional[int] = None,
            out_features: Optional[int] = None,
            act_layer: Union[str, Callable] = 'gelu',
            bias: bool = True,
            drop: float = 0.0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        self.fc1 = Linear(in_features, hidden_features, bias=bias, dtype=dtype, generator=generator)
        self.act = get_act_fn(act_layer)
        self.drop1 = Dropout(drop)
        self.fc2 = Linear(hidden_features, out_features, bias=bias, dtype=dtype, generator=generator)
        self.drop2 = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(self.act(self.fc1(x)))
        return self.drop2(self.fc2(x))


class GlobalResponseNorm(nn.Module):
    """GRN of ConvNeXt-V2 over channels-last input: the L2 norm of each
    channel over the spatial axes, in fp32, divided by its mean over the
    channels, cast to x's dtype; then x + x * nx * weight + bias in x's
    dtype. Weight and bias start at zero."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = tuple(range(1, x.ndim - 1))
        gx = torch.sqrt(x.float().square().sum(dim=spatial, keepdim=True))
        nx = (gx / (gx.mean(dim=-1, keepdim=True) + self.eps)).to(x.dtype)
        return x + x * nx * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class GlobalResponseNormMlp(nn.Module):
    """fc1 -> act -> drop -> GRN -> fc2 -> drop (ConvNeXt-V2's block MLP)."""

    def __init__(
            self,
            in_features: int,
            hidden_features: Optional[int] = None,
            out_features: Optional[int] = None,
            act_layer: Union[str, Callable] = 'gelu',
            bias: bool = True,
            drop: float = 0.0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        self.fc1 = Linear(in_features, hidden_features, bias=bias, dtype=dtype, generator=generator)
        self.act = get_act_fn(act_layer)
        self.drop1 = Dropout(drop)
        self.grn = GlobalResponseNorm(hidden_features)
        self.fc2 = Linear(hidden_features, out_features, bias=bias, dtype=dtype, generator=generator)
        self.drop2 = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.grn(self.drop1(self.act(self.fc1(x))))
        return self.drop2(self.fc2(x))
