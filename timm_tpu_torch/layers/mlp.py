"""MLP blocks (counterpart of timm_tpu/layers/mlp.py ``Mlp``, ``GluMlp``,
``SwiGLU``, ``SwiGLUPacked``, ``GlobalResponseNorm`` and
``GlobalResponseNormMlp``).

``bias`` and ``drop`` take one value or a pair (fc1's, fc2's), as JAX's
``to_2tuple``. The optional ``norm_layer`` between the activation and fc2
(the ViT's ``scale_mlp_norm``) is built without a dtype, as JAX builds it.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from .create_act import get_act_fn
from .drop import Dropout
from .helpers import to_2tuple
from .linear import Linear

__all__ = ['GlobalResponseNorm', 'GlobalResponseNormMlp', 'GluMlp', 'Mlp', 'SwiGLU',
           'SwiGLUPacked']


class Mlp(nn.Module):
    """fc1 -> act -> drop -> (norm) -> fc2 -> drop, on channels-last input of
    any rank."""

    def __init__(
            self,
            in_features: int,
            hidden_features: Optional[int] = None,
            out_features: Optional[int] = None,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Optional[Callable] = None,
            bias: Union[bool, Tuple[bool, bool]] = True,
            drop: Union[float, Tuple[float, float]] = 0.0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        bias, drop = to_2tuple(bias), to_2tuple(drop)
        self.fc1 = Linear(in_features, hidden_features, bias=bias[0], dtype=dtype,
                          generator=generator)
        self.act = get_act_fn(act_layer)
        self.drop1 = Dropout(drop[0])
        self.norm = norm_layer(hidden_features) if norm_layer is not None else None
        self.fc2 = Linear(hidden_features, out_features, bias=bias[1], dtype=dtype,
                          generator=generator)
        self.drop2 = Dropout(drop[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(self.act(self.fc1(x)))
        if self.norm is not None:
            x = self.norm(x)
        return self.drop2(self.fc2(x))


class GluMlp(nn.Module):
    """GLU MLP: fc1 projects to the hidden width, whose two halves are the
    value and the gate (the gate through ``act``: the second half when
    ``gate_last``, else the first), then drop, (norm) and fc2 over half the
    hidden width."""

    def __init__(
            self,
            in_features: int,
            hidden_features: Optional[int] = None,
            out_features: Optional[int] = None,
            act_layer: Union[str, Callable] = 'sigmoid',
            norm_layer: Optional[Callable] = None,
            bias: Union[bool, Tuple[bool, bool]] = True,
            drop: Union[float, Tuple[float, float]] = 0.0,
            gate_last: bool = True,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        if hidden_features % 2:
            raise ValueError(f'GluMlp needs an even hidden width; got {hidden_features}')
        bias, drop = to_2tuple(bias), to_2tuple(drop)
        self.gate_last = gate_last
        self.fc1 = Linear(in_features, hidden_features, bias=bias[0], dtype=dtype,
                          generator=generator)
        self.act = get_act_fn(act_layer)
        self.drop1 = Dropout(drop[0])
        self.norm = norm_layer(hidden_features // 2) if norm_layer is not None else None
        self.fc2 = Linear(hidden_features // 2, out_features, bias=bias[1], dtype=dtype,
                          generator=generator)
        self.drop2 = Dropout(drop[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.fc1(x).chunk(2, dim=-1)
        x = x1 * self.act(x2) if self.gate_last else self.act(x1) * x2
        x = self.drop1(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.drop2(self.fc2(x))


class SwiGLU(nn.Module):
    """SwiGLU with separate gate and value projections: fc2(drop(norm(
    act(fc1_g(x)) * fc1_x(x)))). ``align_to`` rounds the hidden width up."""

    def __init__(
            self,
            in_features: int,
            hidden_features: Optional[int] = None,
            out_features: Optional[int] = None,
            act_layer: Union[str, Callable] = 'silu',
            norm_layer: Optional[Callable] = None,
            bias: Union[bool, Tuple[bool, bool]] = True,
            drop: Union[float, Tuple[float, float]] = 0.0,
            align_to: int = 0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        if align_to:
            hidden_features = hidden_features + (-hidden_features % align_to)
        bias, drop = to_2tuple(bias), to_2tuple(drop)
        self.fc1_g = Linear(in_features, hidden_features, bias=bias[0], dtype=dtype,
                            generator=generator)
        self.fc1_x = Linear(in_features, hidden_features, bias=bias[0], dtype=dtype,
                            generator=generator)
        self.act = get_act_fn(act_layer)
        self.drop1 = Dropout(drop[0])
        self.norm = norm_layer(hidden_features) if norm_layer is not None else None
        self.fc2 = Linear(hidden_features, out_features, bias=bias[1], dtype=dtype,
                          generator=generator)
        self.drop2 = Dropout(drop[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(self.act(self.fc1_g(x)) * self.fc1_x(x))
        if self.norm is not None:
            x = self.norm(x)
        return self.drop2(self.fc2(x))


def SwiGLUPacked(in_features: int, hidden_features: Optional[int] = None, **kwargs) -> GluMlp:
    """The packed-projection SwiGLU: a GluMlp gated by silu on the first
    half; the caller passes the doubled hidden width."""
    return GluMlp(in_features, hidden_features=hidden_features,
                  act_layer=kwargs.pop('act_layer', 'silu'), gate_last=False, **kwargs)


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
