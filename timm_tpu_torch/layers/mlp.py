"""MLP block (counterpart of timm_tpu/layers/mlp.py ``Mlp``)."""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from .create_act import get_act_fn
from .drop import Dropout
from .linear import Linear

__all__ = ['Mlp']


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
