"""Squeeze-and-Excitation over NHWC features (counterpart of
timm_tpu/layers/squeeze_excite.py): the mean over (H, W), one or two fully
connected layers, and the gate that scales the input channels. The fully
connected layers are ``Linear`` on (B, 1, 1, C), as JAX's ``nnx.Linear``;
their weights are drawn as JAX draws them (variance scaling 2.0 over
fan-out), their biases are zero.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from .create_act import get_act_fn
from .helpers import make_divisible
from .linear import Linear
from .weight_init import variance_scaling_

__all__ = ['EffectiveSEModule', 'SEModule', 'SqueezeExcite']


def _fc(cin: int, cout: int, bias: bool, dtype, generator) -> Linear:
    fc = Linear(cin, cout, bias=bias, dtype=dtype, generator=generator)
    variance_scaling_(fc.weight, 2.0, 'fan_out', 'normal', generator=generator)
    return fc


def _squeeze(x: torch.Tensor, add_maxpool: bool) -> torch.Tensor:
    x_se = x.mean(dim=(1, 2), keepdim=True)
    if add_maxpool:
        x_se = 0.5 * (x_se + x.amax(dim=(1, 2), keepdim=True))
    return x_se


class SEModule(nn.Module):
    """squeeze (mean over H, W) -> fc1 -> act -> fc2 -> gate -> x * gate."""

    def __init__(
            self,
            channels: int,
            rd_ratio: float = 1. / 16,
            rd_channels: Optional[int] = None,
            rd_divisor: int = 8,
            add_maxpool: bool = False,
            bias: bool = True,
            act_layer: Union[str, Callable] = 'relu',
            norm_layer=None,
            gate_layer: Union[str, Callable] = 'sigmoid',
            force_act_layer: Union[str, Callable, None] = None,
            rd_round_fn: Optional[Callable] = None,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not rd_channels:
            rd_round_fn = rd_round_fn or (lambda v: make_divisible(v, rd_divisor, round_limit=0.0))
            rd_channels = rd_round_fn(channels * rd_ratio)
        self.add_maxpool = add_maxpool
        self.fc1 = _fc(channels, rd_channels, bias, dtype, generator)
        self.bn = norm_layer(rd_channels) if norm_layer is not None else None
        self.act = get_act_fn(force_act_layer or act_layer)
        self.fc2 = _fc(rd_channels, channels, bias, dtype, generator)
        self.gate = get_act_fn(gate_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_se = self.fc1(_squeeze(x, self.add_maxpool))
        if self.bn is not None:
            x_se = self.bn(x_se)
        x_se = self.fc2(self.act(x_se))
        return x * self.gate(x_se)


SqueezeExcite = SEModule


class EffectiveSEModule(nn.Module):
    """'Effective' SE: one fc and a hard-sigmoid gate."""

    def __init__(self, channels: int, add_maxpool: bool = False,
                 gate_layer: Union[str, Callable] = 'hard_sigmoid',
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, **_):
        super().__init__()
        self.add_maxpool = add_maxpool
        self.fc = _fc(channels, channels, True, dtype, generator)
        self.gate = get_act_fn(gate_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gate(self.fc(_squeeze(x, self.add_maxpool)))
