"""Norm + activation composites (counterpart of timm_tpu/layers/norm_act.py).

Each is its norm (``norm.py``, with its dtype rules) followed by an
optional drop layer and the activation, as in the JAX package.
``FrozenBatchNormAct2d`` keeps scale, bias and statistics as buffers (JAX's
plain ``nnx.Variable``s, which no optimizer sees). EvoNorm and FRN come
with the rest of the zoo (ROADMAP A.5.9).
"""
from __future__ import annotations

import functools
import inspect
from typing import Callable, Optional, Union

import torch
from torch import nn

from .create_act import get_act_fn
from .norm import BatchNorm2d, GroupNorm, LayerNorm

__all__ = ['BatchNormAct2d', 'FrozenBatchNormAct2d', 'GroupNorm1Act', 'GroupNormAct',
           'LayerNormAct', 'LayerNormAct2d', 'get_norm_act_layer']


class _ActMixin:
    """The drop layer and the activation after the norm."""

    def _init_act(self, apply_act: bool, act_layer, drop_layer) -> None:
        self.act = get_act_fn(act_layer) if apply_act else None
        self.drop = drop_layer() if drop_layer is not None else None

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.drop is not None:
            x = self.drop(x)
        if self.act is not None:
            x = self.act(x)
        return x


class BatchNormAct2d(_ActMixin, BatchNorm2d):
    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, apply_act: bool = True,
                 act_layer: Union[str, Callable, None] = 'relu', act_kwargs=None,
                 drop_layer=None, dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=eps, momentum=momentum, affine=affine, dtype=dtype)
        self._init_act(apply_act, act_layer, drop_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._act(super().forward(x))


class FrozenBatchNormAct2d(nn.Module):
    """BatchNorm with frozen statistics and affine values:
    ``x * s + (bias - mean * s)`` with ``s = weight / sqrt(var + eps)``
    computed in fp32 and cast to x's dtype, then the activation."""

    def __init__(self, num_features: int, eps: float = 1e-5, apply_act: bool = True,
                 act_layer: Union[str, Callable, None] = 'relu'):
        super().__init__()
        self.eps = eps
        self.register_buffer('weight', torch.ones(num_features))
        self.register_buffer('bias', torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.act = get_act_fn(act_layer) if apply_act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        bias = self.bias - self.running_mean * scale
        x = x * scale.to(x.dtype) + bias.to(x.dtype)
        return self.act(x) if self.act is not None else x


class GroupNormAct(_ActMixin, GroupNorm):
    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 affine: bool = True, group_size: Optional[int] = None, apply_act: bool = True,
                 act_layer: Union[str, Callable, None] = 'relu', act_kwargs=None,
                 drop_layer=None, dtype: Optional[torch.dtype] = None):
        if group_size:
            # channels per group overrides num_groups
            if num_channels % group_size:
                raise ValueError(f'{num_channels} channels do not split into groups of '
                                 f'{group_size}')
            num_groups = num_channels // group_size
        super().__init__(num_channels, num_groups=num_groups, eps=eps, affine=affine, dtype=dtype)
        self._init_act(apply_act, act_layer, drop_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._act(super().forward(x))


class GroupNorm1Act(GroupNormAct):
    def __init__(self, num_channels: int, **kwargs):
        super().__init__(num_channels, num_groups=1, **kwargs)


class LayerNormAct(_ActMixin, LayerNorm):
    def __init__(self, num_channels: int, eps: float = 1e-6, affine: bool = True,
                 apply_act: bool = True, act_layer: Union[str, Callable, None] = 'relu',
                 act_kwargs=None, drop_layer=None, dtype: Optional[torch.dtype] = None):
        super().__init__(num_channels, eps=eps, dtype=dtype, affine=affine)
        self._init_act(apply_act, act_layer, drop_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._act(super().forward(x))


LayerNormAct2d = LayerNormAct  # NHWC: the same computation

_NORM_ACT_MAP = dict(
    batchnorm=BatchNormAct2d,
    batchnorm2d=BatchNormAct2d,
    groupnorm=GroupNormAct,
    groupnorm1=GroupNorm1Act,
    layernorm=LayerNormAct,
    layernorm2d=LayerNormAct2d,
)
_NOT_PORTED = ('evonormb0', 'evonorms0', 'frn', 'frntlu')


def get_norm_act_layer(norm_layer, act_layer=None):
    """The norm + act class of a name or callable; ``act_layer``, when
    given, is bound as its default activation."""
    if norm_layer is None:
        return None
    if not isinstance(norm_layer, str):
        cls = norm_layer
    else:
        name = norm_layer.replace('_', '').lower()
        if name in _NOT_PORTED:
            raise NotImplementedError(f'norm+act layer {norm_layer!r} is not ported yet '
                                      '(ROADMAP A.5.9, EvoNorm and FRN with the rest of the zoo)')
        if name not in _NORM_ACT_MAP:
            raise ValueError(f'Unknown norm+act layer {norm_layer}')
        cls = _NORM_ACT_MAP[name]
    base = cls.func if isinstance(cls, functools.partial) else cls
    if act_layer is not None and 'act_layer' in inspect.signature(base.__init__).parameters:
        cls = functools.partial(cls, act_layer=act_layer)
    return cls
