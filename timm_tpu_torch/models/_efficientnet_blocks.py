"""EfficientNet-family blocks over NHWC activations (counterpart of
timm_tpu/models/_efficientnet_blocks.py): ``ConvBnAct``,
``DepthwiseSeparableConv``, ``InvertedResidual`` (MBConv),
``CondConvResidual`` and ``EdgeResidual`` (FusedMBConv), with JAX's module
names so weights carry by name. ``UniversalInvertedResidual`` and
``MobileAttention`` (MobileNetV4) come with the rest of the zoo (ROADMAP
A.5.9) and raise.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ..layers import (
    BatchNormAct2d, DropPath, Linear, SqueezeExcite, create_conv2d, get_aa_layer, make_divisible,
)

__all__ = ['CondConvResidual', 'ConvBnAct', 'DepthwiseSeparableConv', 'EdgeResidual',
           'InvertedResidual', 'MobileAttention', 'SqueezeExcite', 'UniversalInvertedResidual']


def num_groups(group_size: Optional[int], channels: int) -> int:
    if not group_size:
        return 1
    if channels % group_size:
        raise ValueError(f'{channels} channels do not split into groups of {group_size}')
    return channels // group_size


def _no_aa(aa_layer) -> None:
    """Anti-aliased strides in these blocks come with the rest of the zoo."""
    if get_aa_layer(aa_layer) is not None:
        raise NotImplementedError(f'anti-aliasing ({aa_layer!r}) in the EfficientNet blocks is '
                                  'not ported yet (ROADMAP A.5.9, with the rest of the zoo)')


def _out_chs(conv: nn.Module) -> int:
    return conv.out_channels


class ConvBnAct(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, group_size: int = 0, pad_type: str = '', skip: bool = False,
                 act_layer: Union[str, Callable] = 'relu', norm_layer: Callable = BatchNormAct2d,
                 aa_layer: Optional[Callable] = None, drop_path_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _no_aa(aa_layer)
        self.has_skip = skip and stride == 1 and in_chs == out_chs
        self.conv = create_conv2d(in_chs, out_chs, kernel_size, stride=stride, dilation=dilation,
                                  groups=num_groups(group_size, in_chs), padding=pad_type or None,
                                  dtype=dtype, generator=generator)
        self.bn1 = norm_layer(out_chs, act_layer=act_layer, dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)

    def feature_info(self, location):
        return dict(module='conv', num_chs=_out_chs(self.conv))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.bn1(self.conv(x))
        if self.has_skip:
            x = self.drop_path(x) + shortcut
        return x


class _S2dMixin:
    """The space-to-depth front: a 2x2 stride-2 conv ('same') and its norm."""

    def _init_s2d(self, s2d: int, in_chs: int, dw_kernel_size: int, pad_type: str, act_layer,
                  norm_layer, dtype, generator):
        """Builds ``conv_s2d`` / ``bn_s2d``; returns (in_chs, dw_kernel_size,
        dw_pad_type) for the depthwise conv after it."""
        if s2d == 1:
            sd_chs = int(in_chs * 4)
            self.conv_s2d = create_conv2d(in_chs, sd_chs, 2, stride=2, padding='same',
                                          dtype=dtype, generator=generator)
            self.bn_s2d = norm_layer(sd_chs, act_layer=act_layer, dtype=dtype)
            dw_kernel_size = (dw_kernel_size + 1) // 2
            return sd_chs, dw_kernel_size, 'same' if dw_kernel_size == 2 else pad_type
        self.conv_s2d = None
        self.bn_s2d = None
        return in_chs, dw_kernel_size, pad_type

    def _s2d(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.conv_s2d is None else self.bn_s2d(self.conv_s2d(x))


class DepthwiseSeparableConv(_S2dMixin, nn.Module):
    """Depthwise conv -> (SE) -> pointwise conv, with a skip."""

    def __init__(self, in_chs: int, out_chs: int, dw_kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, group_size: int = 1, pad_type: str = '',
                 noskip: bool = False, pw_kernel_size: int = 1, pw_act: bool = False,
                 s2d: int = 0, act_layer: Union[str, Callable] = 'relu',
                 norm_layer: Callable = BatchNormAct2d, aa_layer: Optional[Callable] = None,
                 se_layer: Optional[Callable] = None, drop_path_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _no_aa(aa_layer)
        self.has_skip = (stride == 1 and in_chs == out_chs) and not noskip
        self.has_pw_act = pw_act
        in_chs, dw_kernel_size, dw_pad_type = self._init_s2d(
            s2d, in_chs, dw_kernel_size, pad_type, act_layer, norm_layer, dtype, generator)
        self.conv_dw = create_conv2d(in_chs, in_chs, dw_kernel_size, stride=stride,
                                     dilation=dilation, groups=num_groups(group_size, in_chs),
                                     padding=dw_pad_type or None, dtype=dtype, generator=generator)
        self.bn1 = norm_layer(in_chs, act_layer=act_layer, dtype=dtype)
        self.se = se_layer(in_chs, act_layer=act_layer, dtype=dtype, generator=generator) \
            if se_layer else None
        self.conv_pw = create_conv2d(in_chs, out_chs, pw_kernel_size, padding=pad_type or None,
                                     dtype=dtype, generator=generator)
        self.bn2 = norm_layer(out_chs, apply_act=self.has_pw_act, act_layer=act_layer, dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)

    def feature_info(self, location):
        return dict(module='conv_pw', num_chs=_out_chs(self.conv_pw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.bn1(self.conv_dw(self._s2d(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.bn2(self.conv_pw(x))
        if self.has_skip:
            x = self.drop_path(x) + shortcut
        return x


class InvertedResidual(_S2dMixin, nn.Module):
    """MBConv: pointwise expansion -> depthwise conv -> (SE) -> pointwise
    projection, with a skip."""

    def __init__(self, in_chs: int, out_chs: int, dw_kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, group_size: int = 1, pad_type: str = '',
                 noskip: bool = False, exp_ratio: float = 1.0, exp_kernel_size: int = 1,
                 pw_kernel_size: int = 1, s2d: int = 0, act_layer: Union[str, Callable] = 'relu',
                 norm_layer: Callable = BatchNormAct2d, aa_layer: Optional[Callable] = None,
                 se_layer: Optional[Callable] = None, conv_kwargs: Optional[dict] = None,
                 drop_path_rate: float = 0.0, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _no_aa(aa_layer)
        conv_kwargs = dict(conv_kwargs or {}, dtype=dtype, generator=generator)
        self.has_skip = (in_chs == out_chs and stride == 1) and not noskip
        in_chs, dw_kernel_size, dw_pad_type = self._init_s2d(
            s2d, in_chs, dw_kernel_size, pad_type, act_layer, norm_layer, dtype, generator)
        mid_chs = make_divisible(in_chs * exp_ratio)
        self.conv_pw = create_conv2d(in_chs, mid_chs, exp_kernel_size, padding=pad_type or None,
                                     **conv_kwargs)
        self.bn1 = norm_layer(mid_chs, act_layer=act_layer, dtype=dtype)
        self.conv_dw = create_conv2d(mid_chs, mid_chs, dw_kernel_size, stride=stride,
                                     dilation=dilation, groups=num_groups(group_size, mid_chs),
                                     padding=dw_pad_type or None, **conv_kwargs)
        self.bn2 = norm_layer(mid_chs, act_layer=act_layer, dtype=dtype)
        self.se = se_layer(mid_chs, act_layer=act_layer, dtype=dtype, generator=generator) \
            if se_layer else None
        self.conv_pwl = create_conv2d(mid_chs, out_chs, pw_kernel_size, padding=pad_type or None,
                                      **conv_kwargs)
        self.bn3 = norm_layer(out_chs, apply_act=False, dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)

    def feature_info(self, location):
        return dict(module='conv_pwl', num_chs=_out_chs(self.conv_pwl))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.bn1(self.conv_pw(self._s2d(x)))
        x = self.bn2(self.conv_dw(x))
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv_pwl(x))
        if self.has_skip:
            x = self.drop_path(x) + shortcut
        return x


class CondConvResidual(InvertedResidual):
    """InvertedResidual with CondConv expert routing: a sigmoid routing head
    over the pooled input mixes per-sample kernels for its three convs."""

    def __init__(self, in_chs: int, out_chs: int, num_experts: int = 0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(in_chs, out_chs, conv_kwargs=dict(num_experts=num_experts), dtype=dtype,
                         generator=generator, **kwargs)
        self.num_experts = num_experts
        self.routing_fn = Linear(in_chs, num_experts, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        routing_weights = torch.sigmoid(self.routing_fn(x.mean(dim=(1, 2))))
        x = self.bn1(self.conv_pw(x, routing_weights))
        x = self.bn2(self.conv_dw(x, routing_weights))
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv_pwl(x, routing_weights))
        if self.has_skip:
            x = self.drop_path(x) + shortcut
        return x


class EdgeResidual(nn.Module):
    """FusedMBConv: a full expansion conv -> (SE) -> pointwise projection,
    with a skip."""

    def __init__(self, in_chs: int, out_chs: int, exp_kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, group_size: int = 0, pad_type: str = '',
                 force_in_chs: int = 0, noskip: bool = False, exp_ratio: float = 1.0,
                 pw_kernel_size: int = 1, act_layer: Union[str, Callable] = 'relu',
                 norm_layer: Callable = BatchNormAct2d, aa_layer: Optional[Callable] = None,
                 se_layer: Optional[Callable] = None, drop_path_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _no_aa(aa_layer)
        mid_chs = make_divisible((force_in_chs if force_in_chs > 0 else in_chs) * exp_ratio)
        self.has_skip = (in_chs == out_chs and stride == 1) and not noskip
        self.conv_exp = create_conv2d(in_chs, mid_chs, exp_kernel_size, stride=stride,
                                      dilation=dilation, groups=num_groups(group_size, mid_chs),
                                      padding=pad_type or None, dtype=dtype, generator=generator)
        self.bn1 = norm_layer(mid_chs, act_layer=act_layer, dtype=dtype)
        self.se = se_layer(mid_chs, act_layer=act_layer, dtype=dtype, generator=generator) \
            if se_layer else None
        self.conv_pwl = create_conv2d(mid_chs, out_chs, pw_kernel_size, padding=pad_type or None,
                                      dtype=dtype, generator=generator)
        self.bn2 = norm_layer(out_chs, apply_act=False, dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)

    def feature_info(self, location):
        return dict(module='conv_pwl', num_chs=_out_chs(self.conv_pwl))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.bn1(self.conv_exp(x))
        if self.se is not None:
            x = self.se(x)
        x = self.bn2(self.conv_pwl(x))
        if self.has_skip:
            x = self.drop_path(x) + shortcut
        return x


class _NotPorted(nn.Module):
    what = ''

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f'{self.what} is not ported yet (ROADMAP A.5.9, MobileNetV4 '
                                  'with the rest of the zoo)')


class UniversalInvertedResidual(_NotPorted):
    what = 'UniversalInvertedResidual (MobileNetV4)'


class MobileAttention(_NotPorted):
    what = 'MobileAttention (MobileNetV4, with Attention2d)'
