"""Conv layer factory over NHWC activations (counterpart of
timm_tpu/layers/create_conv2d.py).

The JAX package's convolutions are ``nnx.Conv`` over NHWC with HWIO kernels,
computed by XLA. The port keeps the NHWC activations and stores the weight
in torch's OIHW: a forward views the NHWC input as an NCHW tensor (a
contiguous NHWC tensor permuted is a ``torch.channels_last`` NCHW tensor,
no copy), gives ``F.conv2d`` the weight in ``channels_last`` too, and views
the result back as NHWC. So cuDNN runs its NHWC kernels and no transpose is
inserted around a convolution. ``F.conv2d`` (cuDNN on the card) computes
them, as XLA does in JAX: no Pallas kernel is involved there.

Padding follows the JAX package (reference padding.py): ``''`` and ``None``
are symmetric torch-style padding, ``'same'`` is TF-SAME (asymmetric at
stride > 1 on even inputs, so an explicit ``F.pad``), ``'valid'`` none.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .helpers import to_2tuple
from .linear import compute_dtype
from .weight_init import variance_scaling_

__all__ = ['Conv2d', 'ConvNormAct', 'SeparableConvNormAct', 'create_conv2d', 'get_padding']


def get_padding(kernel_size: int, stride: int = 1, dilation: int = 1):
    """Symmetric 'same-when-stride-1' padding amount."""
    if isinstance(kernel_size, (tuple, list)):
        return tuple(get_padding(k, s, d) for k, s, d in
                     zip(kernel_size, to_2tuple(stride), to_2tuple(dilation)))
    return ((stride - 1) + dilation * (kernel_size - 1)) // 2


def _resolve_padding(padding, kernel_size, stride, dilation) -> Union[str, Tuple[int, int]]:
    """'same' (TF-SAME), or the symmetric (pad_h, pad_w) of a timm padding
    argument; '' and None mean symmetric torch-style padding, not TF-SAME."""
    if isinstance(padding, str):
        padding = padding.lower()
        if padding == 'same':
            return 'same'
        if padding == 'valid':
            return (0, 0)
        if padding != '':
            raise ValueError(f'Unknown padding {padding}')
        padding = None
    if padding is None:
        padding = get_padding(kernel_size, stride, dilation)
    return to_2tuple(padding)


def _same_pads(size: int, k: int, s: int, d: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one spatial dim, as XLA's 'SAME'."""
    total = max((math.ceil(size / s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """A 2-D convolution of NHWC input with an OIHW weight and flax's dtype
    rule (``dtype``, else the promotion of input and weight dtypes). The
    weight is drawn as the JAX package draws its conv kernels: variance
    scaling 2.0 over fan-out, truncated normal; the bias is zero."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                 padding=(0, 0), dilation=1, groups: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = to_2tuple(kernel_size)
        self.stride = to_2tuple(stride)
        self.dilation = to_2tuple(dilation)
        self.padding = padding if padding == 'same' else to_2tuple(padding)
        self.groups = groups
        self.in_channels, self.out_channels = in_channels, out_channels
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                               *self.kernel_size))
        variance_scaling_(self.weight, 2.0, 'fan_out', 'normal', generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) -> (B, H', W', C_out)."""
        ct = compute_dtype(x, self.compute_dtype, self.weight)
        x = x.to(ct).permute(0, 3, 1, 2)
        padding = self.padding
        if padding == 'same':
            (kh, kw), (sh, sw), (dh, dw) = self.kernel_size, self.stride, self.dilation
            ph, pw = (_same_pads(x.shape[2], kh, sh, dh), _same_pads(x.shape[3], kw, sw, dw))
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        w = self.weight.to(ct, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(ct)
        y = F.conv2d(x, w, b, self.stride, padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)

    def extra_repr(self) -> str:
        return (f'{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, '
                f'stride={self.stride}, padding={self.padding}, groups={self.groups}')


def create_conv2d(
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, tuple] = 3,
        stride: int = 1,
        padding='',
        dilation: int = 1,
        groups: int = 1,
        bias: bool = False,
        depthwise: bool = False,
        num_experts: int = 0,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
) -> Conv2d:
    """An NHWC conv with timm's argument conventions; ``depthwise`` sets
    ``groups`` to ``in_channels``."""
    if isinstance(kernel_size, list):
        raise NotImplementedError('MixedConv2d (a list kernel_size) is not ported yet '
                                  '(ROADMAP A.5.6, the EfficientNet step)')
    if num_experts > 0:
        raise NotImplementedError('CondConv2d (num_experts > 0) is not ported yet '
                                  '(ROADMAP A.5.6, the EfficientNet step)')
    if depthwise:
        groups = in_channels
    kernel_size = to_2tuple(kernel_size)
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=_resolve_padding(padding, kernel_size, stride, dilation),
                  dilation=dilation, groups=groups, bias=bias, dtype=dtype, generator=generator)


class ConvNormAct(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError('ConvNormAct comes with norm_act.py (BatchNorm with running '
                                  'statistics), ROADMAP A.5.6, the ResNet step')


class SeparableConvNormAct(ConvNormAct):
    pass
