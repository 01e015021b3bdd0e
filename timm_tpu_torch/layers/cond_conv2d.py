"""Conditionally parameterized convolution, CondConv (counterpart of
timm_tpu/layers/cond_conv2d.py).

The expert kernels are stored as JAX stores them: ``weight`` (E, P), each
row one expert's kernel flattened in HWIO order (kh, kw, C_in / groups,
C_out), and ``bias`` (E, C_out). So they carry from the JAX package as
they are. A forward mixes the experts by the routing weights (B, E) in one
product into per-sample kernels, lays them out as OIHW, and runs every
sample's convolution in one grouped convolution over B * groups groups
(JAX ``vmap``s a convolution per sample).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .create_conv2d import _resolve_padding, _same_pads
from .helpers import to_2tuple

__all__ = ['CondConv2d']


class CondConv2d(nn.Module):
    """NHWC CondConv; ``forward(x, routing_weights)`` with routing (B, E),
    computed in ``dtype``, else in x's dtype (JAX's rule for this layer).
    Each expert is drawn as JAX draws it: uniform within 1 / sqrt(fan_in)
    (variance scaling 1/3 over fan-in), and the bias likewise."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride: int = 1,
                 padding='', dilation: int = 1, groups: int = 1, bias: bool = False,
                 num_experts: int = 4, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = to_2tuple(kernel_size)
        self.stride = to_2tuple(stride)
        self.dilation = to_2tuple(dilation)
        self.groups = groups
        self.num_experts = num_experts
        self.compute_dtype = dtype
        self.padding = _resolve_padding(padding, self.kernel_size, stride, dilation)
        # the HWIO shape of one expert's kernel
        self.weight_shape = self.kernel_size + (in_channels // groups, out_channels)
        bound = 1.0 / math.sqrt(math.prod(self.weight_shape[:-1]))
        self.weight = nn.Parameter(torch.empty(num_experts, math.prod(self.weight_shape)))
        self.bias = nn.Parameter(torch.empty(num_experts, out_channels)) if bias else None
        with torch.no_grad():
            for p in (self.weight, self.bias):
                if p is not None:
                    p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, routing_weights: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in), (B, E) -> (B, H', W', C_out)."""
        b = x.shape[0]
        ct = self.compute_dtype or x.dtype  # JAX's rule here: dtype, else x's
        r = routing_weights.to(ct)
        kh, kw, cin_g, cout = self.weight_shape
        w = (r @ self.weight.to(ct)).reshape(b, kh, kw, cin_g, cout)
        w = w.permute(0, 4, 3, 1, 2).reshape(b * cout, cin_g, kh, kw)
        # the batch folded into the channels: (1, B * C_in, H, W)
        x = x.to(ct).permute(0, 3, 1, 2).reshape(1, b * self.in_channels, *x.shape[1:3])
        padding = self.padding
        if padding == 'same':
            ph = _same_pads(x.shape[2], kh, self.stride[0], self.dilation[0])
            pw = _same_pads(x.shape[3], kw, self.stride[1], self.dilation[1])
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        y = F.conv2d(x, w, None, self.stride, padding, self.dilation, b * self.groups)
        y = y.reshape(b, cout, *y.shape[2:]).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + (r @ self.bias.to(ct))[:, None, None, :]
        return y
