"""Mixed grouped convolution, MixConv (counterpart of
timm_tpu/layers/mixed_conv2d.py): the channels are split into groups, each
convolved with its own kernel size, and the outputs concatenated. The
per-split convolutions are ``convs.<i>``, as in JAX, so the weights carry
by name.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

__all__ = ['MixedConv2d']


def _split_channels(num_chan: int, num_groups: int) -> List[int]:
    split = [num_chan // num_groups for _ in range(num_groups)]
    split[0] += num_chan - sum(split)
    return split


class MixedConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, List[int]] = 3, stride: int = 1, padding='',
                 dilation: int = 1, depthwise: bool = False, bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from .create_conv2d import create_conv2d
        kernel_size = kernel_size if isinstance(kernel_size, list) else [kernel_size]
        in_splits = _split_channels(in_channels, len(kernel_size))
        out_splits = _split_channels(out_channels, len(kernel_size))
        self.in_channels, self.out_channels = sum(in_splits), sum(out_splits)
        self.convs = nn.ModuleList([
            create_conv2d(cin, cout, k, stride=stride, padding=padding, dilation=dilation,
                          groups=cin if depthwise else 1, bias=bias, dtype=dtype,
                          generator=generator)
            for k, cin, cout in zip(kernel_size, in_splits, out_splits)])
        self.splits = in_splits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) -> (B, H', W', C_out)."""
        outs = [conv(part) for conv, part in zip(self.convs, torch.split(x, self.splits, dim=-1))]
        return torch.cat(outs, dim=-1)
