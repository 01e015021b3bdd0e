"""Anti-aliased downsampling over NHWC activations (counterpart of
timm_tpu/layers/blur_pool.py): ``BlurPool2d``, ``AvgPool2dAA`` and
``get_aa_layer``.

Traps, where the JAX package is not torch timm:

- ``AvgPool2dAA`` is a 'SAME' window sum over s x s at stride s divided by
  s^2, so an odd size is padded at the end only and the padded zeros count
  in the mean. That is not ``F.avg_pool2d``'s symmetric padding; the port
  pads at the end and sums (``divisor_override=1``), then divides.
- ``BlurPool2d`` pads (pad, filt - 1 - pad) with ``reflect`` ('blur'), or
  ``constant`` zeros ('blurpc'), then runs a depthwise conv of the binomial
  filter at the stride. The filter is a constant computed in fp32 and cast to
  the input's dtype, as JAX's. JAX keeps it in an ``nnx.Variable`` named
  ``_kernel``, which ``model_state_dict`` leaves out; the port's is a
  non-persistent buffer of the same name, out of ``state_dict``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ['AvgPool2dAA', 'BlurPool2d', 'get_aa_layer']


class BlurPool2d(nn.Module):
    """Fixed binomial low-pass filter then stride (Zhang 2019), depthwise."""

    def __init__(self, channels: int, filt_size: int = 3, stride: int = 2,
                 pad_mode: str = 'reflect', **_):
        super().__init__()
        if filt_size < 2:
            raise ValueError('BlurPool2d needs filt_size > 1')
        self.channels, self.filt_size, self.stride, self.pad_mode = (
            channels, filt_size, stride, pad_mode)
        coeffs = np.poly1d((0.5, 0.5)) ** (filt_size - 1)
        blur_1d = np.asarray(coeffs.coeffs, np.float32)
        blur_2d = blur_1d[:, None] * blur_1d[None, :]
        # (C, 1, k, k): the depthwise weight of F.conv2d
        self.register_buffer('_kernel', torch.from_numpy(np.ascontiguousarray(
            np.tile(blur_2d[None, None], (channels, 1, 1, 1)))), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H', W', C)."""
        pad = (self.filt_size - 1) // 2
        rest = self.filt_size - 1 - pad
        x = x.permute(0, 3, 1, 2)
        x = F.pad(x, (pad, rest, pad, rest), mode=self.pad_mode)
        w = self._kernel.to(x.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, groups=self.channels).permute(0, 2, 3, 1)


def _same_end_pad(size: int, s: int) -> int:
    """XLA's 'SAME' padding of a window s at stride s: all of it at the end."""
    return max((-(-size // s) - 1) * s + s - size, 0)


class AvgPool2dAA(nn.Module):
    """The 2x2 average-pool anti-aliasing layer ('avg'): the 'SAME' window
    sum over s x s at stride s, divided by s^2."""

    def __init__(self, channels: int = 0, stride: int = 2, **_):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        x = x.permute(0, 3, 1, 2)
        x = F.pad(x, (0, _same_end_pad(x.shape[3], s), 0, _same_end_pad(x.shape[2], s)))
        return (F.avg_pool2d(x, s, s, divisor_override=1) / (s * s)).permute(0, 2, 3, 1)


def get_aa_layer(aa_layer=None) -> Optional[type]:
    """The anti-aliasing layer of a name or callable: 'avg' / 'avgpool',
    'blur' / 'blurpool', 'blurpc' (zero-padded blur pool)."""
    if aa_layer is None or aa_layer == '':
        return None
    if not isinstance(aa_layer, str):
        return aa_layer
    name = aa_layer.lower().replace('_', '').replace('2d', '')
    if name in ('avg', 'avgpool'):
        return AvgPool2dAA
    if name in ('blur', 'blurpool'):
        return BlurPool2d
    if name == 'blurpc':
        return functools.partial(BlurPool2d, pad_mode='constant')
    raise ValueError(f'Unknown anti-aliasing layer {aa_layer}')
