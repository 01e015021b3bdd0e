"""Efficient Channel Attention over NHWC features (counterpart of
timm_tpu/layers/eca.py): ``EcaModule`` and ``CecaModule``.

The mean over (H, W) gives one descriptor per channel; a 1-D conv of one
input and one output channel runs along the channels, and its gate scales
the input. Traps:

- The kernel size comes from the channel count when ``channels`` is given,
  t = int(|log2(C) + beta| / gamma), made odd, at least 3; ``kernel_size``
  is then ignored, as JAX's.
- JAX's conv is ``nnx.Conv`` with 'SAME' padding and a (k, 1, 1) kernel.
  The port's weight is (1, 1, k), the ``F.conv1d`` layout; the converter
  transposes a 3-d kernel (W, I, O) -> (O, I, W).
- ``CecaModule`` is ``EcaModule`` in the JAX package: 'SAME' zero padding
  where torch timm pads circularly. The port copies JAX.
- dtypes are flax's: the conv computes in ``dtype``, else in the promotion
  of the descriptor's and the weight's dtypes, so a bf16 input with no
  ``dtype`` is gated in fp32 and comes out fp32, as in JAX.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .create_act import get_act_fn
from .linear import compute_dtype
from .weight_init import variance_scaling_

__all__ = ['CecaModule', 'EcaModule']


class EcaModule(nn.Module):
    """1-D conv over the channel descriptors, no dimensionality reduction."""

    def __init__(self, channels: Optional[int] = None, kernel_size: int = 3, gamma: float = 2,
                 beta: float = 1, gate_layer: Union[str, Callable] = 'sigmoid',
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, **_):
        super().__init__()
        if channels is not None:
            t = int(abs(math.log(channels, 2) + beta) / gamma)
            kernel_size = max(t if t % 2 else t + 1, 3)
        if kernel_size % 2 != 1:
            raise ValueError(f'EcaModule needs an odd kernel size, got {kernel_size}')
        self.kernel_size = kernel_size
        self.compute_dtype = dtype
        self.conv = nn.Conv1d(1, 1, kernel_size, padding=kernel_size // 2, bias=False)
        variance_scaling_(self.conv.weight, 1.0, 'fan_in', 'normal', generator=generator)
        self.gate = get_act_fn(gate_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(1, 2))[:, None, :]  # (B, 1, C)
        ct = compute_dtype(y, self.compute_dtype, self.conv.weight)
        y = F.conv1d(y.to(ct), self.conv.weight.to(ct), padding=self.kernel_size // 2)[:, 0]
        return x * self.gate(y)[:, None, None, :]


class CecaModule(EcaModule):
    """ECA with the JAX package's 'SAME' zero padding (see the module
    docstring)."""
