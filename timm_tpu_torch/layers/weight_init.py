"""Weight initializers drawing from an explicit ``torch.Generator``
(counterpart of timm_tpu/layers/weight_init.py).

They follow ``jax.nn.initializers``: a truncated normal is cut at two standard
deviations and rescaled so that its standard deviation is the one asked for.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ['trunc_normal_', 'lecun_normal_']

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def trunc_normal_(tensor: torch.Tensor, std: float = 1.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    s = std / _TRUNC_STD
    return torch.nn.init.trunc_normal_(tensor, std=s, a=-2.0 * s, b=2.0 * s, generator=generator)


@torch.no_grad()
def lecun_normal_(tensor: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Variance scaling 1.0 over fan-in with a truncated normal (the fan-in of
    an (O, I, kh, kw) conv weight is I * kh * kw)."""
    fan_in = math.prod(tensor.shape[1:])
    return trunc_normal_(tensor, std=math.sqrt(1.0 / fan_in), generator=generator)
