"""Weight initializers drawing from an explicit ``torch.Generator``
(counterpart of timm_tpu/layers/weight_init.py).

They follow ``jax.nn.initializers``: a truncated normal is cut at two standard
deviations and rescaled so that its standard deviation is the one asked for.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ['trunc_normal_', 'lecun_normal_', 'variance_scaling_']

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def trunc_normal_(tensor: torch.Tensor, std: float = 1.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    s = std / _TRUNC_STD
    return torch.nn.init.trunc_normal_(tensor, std=s, a=-2.0 * s, b=2.0 * s, generator=generator)


def lecun_normal_(tensor: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Variance scaling 1.0 over fan-in with a truncated normal (the fan-in of
    an (O, I, kh, kw) conv weight is I * kh * kw)."""
    return variance_scaling_(tensor, 1.0, 'fan_in', generator=generator)


@torch.no_grad()
def variance_scaling_(tensor: torch.Tensor, scale: float = 1.0, mode: str = 'fan_in',
                      distribution: str = 'normal',
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``jax.nn.initializers.variance_scaling`` on a torch-layout weight:
    (O, I, *kernel), so fan-in is I * prod(kernel) and fan-out is
    O * prod(kernel) (for a depthwise (C, 1, kh, kw) weight, C * kh * kw, as
    for JAX's (kh, kw, 1, C) kernel). 'normal' is the truncated normal, as in
    the JAX package."""
    receptive = math.prod(tensor.shape[2:])
    fan_in, fan_out = tensor.shape[1] * receptive, tensor.shape[0] * receptive
    fan = {'fan_in': fan_in, 'fan_out': fan_out, 'fan_avg': (fan_in + fan_out) / 2}[mode]
    if distribution not in ('normal', 'truncated_normal'):
        raise NotImplementedError(f'variance_scaling_ distribution {distribution!r} is not ported')
    return trunc_normal_(tensor, std=math.sqrt(scale / fan), generator=generator)
