"""Gradient clipping (counterpart of timm_tpu/utils/clip_grad.py).

Pure functions over lists of gradient tensors, with the JAX package's
arithmetic: the global norm is the fp32 square root of the sum of per-leaf
sums of squares, and norm clipping scales every gradient by
``min(1, max_norm / (norm + 1e-6))`` cast to the gradient's dtype. Nothing
here reads a value back to the host.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ['adaptive_clip_grad', 'clip_grad_norm', 'clip_grad_value', 'clip_scale',
           'dispatch_clip_grad', 'global_grad_norm']


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The fp32 factor norm clipping multiplies every gradient by."""
    return torch.clamp_max(max_norm / (norm + 1e-6), 1.0)


def clip_grad_norm(grads: Sequence[torch.Tensor], max_norm: float
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    norm = global_grad_norm(grads)
    scale = clip_scale(norm, max_norm)
    return [g * scale.to(g.dtype) for g in grads], norm


def clip_grad_value(grads: Sequence[torch.Tensor], clip_value: float
                    ) -> Tuple[List[torch.Tensor], None]:
    return [torch.clamp(g, -clip_value, clip_value) for g in grads], None


def _unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-output-unit norm. The JAX package's (in, out) and HWIO kernels
    reduce over every axis but the last; the port's (out, in) and OIHW
    weights over every axis but the first: the same units."""
    if x.ndim <= 1:
        return torch.abs(x)
    return torch.sqrt(torch.sum(torch.square(x), dim=tuple(range(1, x.ndim)), keepdim=True))


def adaptive_clip_grad(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                       clip_factor: float = 0.01, eps: float = 1e-3) -> List[torch.Tensor]:
    """AGC: clip gradients unit-wise relative to the parameters' norms."""
    out = []
    for p, g in zip(params, grads):
        p_norm = torch.clamp_min(_unitwise_norm(p), eps)
        g_norm = _unitwise_norm(g)
        max_norm = p_norm * clip_factor
        clipped = g * (max_norm / torch.clamp_min(g_norm, 1e-6))
        out.append(torch.where(g_norm > max_norm, clipped, g))
    return out


def dispatch_clip_grad(grads: Sequence[torch.Tensor], value: float, mode: str = 'norm',
                       params: Optional[Sequence[torch.Tensor]] = None):
    """Returns (grads, grad_norm or None)."""
    if mode == 'norm':
        return clip_grad_norm(grads, value)
    if mode == 'value':
        return clip_grad_value(grads, value)
    if mode == 'agc':
        if params is None:
            raise ValueError('AGC requires params')
        return adaptive_clip_grad(params, grads, clip_factor=value), None
    raise ValueError(f'Unknown clip mode {mode}')
