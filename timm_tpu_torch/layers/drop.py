"""Stochastic depth and dropout (counterpart of timm_tpu/layers/drop.py).

Both are the identity in eval mode. In training mode the keep mask is drawn
from an explicit ``torch.Generator`` (the module's ``generator``, which the
model builder or the training task sets with ``set_drop_generator``), never
from torch's global RNG; a module asked to drop without one raises, as flax's
``Dropout`` does without ``rngs``.

Kept values are computed as the JAX package computes them:
``where(mask, x / keep_prob, 0)`` with ``keep_prob`` rounded to x's dtype
(JAX's weakly typed scalar), so a bf16 activation is divided by
bf16(keep_prob) rather than multiplied by a rounded reciprocal.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

__all__ = ['DropPath', 'Dropout', 'apply_keep_mask', 'calculate_drop_path_rates', 'drop_path',
           'dropout', 'get_drop_generator', 'set_drop_generator']


def apply_keep_mask(x: torch.Tensor, mask: torch.Tensor, keep_prob: float,
                    scale_by_keep: bool = True) -> torch.Tensor:
    """``where(mask, x / keep_prob, 0)`` (or ``where(mask, x, 0)``) with a
    bool ``mask`` that broadcasts against ``x``."""
    kept = x / torch.tensor(keep_prob, dtype=x.dtype) if scale_by_keep else x
    return torch.where(mask, kept, 0.0)


def _keep_mask(shape, keep_prob: float, device, generator: Optional[torch.Generator],
               what: str) -> torch.Tensor:
    if generator is None:
        raise RuntimeError(
            f'{what} in training mode needs a torch.Generator: build the model with '
            'create_model(..., seed=...) or call set_drop_generator(model, generator)')
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def drop_path(x: torch.Tensor, drop_prob: float = 0.0, training: bool = False,
              scale_by_keep: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Drop whole residual-branch outputs per sample."""
    if drop_prob == 0.0 or not training:
        return x
    keep_prob = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = _keep_mask(shape, keep_prob, x.device, generator, 'drop_path')
    return apply_keep_mask(x, mask, keep_prob, scale_by_keep)


def dropout(x: torch.Tensor, rate: float = 0.0, training: bool = False,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout with flax's formula."""
    if rate == 0.0 or not training:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    return apply_keep_mask(x, _keep_mask(x.shape, keep_prob, x.device, generator, 'dropout'),
                           keep_prob)


class DropPath(nn.Module):
    def __init__(self, drop_prob: float = 0.0, scale_by_keep: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_prob = float(drop_prob)
        self.scale_by_keep = scale_by_keep
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return drop_path(x, self.drop_prob, self.training, self.scale_by_keep, self.generator)


class Dropout(nn.Module):
    """Dropout with flax's formula and an explicit generator."""

    def __init__(self, rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.training, self.generator)


def set_drop_generator(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Give every DropPath and Dropout under ``module`` the generator its
    masks are drawn from (one shared stream, drawn in forward order)."""
    for m in module.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = generator
    return module


def get_drop_generator(module: nn.Module) -> Optional[torch.Generator]:
    """The generator the DropPath and Dropout modules under ``module`` draw
    from (None without such modules); more than one raises, since a
    checkpoint stores one stream."""
    gens = {id(m.generator): m.generator for m in module.modules()
            if isinstance(m, (DropPath, Dropout)) and m.generator is not None}
    if len(gens) > 1:
        raise RuntimeError('the drop layers draw from more than one generator; '
                           'give them one with set_drop_generator')
    return next(iter(gens.values()), None)


def calculate_drop_path_rates(drop_path_rate: float, depth: int) -> List[float]:
    """Linearly increasing per-block drop-path rates."""
    return [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
