"""Absolute position-embedding resampling (counterpart of
timm_tpu/layers/pos_embed.py).

The JAX package resizes with ``jax.image.resize(method='cubic',
antialias=True)`` in fp32. That resize is separable: along each spatial
axis whose size changes it contracts with a (old, new) weight matrix, Keys'
cubic kernel with a = -0.5, widened by the down-sampling factor and
renormalised (``jax.image``'s ``compute_weight_mat``). The port builds the
same matrices (``layers/patch_embed.py`` ``resample_weight_matrix``) and
applies them with ``einsum``; ``F.interpolate``'s bicubic (a = -0.75, edges
clamped, no antialias) computes something else. An axis whose size does not
change is left alone, as ``jax.image`` leaves it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .patch_embed import resample_weight_matrix

__all__ = ['resample_abs_pos_embed', 'resample_abs_pos_embed_nhwc']


def _check_method(interpolation: str, antialias: bool) -> None:
    if interpolation not in ('cubic', 'bicubic') or not antialias:
        raise NotImplementedError(
            f'pos-embed resampling with {interpolation!r} (antialias={antialias}): the port '
            "has jax.image's antialiased cubic only")


def _resize_grid(grid: torch.Tensor, new_size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) fp32 -> (B, H', W', C) by the separable cubic resize."""
    h, w = grid.shape[1:3]
    if new_size[0] != h:
        wh = resample_weight_matrix(h, new_size[0]).to(grid.device)
        grid = torch.einsum('bhwc,ha->bawc', grid, wh)
    if new_size[1] != w:
        ww = resample_weight_matrix(w, new_size[1]).to(grid.device)
        grid = torch.einsum('bhwc,wa->bhac', grid, ww)
    return grid


def resample_abs_pos_embed(
        posemb: torch.Tensor,
        new_size: Tuple[int, int],
        old_size: Optional[Tuple[int, int]] = None,
        num_prefix_tokens: int = 1,
        interpolation: str = 'cubic',
        antialias: bool = True,
) -> torch.Tensor:
    """Resize a (1, N, C) learned position embedding to a new token grid;
    the prefix (class, register) tokens' rows are carried through as they
    are. The resize is in fp32, the result in the input's dtype."""
    _check_method(interpolation, antialias)
    num_new_tokens = new_size[0] * new_size[1] + num_prefix_tokens
    if num_new_tokens == posemb.shape[1] and new_size[0] == new_size[1]:
        return posemb
    if old_size is None:
        hw = int(math.sqrt(posemb.shape[1] - num_prefix_tokens))
        old_size = (hw, hw)
    prefix = posemb[:, :num_prefix_tokens] if num_prefix_tokens else None
    grid = posemb[:, num_prefix_tokens:]
    dim = grid.shape[-1]
    grid = _resize_grid(grid.float().reshape(1, old_size[0], old_size[1], dim), tuple(new_size))
    grid = grid.reshape(1, -1, dim).to(posemb.dtype)
    return torch.cat([prefix, grid], dim=1) if prefix is not None else grid


def resample_abs_pos_embed_nhwc(posemb: torch.Tensor, new_size: Tuple[int, int],
                                interpolation: str = 'cubic', antialias: bool = True) -> torch.Tensor:
    """Resize a (B, H, W, C) position-embedding grid."""
    _check_method(interpolation, antialias)
    if tuple(posemb.shape[1:3]) == tuple(new_size):
        return posemb
    return _resize_grid(posemb.float(), tuple(new_size)).to(posemb.dtype)
