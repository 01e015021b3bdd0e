"""Global pooling (counterpart of timm_tpu/layers/pool.py): of token
sequences (``global_pool_nlc``) and of NHWC feature maps
(``SelectAdaptivePool2d``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ['SelectAdaptivePool2d', 'adaptive_pool_feat_mult', 'global_pool_nlc']


def global_pool_nlc(
        x: torch.Tensor,
        pool_type: str = 'token',
        num_prefix_tokens: int = 1,
        mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pool (B, N, C) tokens to (B, C).

    ``mask`` is an optional key-padding mask, True = valid token,
    broadcastable to (B, N) ((N,), (B, N) or (B, 1, 1, N)): the reductions then
    ignore padded tokens (the masked mean divides by the valid count, the
    masked max fills pads with -inf).
    """
    if not pool_type:
        return x
    if pool_type == 'token':
        return x[:, 0]
    if mask is not None:
        mask = mask.reshape(mask.shape[0] if mask.ndim > 1 else 1, -1)  # (B|1, N)
    x = x[:, num_prefix_tokens:]
    if mask is not None:
        mask = mask[:, num_prefix_tokens:]
    if mask is None:
        if pool_type == 'avg':
            return x.mean(dim=1)
        if pool_type == 'max':
            return x.amax(dim=1)
        if pool_type == 'avgmax':
            return 0.5 * (x.amax(dim=1) + x.mean(dim=1))
        raise ValueError(f'Unknown pool type {pool_type}')
    m = mask[..., None]  # (B|1, N, 1)
    count = torch.clamp_min(m.sum(dim=1), 1).to(x.dtype)

    def _masked_avg():
        return torch.where(m, x, 0).sum(dim=1) / count

    def _masked_max():
        return torch.where(m, x, float('-inf')).amax(dim=1)

    if pool_type == 'avg':
        return _masked_avg()
    if pool_type == 'max':
        return _masked_max()
    if pool_type == 'avgmax':
        return 0.5 * (_masked_max() + _masked_avg())
    raise ValueError(f'Unknown pool type {pool_type}')


def adaptive_pool_feat_mult(pool_type: str = 'avg') -> int:
    return 2 if pool_type.endswith('catavgmax') else 1


class SelectAdaptivePool2d(nn.Module):
    """Global pooling over the spatial dims of NHWC input to (B, C) (or
    (B, 2C) for 'catavgmax'); '' is the identity. The 'fast' prefixes name
    the same NHWC reductions, as in the JAX package."""

    def __init__(self, output_size=1, pool_type: str = 'avg', flatten: bool = False,
                 input_fmt: str = 'NHWC'):
        super().__init__()
        if input_fmt != 'NHWC':
            raise NotImplementedError(f'SelectAdaptivePool2d over {input_fmt}: the port pools NHWC')
        self.pool_type = pool_type or ''
        self.flatten = flatten

    def is_identity(self) -> bool:
        return not self.pool_type

    def feat_mult(self) -> int:
        return adaptive_pool_feat_mult(self.pool_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.pool_type:
            return x
        pt = self.pool_type
        if pt.startswith('fast'):
            pt = pt[4:].lstrip('_') or 'avg'
        if pt == 'avg':
            return x.mean(dim=(1, 2))
        if pt == 'max':
            return x.amax(dim=(1, 2))
        if pt == 'avgmax':
            return 0.5 * (x.mean(dim=(1, 2)) + x.amax(dim=(1, 2)))
        if pt == 'catavgmax':
            return torch.cat([x.mean(dim=(1, 2)), x.amax(dim=(1, 2))], dim=-1)
        raise ValueError(f'Invalid pool type: {self.pool_type}')
