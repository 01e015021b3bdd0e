"""Norm factory (counterpart of timm_tpu/layers/create_norm.py): the same
name map. The batchnorm and groupnorm names raise until ``norm_act.py`` is
ported (ROADMAP A.5.6, the ResNet step)."""
from __future__ import annotations

from typing import Callable, Optional, Union

from .norm import LayerNorm, LayerNorm2d, LayerNormFp32, RmsNorm, RmsNorm2d, SimpleNorm, SimpleNorm2d

__all__ = ['create_norm_layer', 'get_norm_layer']

_NORM_MAP = dict(
    layernorm=LayerNorm,
    layernorm2d=LayerNorm2d,
    layernormfp32=LayerNormFp32,
    rmsnorm=RmsNorm,
    rmsnorm2d=RmsNorm2d,
    simplenorm=SimpleNorm,
    simplenorm2d=SimpleNorm2d,
)
_NOT_PORTED = ('batchnorm', 'batchnorm2d', 'batchnorm1d', 'groupnorm', 'groupnorm1')


def get_norm_layer(norm_layer: Union[str, Callable, None]) -> Optional[Callable]:
    if norm_layer is None:
        return None
    if not isinstance(norm_layer, str):
        return norm_layer
    name = norm_layer.replace('_', '').lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(f'norm layer {norm_layer!r} is not ported yet (ROADMAP A.5.6, '
                                  'the ResNet step, with norm_act.py)')
    if name not in _NORM_MAP:
        raise ValueError(f'Unknown norm layer {norm_layer}')
    return _NORM_MAP[name]


def create_norm_layer(norm_layer, num_features: int, **kwargs):
    return get_norm_layer(norm_layer)(num_features, **kwargs)
