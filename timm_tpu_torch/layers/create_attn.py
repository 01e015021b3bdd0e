"""Attention-module factory (counterpart of timm_tpu/layers/create_attn.py):
the JAX package's names; 'se', 'ese', 'eca' and 'ceca' are ported, the
others raise citing the ROADMAP item that ports them."""
from __future__ import annotations

from typing import Callable, Union

from .eca import CecaModule, EcaModule
from .squeeze_excite import EffectiveSEModule, SEModule

__all__ = ['create_attn', 'get_attn']

_ATTN_MAP = dict(se=SEModule, ese=EffectiveSEModule, eca=EcaModule, ceca=CecaModule)
# the JAX package's other names, by the ROADMAP item that ports them
_NOT_PORTED = {name: 'A.5.9, with the rest of the zoo' for name in (
    'bottleneck', 'halo', 'cbam', 'lcbam', 'ge', 'gc', 'gca', 'nl', 'bat', 'sk', 'splat',
    'lambda')}


def get_attn(attn_type: Union[str, Callable, None]):
    if attn_type is None or callable(attn_type):
        return attn_type
    name = attn_type.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(f'attn module {attn_type!r} is not ported yet '
                                  f'(ROADMAP {_NOT_PORTED[name]})')
    if name not in _ATTN_MAP:
        raise ValueError(f'Unknown/unsupported attn module: {attn_type}')
    return _ATTN_MAP[name]


def create_attn(attn_type, channels: int, **kwargs):
    module_cls = get_attn(attn_type)
    if module_cls is None:
        return None
    return module_cls(channels, **kwargs)
