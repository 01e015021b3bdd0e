"""Activation functions (counterpart of timm_tpu/layers/create_act.py; only
what the ported models use)."""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

__all__ = ['gelu', 'get_act_fn']


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU computed in fp32 and cast back to the input dtype."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.erf(xf * 0.7071067811865476))
    return out.to(x.dtype)


_ACT_FNS = {
    '': None,
    'none': None,
    'identity': lambda x: x,
    'gelu': gelu,
    'gelu_erf': gelu,
    'tanh': torch.tanh,
}


def get_act_fn(name: Union[str, Callable, None] = 'gelu') -> Optional[Callable]:
    if name is None or callable(name):
        return name
    if name not in _ACT_FNS:
        raise NotImplementedError(
            f'activation {name!r} is not ported yet (ported: {sorted(k for k in _ACT_FNS if k)})')
    return _ACT_FNS[name]
