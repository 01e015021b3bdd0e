"""Activation functions (counterpart of timm_tpu/layers/create_act.py; the
names that the ported models and layers resolve).

The JAX package's definitions, op for op, rather than torch's built-ins
where those differ: ``silu`` is ``x * sigmoid(x)`` (two roundings in bf16,
as JAX's, where ``F.silu`` rounds once), ``hard_sigmoid`` is
``relu6(x + 3) / 6``, ``hard_swish`` is ``x * hard_sigmoid(x)``, ``mish`` is
``x * tanh(softplus(x))`` with JAX's softplus ``log(1 + exp(x))`` (no
threshold), ``gelu_tanh`` is ``jax.nn.gelu(approximate=True)``'s chain in
x's dtype, and ``quick_gelu`` is ``x * sigmoid(1.702 x)``.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

__all__ = ['gelu', 'gelu_tanh', 'get_act_fn', 'hard_sigmoid', 'hard_swish', 'mish',
           'quick_gelu', 'silu']


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU computed in fp32 and cast back to the input dtype."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.erf(xf * 0.7071067811865476))
    return out.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU, JAX's ops in x's dtype:
    x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    cdf = 0.5 * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * (x ** 3))))
    return x * cdf


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(_softplus(x))


_ACT_FNS = {
    '': None,
    'none': None,
    'identity': lambda x: x,
    'relu': torch.relu,
    'relu6': relu6,
    'gelu': gelu,
    'gelu_erf': gelu,
    'gelu_tanh': gelu_tanh,
    'quick_gelu': quick_gelu,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'silu': silu,
    'swish': silu,
    'mish': mish,
    'hard_sigmoid': hard_sigmoid,
    'hard_swish': hard_swish,
    'hardswish': hard_swish,
    'hardsigmoid': hard_sigmoid,
}
# the JAX map's other names, ported with the first model that selects one
_QUEUED = ('leaky_relu', 'elu', 'celu', 'selu', 'hard_mish', 'softplus')


def get_act_fn(name: Union[str, Callable, None] = 'relu') -> Optional[Callable]:
    if name is None or callable(name):
        return name
    name = name.lower()
    if name in _QUEUED:
        raise NotImplementedError(f'activation {name!r} is not ported yet (ROADMAP A.5.9, with '
                                  'the first model that selects it)')
    if name not in _ACT_FNS:
        raise ValueError(f'Unknown activation: {name}')
    return _ACT_FNS[name]
