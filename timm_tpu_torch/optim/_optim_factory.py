"""Optimizer factory (counterpart of timm_tpu/optim/_optim_factory.py).

Ported: ``opt='adamw'`` (the plain chain the JAX package's fused kernel
mirrors, with ``betas``, ``eps``, the weight-decay mask and ``mu_dtype``) and
``opt='sgd'`` (momentum, Nesterov by default, and the JAX factory's coupled
L2 weight decay under the same mask). Every other optimizer name, and
lookahead, caution, layer decay and ``param_group_fn``, raise
``NotImplementedError`` (ROADMAP §A.5).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ._optimizers import SGD, AdamW
from ._param_groups import param_groups_weight_decay

__all__ = ['create_optimizer_v2']

_MU_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _not_ported(what: str):
    return NotImplementedError(f'{what} is not ported yet (ROADMAP §A.5); the port has '
                               "opt='adamw' and opt='sgd'")


def create_optimizer_v2(
        model: nn.Module,
        opt: str = 'sgd',
        lr: Optional[float] = None,
        weight_decay: float = 0.0,
        momentum: float = 0.9,
        foreach: Optional[bool] = None,  # torch-ism, accepted and ignored as in JAX
        filter_bias_and_bn: bool = True,
        layer_decay: Optional[float] = None,
        param_group_fn: Optional[Callable] = None,
        caution: bool = False,
        mu_dtype: Optional[Union[str, torch.dtype]] = None,
        **kwargs,
) -> Union[AdamW, SGD]:
    """Build the optimizer over ``model``'s parameters. Weight decay skips
    the leaves ``param_groups_weight_decay`` masks off, unless
    ``filter_bias_and_bn`` is False."""
    name = opt.lower()
    if name.startswith('lookahead_'):
        raise _not_ported('lookahead')
    if layer_decay is not None:
        raise _not_ported('layer decay')
    if caution:
        raise _not_ported('the cautious update')
    if param_group_fn is not None:
        raise _not_ported('param_group_fn')
    if name not in ('adamw', 'sgd'):
        raise _not_ported(f'optimizer {opt!r}')
    lr = 1e-3 if lr is None else lr
    wd_mask = (param_groups_weight_decay(model, weight_decay)
               if weight_decay and filter_bias_and_bn else None)
    betas = kwargs.pop('betas', None)
    eps = kwargs.pop('eps', None)
    if name == 'adamw':
        if kwargs:
            raise TypeError(f'unexpected arguments for adamw: {sorted(kwargs)}')
        if isinstance(mu_dtype, str):
            mu_dtype = _MU_DTYPES[mu_dtype]
        return AdamW(model.named_parameters(), lr=lr, betas=tuple(betas or (0.9, 0.999)),
                     eps=1e-8 if eps is None else eps, weight_decay=weight_decay,
                     wd_mask=wd_mask, mu_dtype=mu_dtype)
    nesterov = kwargs.pop('nesterov', True)
    if kwargs:
        raise TypeError(f'unexpected arguments for sgd: {sorted(kwargs)}')
    return SGD(model.named_parameters(), lr=lr, momentum=momentum, nesterov=nesterov,
               weight_decay=weight_decay, wd_mask=wd_mask)
