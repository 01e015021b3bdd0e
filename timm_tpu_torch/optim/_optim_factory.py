"""Optimizer factory (counterpart of timm_tpu/optim/_optim_factory.py).

Ported names: 'sgd' (the JAX factory's coupled L2 under the mask), 'adamw',
'nadamw', 'lamb', 'muon' / 'adamuon' / 'nadamuon', 'madgrad', 'madgradw',
'laprop' and 'mars', each with the JAX factory's argument plumbing (which
of ``betas``, ``eps`` and ``momentum`` reach it, ``mu_dtype`` where the
JAX factory takes it, the weight-decay mask); the wrappers ``lookahead_<name>``,
``caution=True`` and ``layer_decay`` on any of them; ``param_group_fn`` is
accepted and unused, as in JAX. The JAX registry's other names raise
``NotImplementedError`` citing ROADMAP A.5.5.
"""
from __future__ import annotations

import inspect
import logging
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import nn

from ._optimizers import SGD, AdamW, Lamb, Laprop, Madgrad, Mars, Muon, NAdamW
from ._param_groups import param_groups_layer_decay, param_groups_weight_decay

_logger = logging.getLogger(__name__)

__all__ = ['create_optimizer_v2', 'list_optimizers']

_MU_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
# the JAX registry's names the port does not run yet, in the order they come
_QUEUED = ('adam', 'nadam', 'radam', 'adamax', 'adabelief', 'lion', 'lars', 'adopt', 'adan',
           'adafactor', 'adafactorbv', 'novograd', 'nvnovograd', 'rmsprop', 'rmsproptf', 'yogi',
           'sm3', 'adadelta', 'adagrad', 'sgdw', 'sgdp', 'momentum', 'adamp', 'lookahead')


@dataclass
class _Info:
    """A ported optimizer: its builder, with the JAX factory function's
    argument names, and the JAX registry's flags."""
    build: Callable
    has_eps: bool = True
    has_momentum: bool = False
    has_betas: bool = False
    defaults: Dict[str, Any] = field(default_factory=dict)


# Builders: (named parameters, the JAX factory function's arguments, the
# wrappers) -> optimizer. Their signatures decide, as the JAX factory's do,
# which arguments reach them.
def _sgd(params, learning_rate, momentum=None, nesterov=False, *, l2, l2_mask, wrap):
    # optax.sgd has no weight decay: the JAX factory adds coupled L2 before it
    return SGD(params, lr=learning_rate, momentum=momentum, nesterov=nesterov,
               weight_decay=l2, wd_mask=l2_mask, **wrap)


def _adamw(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, mu_dtype=None, weight_decay=1e-4,
           mask=None, *, cls=AdamW, wrap):
    return cls(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
               wd_mask=mask, mu_dtype=mu_dtype, **wrap)


def _lamb(params, learning_rate, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0, mask=None,
          mu_dtype=None, *, wrap):
    return Lamb(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                wd_mask=mask, mu_dtype=mu_dtype, **wrap)


def _muon(params, learning_rate, weight_decay=0.0, momentum=0.95, beta1=0.9, beta2=0.95,
          eps=1e-8, mask=None, *, wrap):
    # eps is taken and, as in the JAX factory, never reaches optax's muon
    return Muon(params, lr=learning_rate, momentum=momentum, weight_decay=weight_decay,
                wd_mask=mask, betas=(beta1, beta2), **wrap)


def _madgrad(params, learning_rate=1e-2, momentum=0.9, weight_decay=0.0, eps=1e-6,
             decoupled_decay=False, mask=None, *, wrap):
    return Madgrad(params, lr=learning_rate, momentum=momentum, weight_decay=weight_decay,
                   eps=eps, decoupled_decay=decoupled_decay, wd_mask=mask, **wrap)


def _laprop(params, learning_rate=4e-4, b1=0.9, b2=0.999, eps=1e-15, weight_decay=0.0,
            mask=None, *, wrap):
    return Laprop(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                  wd_mask=mask, **wrap)


def _mars(params, learning_rate=3e-3, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, gamma=0.025,
          mars_type='adamw', optimize_1d=False, lr_1d_factor=1.0, betas_1d=None, mask=None,
          *, wrap):
    return Mars(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                gamma=gamma, mars_type=mars_type, optimize_1d=optimize_1d,
                lr_1d_factor=lr_1d_factor, betas_1d=betas_1d, wd_mask=mask, **wrap)


_INTERNAL = ('params', 'learning_rate', 'cls', 'l2', 'l2_mask', 'wrap')
_OPTIMIZERS = {
    'sgd': _Info(_sgd, has_eps=False, has_momentum=True, defaults={'nesterov': True}),
    'adamw': _Info(_adamw, has_betas=True),
    'nadamw': _Info(partial(_adamw, cls=NAdamW), has_betas=True),
    'lamb': _Info(_lamb, has_betas=True),
    'muon': _Info(_muon, has_momentum=True),
    'adamuon': _Info(_muon, has_momentum=True),
    'nadamuon': _Info(_muon, has_momentum=True),
    'madgrad': _Info(_madgrad, has_momentum=True),
    'madgradw': _Info(partial(_madgrad, decoupled_decay=True), has_momentum=True),
    'laprop': _Info(_laprop, has_betas=True),
    'mars': _Info(_mars, has_betas=True),
}


def list_optimizers():
    """The optimizer names the port runs."""
    return sorted(_OPTIMIZERS)


def _signature(build: Callable):
    """The JAX factory function's argument names a builder takes."""
    return set(inspect.signature(build).parameters) - set(_INTERNAL)


def create_optimizer_v2(
        model: nn.Module,
        opt: str = 'sgd',
        lr: Optional[float] = None,
        weight_decay: float = 0.0,
        momentum: float = 0.9,
        foreach: Optional[bool] = None,  # torch-ism, accepted and ignored as in JAX
        filter_bias_and_bn: bool = True,
        layer_decay: Optional[float] = None,
        layer_decay_min_scale: float = 0.0,
        param_group_fn: Optional[Callable] = None,  # accepted and unused, as in JAX
        caution: bool = False,
        mu_dtype: Optional[Union[str, torch.dtype]] = None,
        **kwargs,
):
    """Build the optimizer over ``model``'s parameters, as the JAX factory
    builds its optax chain. Weight decay skips the leaves
    ``param_groups_weight_decay`` masks off, unless ``filter_bias_and_bn`` is
    False; ``layer_decay`` scales each leaf's update by its layer's factor
    (and always masks the decay). ``lookahead_<name>`` wraps ``name``."""
    parts = opt.lower().split('_')
    name = parts[-1]
    use_lookahead = len(parts) > 1 and parts[0] == 'lookahead'
    if name in _QUEUED:
        raise NotImplementedError(
            f'optimizer {name!r} is not ported yet (ROADMAP A.5.5); the port has '
            f'{", ".join(list_optimizers())}')
    if name not in _OPTIMIZERS:
        raise ValueError(f'Optimizer {name} not found in registry')
    info = _OPTIMIZERS[name]
    lr_scales, wd_mask = None, None
    if layer_decay is not None:
        lr_scales, wd_mask = param_groups_layer_decay(
            model, weight_decay=weight_decay, layer_decay=layer_decay,
            min_scale=layer_decay_min_scale)
    elif weight_decay and filter_bias_and_bn:
        wd_mask = param_groups_weight_decay(model, weight_decay)

    sig = _signature(info.build)
    opt_args: Dict[str, Any] = dict(info.defaults)
    betas = kwargs.pop('betas', None)
    eps = kwargs.pop('eps', None)
    if info.has_betas and betas is not None:
        opt_args.update(b1=betas[0], b2=betas[1])
    if info.has_eps and eps is not None:
        opt_args['eps'] = eps
    if info.has_momentum:
        opt_args['momentum'] = momentum
    if mu_dtype is not None:
        if 'mu_dtype' in sig:
            opt_args['mu_dtype'] = _MU_DTYPES[mu_dtype] if isinstance(mu_dtype, str) else mu_dtype
        else:
            _logger.warning(f'optimizer {name!r} has no mu_dtype support; '
                            f'ignoring mu_dtype={mu_dtype}')
    if 'weight_decay' in sig:
        opt_args['weight_decay'] = weight_decay
        if wd_mask is not None and 'mask' in sig:
            opt_args['mask'] = wd_mask
    opt_args = {k: v for k, v in opt_args.items() if k in sig}
    unknown = sorted(set(kwargs) - sig)
    if unknown:
        raise TypeError(f'unexpected arguments for {name}: {unknown}')
    opt_args.update(kwargs)
    extra = {}
    if 'weight_decay' not in sig:  # coupled L2, as the JAX factory rebinds it
        extra = dict(l2=weight_decay, l2_mask=wd_mask)
    wrap = dict(lookahead=use_lookahead, caution=caution, lr_scales=lr_scales)
    return info.build(model.named_parameters(), 1e-3 if lr is None else lr, **opt_args,
                      **extra, wrap=wrap)
