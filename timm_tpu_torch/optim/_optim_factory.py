"""Optimizer factory (counterpart of timm_tpu/optim/_optim_factory.py).

Every name of the JAX registry, each with the JAX factory's argument
plumbing: which of ``betas`` (three for 'adan'), ``eps`` and ``momentum``
reach it, ``mu_dtype`` where the JAX factory takes it, the weight-decay
mask, and the coupled L2 in front of a name whose JAX factory has no
weight-decay argument ('sgd', 'momentum', 'adam', 'nadam', 'radam',
'adamax', 'adabelief', 'adagrad', 'rmsprop', 'yogi', 'sm3', 'adopt',
'lookahead'). The JAX registry's approximations are kept: 'sgdp' is SGDW,
'adamp' is AdamW, 'nvnovograd' is NovoGrad and 'lookahead' alone is plain
SGD. The wrappers ``lookahead_<name>``, ``caution=True`` and ``layer_decay``
go on any of them; ``param_group_fn`` is accepted and unused, as in JAX.
"""
from __future__ import annotations

import inspect
import logging
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import nn

from ._optimizers import (
    SGD, SGDW, SM3, AdaBelief, Adadelta, Adafactor, Adagrad, Adam, Adamax, AdamP, AdamW, Adan,
    Adopt, Lamb, Laprop, Lars, Lion, Madgrad, Mars, Muon, NAdamW, NovoGrad, RAdam, RMSprop, Yogi,
)
from ..layers import Conv2d
from ._param_groups import param_groups_layer_decay, param_groups_weight_decay

_logger = logging.getLogger(__name__)

__all__ = ['create_optimizer_v2', 'list_optimizers']

_MU_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclass
class _Info:
    """A ported optimizer: its builder, with the JAX factory function's
    argument names, and the JAX registry's flags."""
    build: Callable
    has_eps: bool = True
    has_momentum: bool = False
    has_betas: bool = False
    num_betas: int = 2
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


def _adam(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, mu_dtype=None, *, nesterov=False,
          l2, l2_mask, wrap):
    return Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps, mu_dtype=mu_dtype,
                nesterov=nesterov, weight_decay=l2, wd_mask=l2_mask, **wrap)


def _radam(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, threshold=5.0, *, l2, l2_mask,
           wrap):
    return RAdam(params, lr=learning_rate, betas=(b1, b2), eps=eps, threshold=threshold,
                 weight_decay=l2, wd_mask=l2_mask, **wrap)


def _adamax(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, *, l2, l2_mask, wrap):
    return Adamax(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=l2,
                  wd_mask=l2_mask, **wrap)


def _adabelief(params, learning_rate, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, *, l2,
               l2_mask, wrap):
    return AdaBelief(params, lr=learning_rate, betas=(b1, b2), eps=eps, eps_root=eps_root,
                     weight_decay=l2, wd_mask=l2_mask, **wrap)


def _yogi(params, learning_rate, b1=0.9, b2=0.999, eps=1e-3, *, l2, l2_mask, wrap):
    return Yogi(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=l2,
                wd_mask=l2_mask, **wrap)


def _adopt(params, learning_rate, b1=0.9, b2=0.9999, eps=1e-6, mu_dtype=None, *, l2, l2_mask,
           wrap):
    return Adopt(params, lr=learning_rate, betas=(b1, b2), eps=eps, mu_dtype=mu_dtype,
                 weight_decay=l2, wd_mask=l2_mask, **wrap)


def _lion(params, learning_rate, b1=0.9, b2=0.99, mu_dtype=None, weight_decay=1e-3, mask=None,
          *, wrap):
    return Lion(params, lr=learning_rate, betas=(b1, b2), mu_dtype=mu_dtype,
                weight_decay=weight_decay, wd_mask=mask, **wrap)


def _lars(params, learning_rate, momentum=0.9, weight_decay=0.0, trust_coefficient=0.001,
          mask=None, *, wrap):
    return Lars(params, lr=learning_rate, momentum=momentum, weight_decay=weight_decay,
                trust_coefficient=trust_coefficient, wd_mask=mask, **wrap)


def _adan(params, learning_rate, b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8,
          weight_decay=0.0, mask=None, *, wrap):
    return Adan(params, lr=learning_rate, betas=(b1, b2, b3), eps=eps, eps_root=eps_root,
                weight_decay=weight_decay, wd_mask=mask, **wrap)


def _adafactor(params, learning_rate, eps=None, clipping_threshold=1.0, decay_rate=0.8,
               weight_decay=0.0, mask=None, min_dim_size_to_factor=32, *, kernels, wrap):
    # eps is taken and, as in the JAX factory, never reaches optax's adafactor
    return Adafactor(params, lr=learning_rate, clipping_threshold=clipping_threshold,
                     decay_rate=decay_rate, weight_decay=weight_decay, wd_mask=mask,
                     min_dim_size_to_factor=min_dim_size_to_factor, kernels=kernels, **wrap)


def _novograd(params, learning_rate, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0, weight_decay=0.0,
              *, wrap):
    # optax's novograd decays every leaf: the JAX factory passes it no mask
    return NovoGrad(params, lr=learning_rate, betas=(b1, b2), eps=eps, eps_root=eps_root,
                    weight_decay=weight_decay, **wrap)


def _rmsprop(params, learning_rate, decay=0.9, eps=1e-8, momentum=0.9, *, l2, l2_mask, wrap):
    return RMSprop(params, lr=learning_rate, decay=decay, eps=eps, momentum=momentum,
                   weight_decay=l2, wd_mask=l2_mask, **wrap)


def _rmsprop_tf(params, learning_rate, alpha=0.9, eps=1e-10, momentum=0.9, weight_decay=0.0,
                mask=None, *, wrap):
    return RMSprop(params, lr=learning_rate, decay=alpha, eps=eps, momentum=momentum,
                   weight_decay=weight_decay, wd_mask=mask, tf=True, **wrap)


def _sm3(params, learning_rate, momentum=0.9, *, kernels, l2, l2_mask, wrap):
    return SM3(params, lr=learning_rate, momentum=momentum, weight_decay=l2, wd_mask=l2_mask,
               kernels=kernels, **wrap)


def _sgdw(params, learning_rate, momentum=0.9, weight_decay=0.0, nesterov=False, mask=None, *,
          wrap):
    return SGDW(params, lr=learning_rate, momentum=momentum, nesterov=nesterov,
                weight_decay=weight_decay, wd_mask=mask, **wrap)


def _adadelta(params, learning_rate, rho=0.9, eps=1e-6, weight_decay=0.0, mask=None, *, wrap):
    return Adadelta(params, lr=learning_rate, rho=rho, eps=eps, weight_decay=weight_decay,
                    wd_mask=mask, **wrap)


def _adagrad(params, learning_rate, initial_accumulator_value=0.1, eps=1e-7, *, l2, l2_mask,
             wrap):
    return Adagrad(params, lr=learning_rate, initial_accumulator_value=initial_accumulator_value,
                   eps=eps, weight_decay=l2, wd_mask=l2_mask, **wrap)


_INTERNAL = ('params', 'learning_rate', 'cls', 'l2', 'l2_mask', 'wrap', 'kernels')
_OPTIMIZERS = {
    'sgd': _Info(_sgd, has_eps=False, has_momentum=True, defaults={'nesterov': True}),
    'momentum': _Info(_sgd, has_eps=False, has_momentum=True, defaults={'nesterov': False}),
    'sgdw': _Info(_sgdw, has_eps=False, has_momentum=True),
    'sgdp': _Info(_sgdw, has_eps=False, has_momentum=True),
    'adam': _Info(_adam, has_betas=True),
    'adamw': _Info(_adamw, has_betas=True),
    'adamp': _Info(partial(_adamw, cls=AdamP), has_betas=True),
    'nadam': _Info(partial(_adam, nesterov=True), has_betas=True),
    'nadamw': _Info(partial(_adamw, cls=NAdamW), has_betas=True),
    'radam': _Info(_radam, has_betas=True),
    'adamax': _Info(_adamax, has_betas=True),
    'adabelief': _Info(_adabelief, has_betas=True),
    'adadelta': _Info(_adadelta),
    'adagrad': _Info(_adagrad),
    'adafactor': _Info(_adafactor, has_eps=False),
    'adafactorbv': _Info(_adafactor, has_eps=False, defaults={'min_dim_size_to_factor': 32}),
    'adopt': _Info(_adopt, has_betas=True),
    'adan': _Info(_adan, has_betas=True, num_betas=3),
    'lamb': _Info(_lamb, has_betas=True),
    'lars': _Info(_lars, has_eps=False, has_momentum=True),
    'lion': _Info(_lion, has_eps=False, has_betas=True),
    'lookahead': _Info(partial(_sgd, momentum=None), has_eps=False),
    'muon': _Info(_muon, has_momentum=True),
    'adamuon': _Info(_muon, has_momentum=True),
    'nadamuon': _Info(_muon, has_momentum=True),
    'novograd': _Info(_novograd, has_betas=True),
    'nvnovograd': _Info(_novograd, has_betas=True),
    'rmsprop': _Info(_rmsprop, has_momentum=True),
    'rmsproptf': _Info(_rmsprop_tf, has_momentum=True),
    'yogi': _Info(_yogi, has_betas=True),
    'sm3': _Info(_sm3, has_eps=False),
    'madgrad': _Info(_madgrad, has_momentum=True),
    'madgradw': _Info(partial(_madgrad, decoupled_decay=True), has_momentum=True),
    'laprop': _Info(_laprop, has_betas=True),
    'mars': _Info(_mars, has_betas=True),
}


def _kernel_names(model: nn.Module):
    """The weights that are conv or linear kernels in the JAX package (its
    ``.kernel`` leaves): Adafactor and SM3 build their state on the JAX
    layout of these."""
    kinds = (nn.Linear, nn.Conv1d, nn.Conv2d, Conv2d)
    return {f'{name}.weight' if name else 'weight' for name, m in model.named_modules()
            if isinstance(m, kinds) and getattr(m, 'weight', None) is not None
            and m.weight.ndim >= 2}


def list_optimizers():
    """The optimizer names the port runs: every name of the JAX registry."""
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
        if info.num_betas == 3 and len(betas) > 2:
            opt_args['b3'] = betas[2]
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
    params = inspect.signature(info.build).parameters
    if 'l2' in params:  # coupled L2, as the JAX factory rebinds it
        extra = dict(l2=weight_decay, l2_mask=wd_mask)
    if 'kernels' in params:
        extra['kernels'] = _kernel_names(model)
    wrap = dict(lookahead=use_lookahead, caution=caution, lr_scales=lr_scales)
    return info.build(model.named_parameters(), 1e-3 if lr is None else lr, **opt_args,
                      **extra, wrap=wrap)
