"""Weight-decay and layer-decay parameter groups (counterpart of
timm_tpu/optim/_param_groups.py).

The JAX package expresses the groups as a boolean mask over the parameter
tree; the port keeps a mask by parameter name. A parameter gets no decay when
it has at most one dimension, ends in ``.bias``, or matches a name from
``model.no_weight_decay()`` or ``no_weight_decay_list``. The port's names
differ from the JAX names only where the port says ``weight`` for JAX's
``kernel`` and ``scale``, which none of the rules reads, so one model gives
the same mask in both packages. Layer decay gives each name its layer's lr
scale from the model's ``group_matcher``, as a dict by name where JAX has
a pytree.
"""
from __future__ import annotations

import fnmatch
from typing import Dict, Iterable, Set, Tuple

from torch import nn

from ..models._manipulate import group_with_matcher, named_parameters

__all__ = ['auto_group_layers', 'param_groups_layer_decay', 'param_groups_weight_decay']


def _matches_no_decay(name: str, no_decay_names: Iterable[str]) -> bool:
    return any(name == pat or name.startswith(pat + '.') or fnmatch.fnmatch(name, pat)
               or name.endswith(pat) for pat in no_decay_names)


def param_groups_weight_decay(
        model: nn.Module,
        weight_decay: float = 1e-5,
        no_weight_decay_list: Tuple[str, ...] = (),
) -> Dict[str, bool]:
    """{parameter name: apply weight decay} in ``named_parameters`` order."""
    no_decay: Set[str] = set(no_weight_decay_list)
    if hasattr(model, 'no_weight_decay'):
        no_decay |= set(model.no_weight_decay())
    return {name: not (p.ndim <= 1 or name.endswith('.bias') or _matches_no_decay(name, no_decay))
            for name, p in model.named_parameters()}


def auto_group_layers(model: nn.Module, group_matcher=None, reverse: bool = True):
    """{parameter name: layer id} from the model's ``group_matcher``."""
    if group_matcher is None:
        group_matcher = model.group_matcher(coarse=False)
    return group_with_matcher(named_parameters(model).items(), group_matcher,
                              return_values=False, reverse=reverse)


def param_groups_layer_decay(
        model: nn.Module,
        weight_decay: float = 0.05,
        no_weight_decay_list: Tuple[str, ...] = (),
        layer_decay: float = 0.75,
        min_scale: float = 0.0,
) -> Tuple[Dict[str, float], Dict[str, bool]]:
    """({parameter name: lr scale}, weight-decay mask): layer i of n scales
    by max(layer_decay ** (n - 1 - i), min_scale); a name the matcher does
    not place takes the last layer's 1.0."""
    wd_mask = param_groups_weight_decay(model, weight_decay, no_weight_decay_list)
    param_to_layer = auto_group_layers(model, reverse=True)
    num_layers = max(param_to_layer.values()) + 1 if param_to_layer else 1
    layer_max = num_layers - 1
    layer_scales = [max(layer_decay ** (layer_max - i), min_scale) for i in range(num_layers)]
    scales = {name: layer_scales[param_to_layer.get(name, layer_max)]
              for name, _ in model.named_parameters()}
    return scales, wd_mask
