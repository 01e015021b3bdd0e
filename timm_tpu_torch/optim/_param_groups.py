"""Weight-decay parameter groups (counterpart of
timm_tpu/optim/_param_groups.py ``param_groups_weight_decay``).

The JAX package expresses the groups as a boolean mask over the parameter
tree; the port keeps a mask by parameter name. A parameter gets no decay when
it has at most one dimension, ends in ``.bias``, or matches a name from
``model.no_weight_decay()`` or ``no_weight_decay_list``. The port's names
differ from the JAX names only where the port says ``weight`` for JAX's
``kernel`` and ``scale``, which none of the rules reads, so one model gives
the same mask in both packages.
"""
from __future__ import annotations

import fnmatch
from typing import Dict, Iterable, Set, Tuple

from torch import nn

__all__ = ['param_groups_weight_decay']


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
