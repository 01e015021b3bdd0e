"""Parameter grouping by a model's ``group_matcher`` (counterpart of
timm_tpu/models/_manipulate.py ``group_with_matcher`` / ``named_parameters``).

Names are the port's parameter names; a ``group_matcher`` spec is the same
regex structure as the JAX package's, and its patterns only read the parts
of a name the two packages share (``blocks.3``, ``stages.1.blocks.0``,
``norm``), so one model groups the same in both.
"""
from __future__ import annotations

import collections.abc
import re
from collections import defaultdict
from typing import Callable, Dict, Iterable, Tuple, Union

from torch import nn

__all__ = ['MATCH_PREV_GROUP', 'group_with_matcher', 'named_parameters']

MATCH_PREV_GROUP = (99999,)


def named_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """{name: parameter} of the trainable parameters."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def group_with_matcher(
        named_objects: Iterable[Tuple[str, object]],
        group_matcher: Union[Dict, Callable],
        return_values: bool = False,
        reverse: bool = False,
):
    """Group names into ordered layer ids by ``group_matcher``: {layer id:
    [names or objects]}, or with ``reverse`` {name: layer id}. A name no
    pattern matches goes to the last group; a match whose key ends in
    MATCH_PREV_GROUP joins the group before it."""
    if isinstance(group_matcher, dict):
        compiled = []
        for group_ordinal, (group_name, mspec) in enumerate(group_matcher.items()):
            if mspec is None:
                continue
            if isinstance(mspec, (tuple, list)):
                for sspec in mspec:
                    compiled += [(group_ordinal, group_name, re.compile(sspec[0]), sspec[1])]
            else:
                compiled += [(group_ordinal, group_name, re.compile(mspec), None)]
        group_matcher = compiled

    def _get_grouping(name):
        if isinstance(group_matcher, (list, tuple)):
            for grp_ordinal, _, pattern, suffix in group_matcher:
                r = pattern.match(name)
                if r:
                    parts = (grp_ordinal,) + r.groups()
                    if suffix is not None:
                        parts = parts + (tuple(suffix) if isinstance(suffix, (tuple, list)) else (suffix,))
                    flat = []
                    for p in parts:
                        if p is None:
                            continue
                        if isinstance(p, (tuple, list)):
                            flat.extend(float(q) for q in p if q is not None)
                        else:
                            flat.append(float(p))
                    return tuple(flat)
            return (float('inf'),)
        ord_ = group_matcher(name)
        if not isinstance(ord_, collections.abc.Iterable):
            return (ord_,)
        return tuple(ord_)

    grouping = defaultdict(list)
    for name, obj in named_objects:
        grouping[_get_grouping(name)].append(obj if return_values else name)

    # remap to integers, ordered
    layer_id_to_param = defaultdict(list)
    lid = -1
    for k in sorted(filter(lambda x: x is not None, grouping.keys())):
        if lid < 0 or k[-1] != MATCH_PREV_GROUP[0]:
            lid += 1
        layer_id_to_param[lid].extend(grouping[k])

    if reverse:
        if return_values:
            raise ValueError('reverse mapping only supported for name output')
        return {n: lid_ for lid_, names in layer_id_to_param.items() for n in names}
    return layer_id_to_param
