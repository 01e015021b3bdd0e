"""Small shape and argument helpers (copy of timm_tpu/layers/helpers.py)."""
from __future__ import annotations

import collections.abc
from itertools import repeat

__all__ = ['extend_tuple', 'make_divisible', 'to_1tuple', 'to_2tuple', 'to_3tuple', 'to_4tuple',
           'to_ntuple']


def _ntuple(n):
    def parse(x):
        if isinstance(x, collections.abc.Iterable) and not isinstance(x, str):
            return tuple(x)
        return tuple(repeat(x, n))
    return parse


to_1tuple = _ntuple(1)
to_2tuple = _ntuple(2)
to_3tuple = _ntuple(3)
to_4tuple = _ntuple(4)
to_ntuple = _ntuple


def make_divisible(v, divisor: int = 8, min_value=None, round_limit: float = 0.9):
    """``v`` rounded to a multiple of ``divisor``, never more than 10% down."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


def extend_tuple(x, n):
    """A tuple of length ``n``: ``x`` (a scalar or a sequence) padded by
    repeating its last element, or cut."""
    x = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    pad_n = n - len(x)
    if pad_n <= 0:
        return x[:n]
    return x + (x[-1],) * pad_n
