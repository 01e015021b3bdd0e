"""Feature-index resolution for ``forward_intermediates`` (counterpart of
timm_tpu/models/_features.py ``feature_take_indices``). The port's models
emit NHWC features, as the JAX package's do; ``FeatureGetterNet`` and
``features_only`` are not ported yet (ROADMAP A.5.7)."""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

__all__ = ['feature_take_indices']


def feature_take_indices(
        num_features: int,
        indices: Optional[Union[int, List[int], Tuple[int, ...]]] = None,
        as_set: bool = False,
):
    """(absolute indices, the largest): an int n takes the last n, a
    sequence may hold negative indices; out of range raises."""
    if indices is None:
        indices = num_features
    if isinstance(indices, int):
        take_indices = [num_features - indices + i for i in range(indices)]
    else:
        take_indices = [num_features + i if i < 0 else i for i in indices]
    for i in take_indices:
        if not 0 <= i < num_features:
            raise ValueError(f'feature index {i} out of range [0, {num_features})')
    return (set(take_indices) if as_set else take_indices), max(take_indices)
