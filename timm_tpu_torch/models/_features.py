"""Multi-scale features (counterpart of timm_tpu/models/_features.py).

``feature_take_indices`` resolves ``forward_intermediates`` indices;
``FeatureInfo`` describes a model's feature points (channels, reduction,
module); ``FeatureGetterNet`` is what ``features_only=True`` builds: it
prunes the model past its last index (``prune_intermediate_layers``) and
returns ``forward_intermediates(..., intermediates_only=True)``, as the
JAX package's does. The port's models emit NHWC features, as the JAX
package's do.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

__all__ = ['FeatureGetterNet', 'FeatureInfo', 'feature_take_indices']


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


class FeatureInfo:
    """A model's feature points (dicts with ``num_chs``, ``reduction``,
    ``module``) and the indices taken out of them."""

    def __init__(self, feature_info: List[Dict], out_indices: Tuple[int, ...]):
        prev_reduction = 1
        for i, fi in enumerate(feature_info):
            if not fi.get('num_chs', 0) > 0:
                raise ValueError(f'feature {i}: num_chs must be > 0')
            if not fi.get('reduction', 0) >= prev_reduction:
                raise ValueError(f'feature {i}: reductions must not decrease')
            prev_reduction = fi['reduction']
            fi.setdefault('module', f'layer_{i}')
            fi.setdefault('index', i)
        self.out_indices = out_indices
        self.info = feature_info

    def from_other(self, out_indices: Tuple[int, ...]) -> 'FeatureInfo':
        return FeatureInfo(copy.deepcopy(self.info), out_indices)

    def get(self, key: str, idx: Optional[Union[int, tuple, list]] = None):
        if idx is None:
            return [self.info[i][key] for i in self.out_indices]
        if isinstance(idx, (tuple, list)):
            return [self.info[i][key] for i in idx]
        return self.info[idx][key]

    def get_dicts(self, keys=None, idx=None):
        idx = self.out_indices if idx is None else ([idx] if isinstance(idx, int) else idx)
        if keys is None:
            return [self.info[i] for i in idx]
        return [{k: self.info[i][k] for k in keys} for i in idx]

    def channels(self, idx=None):
        return self.get('num_chs', idx)

    def reduction(self, idx=None):
        return self.get('reduction', idx)

    def module_name(self, idx=None):
        return self.get('module', idx)

    def __getitem__(self, item):
        return self.info[item]

    def __len__(self) -> int:
        return len(self.info)


def _build_feature_info(model: nn.Module, out_indices) -> Optional[FeatureInfo]:
    raw = getattr(model, 'feature_info', None)
    if raw is None:
        return None
    if isinstance(raw, FeatureInfo):
        take, _ = feature_take_indices(len(raw), out_indices)
        return raw.from_other(tuple(take))
    info = copy.deepcopy(raw)
    take, _ = feature_take_indices(len(info), out_indices)
    return FeatureInfo(info, tuple(take))


class FeatureGetterNet(nn.Module):
    """The ``features_only`` wrapper: ``model.forward_intermediates`` at
    ``out_indices``, as a list (or a dict named by ``out_map`` with
    ``return_dict``). With ``prune`` the model loses what lies past its last
    index (and its final norm unless ``norm``). ``feature_cls`` is accepted
    for the JAX signature: every port model goes through
    ``forward_intermediates``."""

    def __init__(self, model: nn.Module, out_indices=4, out_map=None, return_dict: bool = False,
                 output_fmt: str = 'NHWC', norm: bool = False, prune: bool = True, **kwargs):
        super().__init__()
        if prune and hasattr(model, 'prune_intermediate_layers'):
            out_indices = model.prune_intermediate_layers(out_indices, prune_norm=not norm)
        self.feature_info = _build_feature_info(model, out_indices)
        self.model = model
        self.out_indices = out_indices
        self.out_map = out_map
        self.return_dict = return_dict
        self.output_fmt = output_fmt
        self.norm = norm

    def forward(self, x: torch.Tensor):
        features = self.model.forward_intermediates(
            x, indices=self.out_indices, norm=self.norm, output_fmt=self.output_fmt,
            intermediates_only=True)
        if self.return_dict:
            names = self.out_map or [f'layer_{i}' for i in range(len(features))]
            return dict(zip(names, features))
        return features
