"""Classifier heads over NHWC features (counterpart of
timm_tpu/layers/classifier.py ``create_classifier``, ``ClassifierHead`` and
``NormMlpClassifierHead``).

The head's norm gets no dtype, as in JAX: on bf16 features it returns
fp32, and the ``fc`` (which has the model's dtype) casts back. Linear
weights are truncated normal with std 0.02, biases zero. ``reset`` builds
the new ``fc`` on the CPU; the model's ``reset_classifier`` moves it.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from .create_act import get_act_fn
from .drop import Dropout
from .linear import Linear
from .norm import LayerNorm
from .pool import SelectAdaptivePool2d

__all__ = ['ClassifierHead', 'NormMlpClassifierHead', 'create_classifier']


def create_classifier(num_features: int, num_classes: int, pool_type: str = 'avg',
                      dtype: Optional[torch.dtype] = None,
                      generator: Optional[torch.Generator] = None):
    """(global pool, fc or None)."""
    pool = SelectAdaptivePool2d(pool_type=pool_type, flatten=True)
    num_pooled = num_features * pool.feat_mult()
    fc = Linear(num_pooled, num_classes, dtype=dtype, generator=generator) \
        if num_classes > 0 else None
    return pool, fc


class ClassifierHead(nn.Module):
    """Pool -> drop -> fc."""

    def __init__(self, in_features: int, num_classes: int, pool_type: str = 'avg',
                 drop_rate: float = 0.0, input_fmt: str = 'NHWC',
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.num_classes = num_classes
        self._dtype = dtype
        self.global_pool, self.fc = create_classifier(in_features, num_classes, pool_type,
                                                      dtype=dtype, generator=generator)
        self.drop = Dropout(drop_rate)

    def reset(self, num_classes: int, pool_type: Optional[str] = None,
              generator: Optional[torch.Generator] = None):
        self.num_classes = num_classes
        pool_type = pool_type if pool_type is not None else self.global_pool.pool_type
        self.global_pool, self.fc = create_classifier(self.in_features, num_classes, pool_type,
                                                      dtype=self._dtype, generator=generator)

    def forward(self, x: torch.Tensor, pre_logits: bool = False) -> torch.Tensor:
        x = self.drop(self.global_pool(x))
        if pre_logits or self.fc is None:
            return x
        return self.fc(x)


class NormMlpClassifierHead(nn.Module):
    """Pool -> norm -> (pre-logits fc + act) -> drop -> fc."""

    def __init__(self, in_features: int, num_classes: int, hidden_size: Optional[int] = None,
                 pool_type: str = 'avg', drop_rate: float = 0.0,
                 norm_layer: Callable = LayerNorm, act_layer: Union[str, Callable] = 'tanh',
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.hidden_size = hidden_size
        self.num_classes = num_classes
        self.num_features = hidden_size or in_features
        self._dtype = dtype
        self.global_pool = SelectAdaptivePool2d(pool_type=pool_type, flatten=True)
        self.norm = norm_layer(in_features)
        if hidden_size:
            self.pre_logits_fc = Linear(in_features, hidden_size, dtype=dtype, generator=generator)
            self.pre_logits_act = get_act_fn(act_layer)
        else:
            self.pre_logits_fc = None
            self.pre_logits_act = None
        self.drop = Dropout(drop_rate)
        self.fc = Linear(self.num_features, num_classes, dtype=dtype, generator=generator) \
            if num_classes > 0 else None

    def reset(self, num_classes: int, pool_type: Optional[str] = None,
              generator: Optional[torch.Generator] = None):
        self.num_classes = num_classes
        if pool_type is not None:
            self.global_pool = SelectAdaptivePool2d(pool_type=pool_type, flatten=True)
        self.fc = Linear(self.num_features, num_classes, dtype=self._dtype,
                         generator=generator) if num_classes > 0 else None

    def forward(self, x: torch.Tensor, pre_logits: bool = False) -> torch.Tensor:
        if x.ndim == 4:
            x = self.global_pool(x)
        x = self.norm(x)
        if self.pre_logits_fc is not None:
            x = self.pre_logits_act(self.pre_logits_fc(x))
        x = self.drop(x)
        if pre_logits or self.fc is None:
            return x
        return self.fc(x)
