"""Split ('auxiliary') BatchNorm for training on augmentation splits
(counterpart of timm_tpu/layers/split_batchnorm.py, AdvProp §4.2).

In training the batch is split into ``num_splits`` equal parts along its
first axis, split-major as the AugMix collation builds it (clean images
first): the first split goes through the layer's own statistics and
parameters, each other split through its own ``aux_bn.<i>``. Every split's
running statistics are updated in place, so a captured train step records
all of them. In eval only the primary statistics are used.

``convert_splitbn_model`` replaces every ``BatchNorm2d`` (and
``BatchNormAct2d``) of a model as JAX's ``_convert_one`` does, traps
included:

- the new layer is built with ``dtype=None`` whatever the old one had, so
  under a bf16 model the split layers compute in fp32 and return fp32 (the
  next conv casts back to bf16): JAX's behaviour, kept on purpose;
- its torch-style momentum is ``1 - (1 - momentum)`` of the old one, as JAX
  turns flax's decay back into a momentum;
- the old layer's ``act`` and ``drop`` are carried over, its parameters and
  statistics are copied into the primary and every aux layer, and it keeps
  the old layer's train / eval mode and device.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .norm import BatchNorm2d
from .norm_act import BatchNormAct2d

__all__ = ['SplitBatchNorm2d', 'SplitBatchNormAct2d', 'convert_splitbn_model']


class SplitBatchNormAct2d(BatchNormAct2d):
    """``BatchNormAct2d`` whose training statistics are taken per split."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, apply_act: bool = True, act_layer='relu',
                 num_splits: int = 2, drop_layer=None, dtype: Optional[torch.dtype] = None):
        if num_splits < 2:
            raise ValueError('split BatchNorm needs at least one aux layer (num_splits >= 2)')
        super().__init__(num_features, eps=eps, momentum=momentum, affine=affine,
                         apply_act=apply_act, act_layer=act_layer, drop_layer=drop_layer,
                         dtype=dtype)
        self.num_splits = num_splits
        self.aux_bn = nn.ModuleList([
            BatchNorm2d(num_features, eps=eps, momentum=momentum, affine=affine, dtype=dtype)
            for _ in range(num_splits - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            split = x.shape[0] // self.num_splits
            if split * self.num_splits != x.shape[0]:
                raise ValueError(f'batch {x.shape[0]} does not split into {self.num_splits} '
                                 'equal parts')
            outs = [BatchNorm2d.forward(self, x[:split])]
            outs += [aux(x[(i + 1) * split:(i + 2) * split]) for i, aux in enumerate(self.aux_bn)]
            x = torch.cat(outs, dim=0)
        else:
            x = BatchNorm2d.forward(self, x)
        return self._act(x)


class SplitBatchNorm2d(SplitBatchNormAct2d):
    """Split BatchNorm with no activation."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, num_splits: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=eps, momentum=momentum, affine=affine,
                         apply_act=False, num_splits=num_splits, dtype=dtype)


@torch.no_grad()
def _convert_one(bn: BatchNorm2d, num_splits: int) -> SplitBatchNormAct2d:
    new = SplitBatchNormAct2d(bn.running_mean.numel(), eps=bn.eps,
                              momentum=1.0 - (1.0 - bn.momentum), num_splits=num_splits)
    new.act = getattr(bn, 'act', None)
    new.drop = getattr(bn, 'drop', None)
    new.to(bn.running_mean.device)
    for tgt in [new, *new.aux_bn]:
        if bn.weight is not None:
            tgt.weight.copy_(bn.weight)
            tgt.bias.copy_(bn.bias)
        tgt.running_mean.copy_(bn.running_mean)
        tgt.running_var.copy_(bn.running_var)
    return new.train(bn.training)


def convert_splitbn_model(module: nn.Module, num_splits: int = 2) -> nn.Module:
    """Replace every BatchNorm2d under ``module`` by a ``SplitBatchNormAct2d``
    of ``num_splits`` splits, in place (see the module docstring); returns
    ``module``. Build the optimizer after converting."""
    for name, child in list(module.named_children()):
        if isinstance(child, SplitBatchNormAct2d):
            continue
        if isinstance(child, BatchNorm2d):
            setattr(module, name, _convert_one(child, num_splits))
        else:
            convert_splitbn_model(child, num_splits)
    return module
