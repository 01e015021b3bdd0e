"""Linear layer with a compute dtype (counterpart of flax's ``nnx.Linear`` as
the JAX package uses it)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .weight_init import trunc_normal_

__all__ = ['Linear', 'compute_dtype']


def compute_dtype(x: torch.Tensor, dtype: Optional[torch.dtype], param: torch.Tensor) -> torch.dtype:
    """flax's dtype rule: the module's ``dtype`` when set, else the promotion
    of the input's and the parameter's dtypes (bf16 input, fp32 weight -> fp32)."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` whose input, weight and bias are cast to the compute dtype
    before the product. Parameters stay fp32; weights are drawn from
    ``generator`` (truncated normal, std 0.02), biases are zero."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        trunc_normal_(self.weight, std=0.02, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = compute_dtype(x, self.compute_dtype, self.weight)
        bias = None if self.bias is None else self.bias.to(ct)
        return F.linear(x.to(ct), self.weight.to(ct), bias)
