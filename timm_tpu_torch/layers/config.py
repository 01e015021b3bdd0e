"""Compute-precision policy (counterpart of timm_tpu/layers/config.py).

Only the default policy is ported: the softmax of attention runs in fp32.
The JAX package's bf16 softmax and norm knobs are not carried over yet.
"""
from __future__ import annotations

import torch

__all__ = ['softmax_with_policy']


def softmax_with_policy(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The canonical softmax for attention layers: upcast to fp32. The result
    is fp32; callers cast back to their activation dtype."""
    return torch.softmax(x.float(), dim=dim)
