"""Carry weights from the JAX package into the port.

Input is the flat ``{dotted.path: np.ndarray}`` dict that
``timm_tpu.models._helpers.model_state_dict`` produces (or its saved .npz /
.safetensors form). The rules invert timm_tpu/models/_torch_convert.py:

  .kernel (I, O)          -> .weight (O, I)        [transpose]
  .kernel (H, W, I, O)    -> .weight (O, I, H, W)  [conv HWIO -> OIHW]
  .scale                  -> .weight               [norm affine]

Every other name carries over as it is, because the port's module tree
mirrors the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ['convert_jax_state_dict', 'load_jax_state_dict']


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == 'V' or a.dtype.name == 'bfloat16':  # ml_dtypes bf16 has no torch view
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def convert_jax_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        value = np.asarray(value)
        base, dot, leaf = key.rpartition('.')
        if leaf == 'kernel':
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f'{key}: no conversion rule for a {value.ndim}-d kernel')
            key = base + dot + 'weight'
        elif leaf == 'scale':
            key = base + dot + 'weight'
        if key in out:
            raise ValueError(f'two JAX entries map to the port name {key}')
        out[key] = _to_tensor(value)
    return out


def load_jax_state_dict(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Convert ``flat`` and load it into ``model`` strictly: a missing or an
    unexpected key, or a shape mismatch, raises. Values are copied into the
    model's parameters on their device and dtype."""
    model.load_state_dict(convert_jax_state_dict(flat), strict=True)
    return model
