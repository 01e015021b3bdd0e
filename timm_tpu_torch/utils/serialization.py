"""The port's flat ``{name: np.ndarray}`` form of training state
(counterpart of timm_tpu/utils/serialization.py).

The JAX package flattens pytrees by key path. The port has no pytree: it
walks a module's parameters and persistent buffers by their names, and the
optimizer's flat buffers through their per-leaf views (``_FlatOptimizer.
state_arrays``). Names are the port's own, arrays are in the torch layout;
``models/_jax_convert.py`` maps the JAX package's names and layouts onto
them.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ['add_prefix', 'split_prefix', 'to_numpy', 'persistent_buffers', 'module_arrays',
           'load_module_arrays']


def add_prefix(arrays: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {f'{prefix}.{k}': v for k, v in arrays.items()}


def split_prefix(state: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """The entries under ``prefix.``, with the prefix taken off."""
    p = prefix + '.'
    return {k[len(p):]: v for k, v in state.items() if k.startswith(p)}


def to_numpy(v) -> np.ndarray:
    """A numpy copy of a tensor on any device, bf16 as fp32 (numpy has no
    bf16; fp32 holds it exactly); anything else through ``np.asarray``."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    t = v.detach()
    h = (t.float() if t.dtype == torch.bfloat16 else t).cpu()
    return h.numpy().copy() if h.data_ptr() == t.data_ptr() else h.numpy()


def persistent_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: tensor} of ``module``'s persistent buffers (those its
    ``state_dict`` holds: BatchNorm's running statistics), the tensors
    themselves."""
    sd_keys = set(module.state_dict().keys())
    return {n: b for n, b in module.named_buffers() if n in sd_keys}


def module_arrays(module: nn.Module) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(parameters, persistent buffers) of ``module`` as numpy copies."""
    params = {n: to_numpy(p) for n, p in module.named_parameters()}
    buffers = {n: to_numpy(b) for n, b in persistent_buffers(module).items()}
    return params, buffers


def load_module_arrays(tensors: Mapping[str, torch.Tensor], arrays: Mapping[str, np.ndarray],
                       what: str, strict: bool = True) -> List[str]:
    """Copy ``arrays`` into ``tensors`` ({name: tensor}) in place, cast to
    each tensor's dtype and device; returns the names it did not find. A
    shape mismatch raises; a missing name raises under ``strict``."""
    missing = []
    with torch.no_grad():
        for name, t in tensors.items():
            if name not in arrays:
                missing.append(name)
                continue
            value = np.asarray(arrays[name])
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f'{what}.{name}: checkpoint shape {tuple(value.shape)}, '
                                 f'model shape {tuple(t.shape)}')
            t.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(t.dtype))
    if strict and missing:
        raise KeyError(f'Missing checkpoint keys: {[f"{what}.{n}" for n in missing[:5]]}')
    return missing
