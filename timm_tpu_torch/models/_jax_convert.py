"""Carry weights and training checkpoints from the JAX package into the port.

Weights: the flat ``{dotted.path: np.ndarray}`` dict that
``timm_tpu.models._helpers.model_state_dict`` produces (or its saved .npz /
.safetensors form). The rules invert timm_tpu/models/_torch_convert.py:

  .kernel (I, O)          -> .weight (O, I)        [transpose]
  .kernel (H, W, I, O)    -> .weight (O, I, H, W)  [conv HWIO -> OIHW]
  .scale                  -> .weight               [norm affine]

Every other name carries over as it is, because the port's module tree
mirrors the JAX package's.

Task checkpoints (``convert_jax_checkpoint``): the single flat dict of
``timm_tpu.task.TrainingTask.get_checkpoint_state`` becomes the port's
(``task/task.py``). ``state_dict.*``, ``state_dict_ema.*`` and
``model_state.*`` take the weight rules; the optax state maps as

  optimizer.count                           -> optimizer.count
  optimizer.hyperparams.learning_rate       -> optimizer.learning_rate
  optimizer.inner_state.<i>.count           -> optimizer.count (must agree)
  optimizer.inner_state.<i...>.mu.<path>    -> optimizer.mu.<port path>
  optimizer.inner_state.<i...>.nu.<path>    -> optimizer.nu.<port path>
  optimizer.inner_state.<i...>.trace.<path> -> optimizer.trace.<port path>

with the moments transposed as their parameters are. ``epoch``, ``metric``
and ``_resume.*`` carry over. Any other key raises and names itself: no key
is skipped.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ['convert_jax_checkpoint', 'convert_jax_state_dict', 'is_jax_checkpoint',
           'load_jax_state_dict']

_SLOT_RE = re.compile(r'^optimizer\.inner_state\.(?:\d+\.)*(mu|nu|trace)\.(.+)$')
_INNER_COUNT_RE = re.compile(r'^optimizer\.inner_state\.(?:\d+\.)*count$')
_WEIGHT_PREFIXES = ('state_dict.', 'state_dict_ema.', 'model_state.')


def _as_numpy(a) -> np.ndarray:
    """A numpy array with a dtype torch knows: bf16 (ml_dtypes' or an npz's
    raw 2-byte void) becomes fp32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        return a.astype(np.float32)
    if a.dtype.kind == 'V' and a.dtype.itemsize == 2:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


def _convert_leaf(key: str, value) -> Tuple[str, np.ndarray]:
    value = _as_numpy(value)
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
    return key, np.ascontiguousarray(value)


def is_jax_checkpoint(flat: Mapping[str, np.ndarray]) -> bool:
    """A JAX package file: ``.kernel`` / ``.scale`` leaves or optax's
    ``optimizer.inner_state`` keys."""
    return any(k.rpartition('.')[2] in ('kernel', 'scale') or k.startswith('optimizer.inner_state.')
               for k in flat)


def convert_jax_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX weights -> {port name: tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        key, value = _convert_leaf(key, value)
        if key in out:
            raise ValueError(f'two JAX entries map to the port name {key}')
        out[key] = torch.from_numpy(np.array(value))  # a writable, contiguous copy
    return out


def convert_jax_checkpoint(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A JAX task checkpoint -> the port's checkpoint dict (numpy)."""
    out: Dict[str, np.ndarray] = {}
    inner_counts = []

    def put(key, value):
        if key in out:
            raise ValueError(f'two JAX entries map to the port key {key}')
        out[key] = value

    for key, value in flat.items():
        if key in ('epoch', 'metric') or key.startswith('_resume.'):
            put(key, np.asarray(value))
        elif key.startswith(_WEIGHT_PREFIXES):
            prefix, _, path = key.partition('.')
            path, value = _convert_leaf(path, value)
            put(f'{prefix}.{path}', value)
        elif key == 'optimizer.count':
            put('optimizer.count', np.asarray(value, np.int32))
        elif key == 'optimizer.hyperparams.learning_rate':
            put('optimizer.learning_rate', np.asarray(value, np.float32))
        elif _INNER_COUNT_RE.match(key):
            inner_counts.append((key, int(np.asarray(value))))
        elif _SLOT_RE.match(key):
            slot, path = _SLOT_RE.match(key).groups()
            path, value = _convert_leaf(path, value)
            put(f'optimizer.{slot}.{path}', value)
        else:
            raise ValueError(f'{key}: no rule maps this JAX checkpoint entry into the port')
    for key, count in inner_counts:
        if 'optimizer.count' not in out:
            out['optimizer.count'] = np.asarray(count, np.int32)
        elif int(out['optimizer.count']) != count:
            raise ValueError(f'{key} = {count} disagrees with optimizer.count = '
                             f'{int(out["optimizer.count"])}')
    return out


def load_jax_state_dict(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Convert ``flat`` and load it into ``model`` strictly: a missing or an
    unexpected key, or a shape mismatch, raises. Values are copied into the
    model's parameters on their device and dtype."""
    model.load_state_dict(convert_jax_state_dict(flat), strict=True)
    return model
