"""Weight files (counterpart of timm_tpu/models/_helpers.py).

A state dict here is a flat ``{name: np.ndarray}`` in the port's names and
torch layout. ``load_state_dict`` reads the port's own .npz (a bare state
dict or a training checkpoint), the JAX package's (its names and layouts
are converted by ``_jax_convert``), .safetensors of either, and torch's
.pth / .pt / .bin (port names, loaded with ``weights_only=True``). A
training checkpoint is unwrapped to its ``state_dict_ema.*`` entries with
``use_ema`` (when it has them) or its ``state_dict.*`` entries, plus its
``model_state.*`` buffers. An .npz passes the integrity gate
(``resilience.verify_checkpoint``) before it is read. ``safetensors`` is
imported only for a .safetensors path.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..utils.serialization import to_numpy
from ._jax_convert import _as_numpy, convert_jax_state_dict, is_jax_checkpoint

_logger = logging.getLogger(__name__)

__all__ = ['clean_state_dict', 'load_state_dict', 'save_state_dict', 'load_checkpoint']


def clean_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip wrapper prefixes (``module.``, ``_orig_mod.``)."""
    cleaned = {}
    for k, v in state_dict.items():
        for prefix in ('module.', '_orig_mod.'):
            if k.startswith(prefix):
                k = k[len(prefix):]
        cleaned[k] = v
    return cleaned


def _safetensors_numpy():
    try:
        import safetensors.numpy as st
    except ImportError as e:
        raise RuntimeError('reading or writing a .safetensors file needs the safetensors '
                           'package, which is not installed; use an .npz path') from e
    return st


def save_state_dict(state_dict: Mapping[str, Any], path: str):
    """Write ``state_dict`` to ``path``: .safetensors, or else a durable
    .npz with its hash manifest (resilience/durable.py)."""
    path = str(path)
    arrays = {k: np.ascontiguousarray(_as_numpy(to_numpy(v))) for k, v in state_dict.items()}
    if path.endswith('.safetensors'):
        _safetensors_numpy().save_file(arrays, path)
    else:
        from ..resilience import atomic_write_npz
        atomic_write_npz(path, arrays)


def _read(checkpoint_path: str) -> Dict[str, np.ndarray]:
    if checkpoint_path.endswith('.safetensors'):
        return dict(_safetensors_numpy().load_file(checkpoint_path))
    if checkpoint_path.endswith(('.npz', '.npy')):
        from ..resilience import CorruptCheckpointError, verify_checkpoint
        ok, reason = verify_checkpoint(checkpoint_path)
        if not ok:
            raise CorruptCheckpointError(f'{checkpoint_path}: {reason}')
        with np.load(checkpoint_path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files}
    if checkpoint_path.endswith(('.pth', '.pt', '.bin')):
        obj = torch.load(checkpoint_path, map_location='cpu', weights_only=True)
        if not isinstance(obj, Mapping):
            raise ValueError(f'{checkpoint_path}: expected a dict of tensors')
        flat = {}
        for k, v in obj.items():
            if isinstance(v, Mapping):  # {'state_dict': {...}, 'state_dict_ema': {...}}
                flat.update({f'{k}.{kk}': to_numpy(vv) for kk, vv in v.items()
                             if isinstance(vv, torch.Tensor)})
            elif isinstance(v, torch.Tensor):
                flat[k] = to_numpy(v)
        return flat
    raise ValueError(f'Unsupported checkpoint format: {checkpoint_path}')


def load_state_dict(checkpoint_path: str, use_ema: bool = True) -> Dict[str, np.ndarray]:
    checkpoint_path = str(checkpoint_path)
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(f'No checkpoint found at {checkpoint_path}')
    sd = _read(checkpoint_path)
    stats = {k[len('model_state.'):]: v for k, v in sd.items() if k.startswith('model_state.')}
    ema_keys = [k for k in sd if k.startswith('state_dict_ema.')]
    if use_ema and ema_keys:
        sd = {k[len('state_dict_ema.'):]: sd[k] for k in ema_keys}
        sd.update(stats)
    elif any(k.startswith('state_dict.') for k in sd):
        sd = {k[len('state_dict.'):]: v for k, v in sd.items() if k.startswith('state_dict.')}
        sd.update(stats)
    sd = clean_state_dict(sd)
    if is_jax_checkpoint(sd):
        return {k: v.numpy() for k, v in convert_jax_state_dict(sd).items()}
    return {k: _as_numpy(v) for k, v in sd.items()}


def load_checkpoint(
        model: nn.Module,
        checkpoint_path: str,
        use_ema: bool = True,
        strict: bool = True,
):
    """Load the weights of ``checkpoint_path`` into ``model`` (copied onto
    its parameters' device and dtype); ``strict`` as in
    ``nn.Module.load_state_dict``. A ``--split-bn`` run's aux layers
    (``.aux_bn.``) are left out when ``model`` has none: they hold training
    state of the other splits, which a plain model has no place for."""
    state_dict = load_state_dict(checkpoint_path, use_ema=use_ema)
    if not any('.aux_bn.' in k for k in model.state_dict()):
        state_dict = {k: v for k, v in state_dict.items() if '.aux_bn.' not in k}
    result = model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()}, strict=strict)
    if result.missing_keys:
        _logger.warning(f'Missing keys: {result.missing_keys[:8]}')
    if result.unexpected_keys:
        _logger.warning(f'Unexpected keys: {result.unexpected_keys[:8]}')
    return model
