"""Compute-precision policy (counterpart of timm_tpu/layers/config.py,
``softmax_dtype`` / ``norm_internal_dtype`` and their setters).

Two knobs, both off by default, and bit for bit the fp32 path when off:

* ``softmax_dtype``: the dtype of the attention softmax's internals. None
  (the default) is the fp32 upcast; ``bfloat16`` subtracts the row max in
  fp32, then takes exp and the normalisation in bf16, as the JAX policy does.
  ``softmax_with_policy`` is the one place that reads it.
* ``norm_internal_dtype``: the dtype of LayerNorm / RmsNorm / SimpleNorm
  statistics (``layers/norm.py``). None keeps the fp32 statistics; ``bfloat16``
  takes mean and variance in bf16 and returns x's dtype, as JAX's fast path.

Each is seeded from ``TIMM_TPU_SOFTMAX_DTYPE`` / ``TIMM_TPU_NORM_DTYPE`` at
import, as in the JAX package, and set by a plain call
(``set_softmax_dtype('bfloat16')``, which stays set) or as a context
manager (``with set_softmax_dtype('bfloat16'): ...``, which restores the
previous value on exit).

On the card the flash-attention kernel keeps its fp32 online softmax
whatever ``softmax_dtype`` says: the knob reaches only the plain attention
(``layers/attention.py`` ``_sdpa``, on the CPU, and the paths the kernel
does not take). The TPU kernel ignores the knob too
(``timm_tpu/layers/attention.py`` sends a fused call to the Pallas kernel
before the policy is read), so this matches JAX.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ['norm_internal_dtype', 'resolve_dtype_arg', 'set_norm_internal_dtype',
           'set_softmax_dtype', 'softmax_dtype', 'softmax_with_policy']

_ALIASES = {'bf16': 'bfloat16', 'fp32': 'float32', 'f32': 'float32', 'fp16': 'float16'}


def resolve_dtype_arg(value, allow_none: bool = True) -> Optional[torch.dtype]:
    """'bfloat16' / 'float32' / '' / a torch dtype / None -> a torch dtype
    or None."""
    if value is None or value == '':
        if allow_none:
            return None
        raise ValueError('a dtype is required')
    if isinstance(value, torch.dtype):
        return value
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ('', 'none', 'default'):
            return None
        dt = getattr(torch, _ALIASES.get(v, v), None)
        if isinstance(dt, torch.dtype):
            return dt
    raise ValueError(f'not a dtype: {value!r}')


_POLICY = {
    'softmax': resolve_dtype_arg(os.environ.get('TIMM_TPU_SOFTMAX_DTYPE', '')),
    'norm': resolve_dtype_arg(os.environ.get('TIMM_TPU_NORM_DTYPE', '')),
}


def softmax_dtype() -> Optional[torch.dtype]:
    """The process's softmax internal dtype; None is the fp32 upcast."""
    return _POLICY['softmax']


def norm_internal_dtype() -> Optional[torch.dtype]:
    """The process's norm-statistics dtype; None is fp32 statistics."""
    return _POLICY['norm']


class _PolicySetting:
    """Sets one policy knob at once; as a context manager, restores the
    previous value on exit."""

    def __init__(self, name: str, dtype):
        self._name = name
        self._prev = _POLICY[name]
        _POLICY[name] = resolve_dtype_arg(dtype)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _POLICY[self._name] = self._prev
        return False


def set_softmax_dtype(dtype) -> _PolicySetting:
    """Set the softmax policy dtype (a plain call or a context manager)."""
    return _PolicySetting('softmax', dtype)


def set_norm_internal_dtype(dtype) -> _PolicySetting:
    """Set the norm-statistics policy dtype (a plain call or a context
    manager)."""
    return _PolicySetting('norm', dtype)


def softmax_with_policy(x: torch.Tensor, dim: int = -1, dtype=None) -> torch.Tensor:
    """The canonical softmax for attention layers. ``dtype=None`` defers to
    the process policy, whose default is the fp32 upcast. The result is in
    the compute dtype (fp32 by default); callers cast back to their
    activation dtype."""
    dt = resolve_dtype_arg(dtype) if dtype is not None else _POLICY['softmax']
    if dt is None or dt == torch.float32:
        return torch.softmax(x.float(), dim=dim)
    # the row max is subtracted in fp32 (range safety), then exp and the
    # normalisation run in the reduced dtype
    xf = x.float()
    m = xf.amax(dim=dim, keepdim=True).detach()
    e = torch.exp((xf - m).to(dt))
    return e / e.sum(dim=dim, keepdim=True)
