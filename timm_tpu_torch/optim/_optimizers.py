"""AdamW and SGD over flat parameter buffers.

The JAX package's optimizers are optax chains over the parameter tree. The
port keeps their arithmetic but lays the parameters out for the card: at
construction every parameter's storage moves into one flat fp32 buffer that
the parameter becomes a view of, and ``.grad`` becomes a view of a second
flat buffer, so backward accumulates straight into it. Leaves that take
weight decay come first, so the decay mask is one boundary ``n_decay``. The
optimizer state (AdamW's m and v, SGD's trace, the EMA) lives in flat
buffers of the same layout, and one AdamW step over every leaf is one launch
of the fused AdamW + EMA kernel (``kernels/fused_adamw.py``).

The learning rate and the EMA decay live on the device: ``lr_t`` and
``ema_decay_t``, one fp32 element each, which ``step`` reads and
``set_hyperparams(lr, ema_decay)`` writes (a fill on the device, no
host-to-device copy). So a CUDA graph that captured ``step`` takes each
replay's values, as the TPU kernel reads them from SMEM. The host ``lr``
is the last one written, what the checkpoint records as
``learning_rate``, as optax's ``inject_hyperparams`` keeps it.
``step(lr, grad_scale, ok, ema_decay)`` takes what the train step computes
on the device: the clip factor and the non-finite guard's flag; with
``ok`` false nothing changes. An ``lr`` or ``ema_decay`` given to ``step``
is written first (an eager convenience: inside a graph capture write them
before it). Moving the model after building the optimizer breaks the views
and makes ``step`` raise.

``state_arrays`` / ``load_state_arrays`` give the state as a flat
``{key: np.ndarray}`` in the parameters' own names and layout: ``count``,
``learning_rate`` and per leaf ``mu.<name>`` / ``nu.<name>`` (AdamW) or
``trace.<name>`` (SGD). A bf16 first moment is stored as fp32, which holds
it exactly. Loading copies into the flat buffers in place: parameters and
``.grad`` stay views of them.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels.fused_adamw import fused_adamw
from ..utils.serialization import to_numpy

__all__ = ['AdamW', 'SGD']

_ALIGN = 4  # elements: every leaf starts on a 16-byte boundary


class _FlatOptimizer:
    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]], lr: float,
                 weight_decay: float = 0.0, wd_mask: Optional[Mapping[str, bool]] = None):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        if not named:
            raise ValueError('the optimizer got no parameters that require grad')
        devices = {p.device for _, p in named}
        if len(devices) != 1:
            raise ValueError(f'parameters on more than one device: {sorted(map(str, devices))}')
        bad = [n for n, p in named if p.dtype != torch.float32]
        if bad:
            raise NotImplementedError(f'the port trains fp32 parameters; not {bad[:3]}')
        self.lr = lr
        self.weight_decay = weight_decay
        decay = {n: True if wd_mask is None else bool(wd_mask[n]) for n, _ in named}
        ordered = [x for x in named if decay[x[0]]] + [x for x in named if not decay[x[0]]]
        self._params: List[Tuple[str, nn.Parameter]] = ordered
        self._slots: Dict[str, Tuple[int, torch.Size]] = {}
        offset, self.n_decay = 0, 0
        for name, p in ordered:
            self._slots[name] = (offset, p.shape)
            offset += -(-p.numel() // _ALIGN) * _ALIGN
            if decay[name]:
                self.n_decay = offset
        self.device = devices.pop()
        self.flat_param = torch.zeros(offset, dtype=torch.float32, device=self.device)
        self.flat_grad = torch.zeros_like(self.flat_param)
        with torch.no_grad():
            for name, p in ordered:
                view = self._view(self.flat_param, name)
                view.copy_(p)
                p.data = view
                p.grad = self._view(self.flat_grad, name)
        self.ema: Optional[torch.Tensor] = None
        self.count = torch.zeros((), dtype=torch.int32, device=self.device)
        self.lr_t = torch.full((), float(lr), dtype=torch.float32, device=self.device)
        self.ema_decay_t = torch.zeros((), dtype=torch.float32, device=self.device)

    def _view(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        offset, shape = self._slots[name]
        return flat[offset:offset + shape.numel()].view(shape)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{parameter name: view} of a flat buffer of this layout."""
        return {name: self._view(flat, name) for name, _ in self._params}

    def decay_mask(self) -> Dict[str, bool]:
        return {name: self._slots[name][0] < self.n_decay for name, _ in self._params}

    def zero_grad(self) -> None:
        self.flat_grad.zero_()

    def sync_grads(self) -> List[torch.Tensor]:
        """Make every ``.grad`` a view of the flat gradient again, copying in
        a gradient that autograd stored elsewhere (after ``zero_grad(
        set_to_none=True)`` by the caller), and return ``[flat_grad]``. A
        parameter that no longer lives in the flat buffer raises."""
        pbase, gbase = self.flat_param.data_ptr(), self.flat_grad.data_ptr()
        for name, p in self._params:
            offset = self._slots[name][0] * 4  # bytes of fp32
            if p.data_ptr() != pbase + offset:
                raise RuntimeError(
                    f'parameter {name} was moved or replaced after the optimizer was built; '
                    'build the optimizer after moving the model')
            if p.grad is None or p.grad.data_ptr() != gbase + offset:
                gview = self._view(self.flat_grad, name)
                if p.grad is None:
                    gview.zero_()
                else:
                    gview.copy_(p.grad)
                p.grad = gview
        return [self.flat_grad]

    def init_ema(self) -> Dict[str, torch.Tensor]:
        """Start the EMA as a copy of the parameters; returns its views."""
        self.ema = self.flat_param.clone()
        return self.views(self.ema)

    def set_hyperparams(self, lr: Optional[float] = None,
                        ema_decay: Optional[float] = None) -> None:
        """Write the learning rate and the EMA decay the next ``step``
        reads into their device scalars, in place."""
        if lr is not None:
            self.lr = float(lr)
            self.lr_t.fill_(self.lr)
        if ema_decay is not None:
            self.ema_decay_t.fill_(float(ema_decay))

    def step(self, lr: Optional[float] = None, grad_scale: Optional[torch.Tensor] = None,
             ok: Optional[torch.Tensor] = None, ema_decay: Optional[float] = None) -> None:
        raise NotImplementedError

    def slots(self) -> Dict[str, torch.Tensor]:
        """The per-leaf state buffers by slot name."""
        return {}

    def host_views(self, flat: torch.Tensor) -> Dict[str, np.ndarray]:
        """{parameter name: numpy copy} of a flat buffer: one device-to-host
        copy of the whole buffer, then slices of it."""
        host = to_numpy(flat)
        out = {}
        for name, _ in self._params:
            offset, shape = self._slots[name]
            out[name] = host[offset:offset + shape.numel()].reshape(tuple(shape)).copy()
        return out

    def load_views(self, flat: torch.Tensor, arrays: Mapping[str, np.ndarray], what: str,
                   strict: bool = True) -> List[str]:
        """Copy ``arrays`` ({parameter name: array}) into the views of
        ``flat`` in place; returns the names it did not find. A shape
        mismatch raises; a missing name raises under ``strict``."""
        staged = torch.empty(flat.numel(), dtype=torch.float32)
        staged.copy_(flat.detach().float().cpu())
        missing = []
        for name, _ in self._params:
            offset, shape = self._slots[name]
            if name not in arrays:
                missing.append(name)
                continue
            value = np.asarray(arrays[name])
            if tuple(value.shape) != tuple(shape):
                raise ValueError(f'{what}.{name}: checkpoint shape {tuple(value.shape)}, '
                                 f'parameter shape {tuple(shape)}')
            staged[offset:offset + shape.numel()] = torch.from_numpy(
                np.ascontiguousarray(value, np.float32)).reshape(-1)
        if strict and missing:
            raise KeyError(f'Missing checkpoint keys: {[f"{what}.{n}" for n in missing[:5]]}')
        with torch.no_grad():
            flat.copy_(staged.to(flat.dtype).to(flat.device))
        return missing

    def state_arrays(self) -> Dict[str, np.ndarray]:
        out = {'count': self.count.cpu().numpy().copy(),
               'learning_rate': np.asarray(self.lr, np.float32)}
        for slot, buf in self.slots().items():
            out.update({f'{slot}.{k}': v for k, v in self.host_views(buf).items()})
        return out

    def load_state_arrays(self, state: Mapping[str, np.ndarray], strict: bool = True) -> None:
        """Load what ``state_arrays`` gave (keys without the ``optimizer.``
        prefix). Under ``strict`` a missing or an unknown key raises."""
        slots = self.slots()
        known = {'count', 'learning_rate'}
        for slot, buf in slots.items():
            prefix = slot + '.'
            sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            known.update(prefix + k for k in sub)
            self.load_views(buf, sub, 'optimizer.' + slot, strict=strict)
        unknown = sorted(set(state) - known)
        if strict and (unknown or 'count' not in state):
            raise KeyError(f'optimizer state: unknown keys {unknown[:5]}'
                           + ('' if 'count' in state else ', no count'))
        if 'count' in state:
            self.count.fill_(int(np.asarray(state['count'])))
        if 'learning_rate' in state:
            self.set_hyperparams(lr=float(np.asarray(state['learning_rate'])))


class AdamW(_FlatOptimizer):
    """optax's ``adamw`` (``scale_by_adam -> add_decayed_weights(mask) ->
    scale_by_learning_rate``), with the EMA, through one kernel launch."""

    def __init__(self, named_params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 wd_mask: Optional[Mapping[str, bool]] = None,
                 mu_dtype: Optional[torch.dtype] = None):
        super().__init__(named_params, lr, weight_decay, wd_mask)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        mu_dtype = mu_dtype or torch.float32
        if mu_dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f'mu_dtype {mu_dtype}: the port stores m in fp32 or bf16')
        self.m = torch.zeros(self.flat_param.numel(), dtype=mu_dtype, device=self.device)
        self.v = torch.zeros_like(self.flat_param)

    def slots(self):
        return {'mu': self.m, 'nu': self.v}

    def step(self, lr=None, grad_scale=None, ok=None, ema_decay=None):
        self.set_hyperparams(lr, ema_decay)
        self.sync_grads()
        fused_adamw(self.flat_param, self.flat_grad, self.m, self.v, self.ema, self.count,
                    lr=self.lr_t, b1=self.b1, b2=self.b2, eps=self.eps,
                    weight_decay=self.weight_decay, n_decay=self.n_decay,
                    ema_decay=self.ema_decay_t, grad_scale=grad_scale, ok=ok)


class SGD(_FlatOptimizer):
    """optax's ``sgd`` (``trace(momentum, nesterov) ->
    scale_by_learning_rate``) behind the JAX factory's coupled L2
    (``add_decayed_weights(mask)`` first), in plain PyTorch."""

    def __init__(self, named_params, lr: float = 1e-3, momentum: Optional[float] = 0.9,
                 nesterov: bool = True, weight_decay: float = 0.0,
                 wd_mask: Optional[Mapping[str, bool]] = None):
        super().__init__(named_params, lr, weight_decay, wd_mask)
        self.momentum = momentum
        self.nesterov = nesterov
        self.trace = None if momentum is None else torch.zeros_like(self.flat_param)

    def slots(self):
        return {} if self.trace is None else {'trace': self.trace}

    def step(self, lr=None, grad_scale=None, ok=None, ema_decay=None):
        self.set_hyperparams(lr, ema_decay)
        self.sync_grads()
        p = self.flat_param
        f32 = torch.float32
        g = self.flat_grad if grad_scale is None else self.flat_grad * grad_scale
        if self.weight_decay and self.n_decay:
            nd = self.n_decay
            g = torch.cat([g[:nd] + torch.tensor(self.weight_decay, dtype=f32) * p[:nd], g[nd:]])
        new = []
        if self.trace is not None:
            mom = torch.tensor(self.momentum, dtype=f32)
            trace = g + mom * self.trace
            g = g + mom * trace if self.nesterov else trace
            new.append((self.trace, trace))
        p_new = p + torch.neg(self.lr_t) * g
        new.append((p, p_new))
        new.append((self.count, self.count + 1))
        if self.ema is not None:
            d = self.ema_decay_t
            new.append((self.ema, self.ema * d + p_new * (1 - d)))
        for old, value in new:
            old.copy_(value if ok is None else torch.where(ok, value, old))
