"""The port's optimizers over flat parameter buffers.

The JAX package's optimizers are optax chains over the parameter tree. The
port keeps their arithmetic but lays the parameters out for the card: at
construction every parameter's storage moves into one flat fp32 buffer that
the parameter becomes a view of, and ``.grad`` becomes a view of a second
flat buffer, so backward accumulates straight into it. Leaves are ordered
by the optimizer's group (Muon's Adam leaves before its matrices; one group
for the others), then leaves that take weight decay first, so with one
group the decay mask is one boundary ``n_decay``. The optimizer state
(AdamW's m and v, SGD's trace, the EMA, ...) lives in flat buffers of the
same layout, and one AdamW step over every leaf is one launch of the fused
AdamW + EMA kernel (``kernels/fused_adamw.py``). The other updates are
plain PyTorch on the flat buffers; per-leaf reductions (LAMB's trust
ratio, MARS's clip, the cautious mask) are ``torch._foreach_norm`` over
the leaves' views, deterministic and with no atomics, and Muon's
Newton-Schulz products are fp32 ``bmm`` over the same-shaped matrices.

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

The JAX factory's wrappers are options of every optimizer here, applied to
the update in the JAX factory's order: ``lookahead`` (sync period 6, slow
step 0.5, the sync chosen on the device), then ``caution`` (the per-leaf
sign mask rescaled by ``size / max(sum, 1)``), then ``lr_scales`` (layer
decay's per-leaf factors). AdamW with none of them is the fused kernel;
with any, its plain chain.

``state_arrays`` / ``load_state_arrays`` give the state as a flat
``{key: np.ndarray}`` in the parameters' own names and layout: ``count``,
``learning_rate``, per leaf ``<slot>.<name>`` for every leaf the slot covers
(Muon's ``nu`` covers its Adam leaves only) and ``<slot>`` for a scalar
slot (LaProp's ``exp_avg_lr_1`` / ``exp_avg_lr_2``). A bf16 first moment is
stored as fp32, which holds it exactly. Loading copies into the flat
buffers in place: parameters and ``.grad`` stay views of them.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels.fused_adamw import _consts, fused_adamw
from ..utils.serialization import to_numpy

__all__ = ['AdamW', 'SGD', 'NAdamW', 'Lamb', 'Muon', 'Madgrad', 'Laprop', 'Mars',
           'Adam', 'AdamP', 'RAdam', 'Adamax', 'AdaBelief', 'Yogi', 'Adopt', 'Lion', 'Lars', 'Adan',
           'NovoGrad', 'RMSprop', 'SGDW', 'Adadelta', 'Adagrad', 'Adafactor', 'SM3',
           'NS_COEFFS', 'NS_STEPS', 'factored_dims', 'orthogonalize_via_newton_schulz']

_ALIGN = 4  # elements: every leaf starts on a 16-byte boundary
LOOKAHEAD_SYNC_PERIOD, LOOKAHEAD_SLOW_STEP = 6, 0.5
# optax.contrib.muon's Newton-Schulz iteration as the JAX factory runs it:
# its step count, its quintic coefficients rounded to fp32 as its state
# stores them, and the eps of its Frobenius normalization
NS_STEPS = 5
NS_COEFFS = tuple(float(np.float32(c)) for c in (3.4445, -4.7750, 2.0315))
NS_EPS = 1e-8


class _FlatOptimizer:
    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]], lr: float,
                 weight_decay: float = 0.0, wd_mask: Optional[Mapping[str, bool]] = None,
                 group: Optional[Callable[[str, nn.Parameter], int]] = None,
                 lookahead: bool = False, caution: bool = False,
                 lr_scales: Optional[Mapping[str, float]] = None):
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
        self._decay = {n: True if wd_mask is None else bool(wd_mask[n]) for n, _ in named}
        ordered = sorted(named, key=lambda x: (group(*x) if group else 0, not self._decay[x[0]]))
        self._params: List[Tuple[str, nn.Parameter]] = ordered
        self._slots: Dict[str, Tuple[int, torch.Size]] = {}
        self._ends: Dict[str, int] = {}  # each leaf's padded end
        offset, self.n_decay = 0, 0
        for name, p in ordered:
            self._slots[name] = (offset, p.shape)
            offset += -(-p.numel() // _ALIGN) * _ALIGN
            self._ends[name] = offset
            if self._decay[name]:
                self.n_decay = offset  # the decay boundary when there is one group
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
        self.caution = bool(caution)
        self.lr_scales = dict(lr_scales) if lr_scales is not None else None
        # lookahead's slow weights start as the parameters, as its init does
        self.slow = self.flat_param.clone() if lookahead else None
        self._consts: Dict[str, torch.Tensor] = {}

    # -- layout ------------------------------------------------------------------
    def _view(self, flat: torch.Tensor, name: str, base: int = 0) -> torch.Tensor:
        """The leaf's view of ``flat``, a buffer of this layout that starts
        at element ``base`` of it."""
        offset, shape = self._slots[name]
        return flat[offset - base:offset - base + shape.numel()].view(shape)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{parameter name: view} of a flat buffer of this layout."""
        return {name: self._view(flat, name) for name, _ in self._params}

    def _leaf_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [self._view(flat, name).reshape(-1) for name, _ in self._params]

    def decay_mask(self) -> Dict[str, bool]:
        return {name: self._decay[name] for name, _ in self._params}

    def _const(self, key: str, make: Callable[[], torch.Tensor]) -> torch.Tensor:
        """A constant of the update, made at its first (eager) use and kept:
        a graph capture that follows reads the same buffer."""
        if key not in self._consts:
            self._consts[key] = make()
        return self._consts[key]

    def _flat_of(self, values: Mapping[str, object], dtype: torch.dtype) -> torch.Tensor:
        """A flat buffer of this layout holding ``values[name]`` over each
        leaf's elements and its padding."""
        out = torch.zeros(self.flat_param.numel(), dtype=dtype, device=self.device)
        for name, _ in self._params:
            out[self._slots[name][0]:self._ends[name]] = values[name]
        return out

    def _expand(self, per_leaf: torch.Tensor) -> torch.Tensor:
        """(L,) values, one per leaf in layout order, over the flat layout."""
        ids = self._const('leaf_ids', lambda: self._flat_of(
            {n: i for i, (n, _) in enumerate(self._params)}, torch.int32))
        return per_leaf.index_select(0, ids)

    def _leaf_norms(self, flat: torch.Tensor, ord: float = 2) -> torch.Tensor:
        """(L,) fp32 norms of each leaf of ``flat`` (its padding is zero).
        On the CPU the 2-norms are sqrt(sum(x^2)) leaf by leaf: torch's CPU
        norm kernels sum long leaves with a relative error that grows as
        sqrt(n) (3.7e-5 over ResNet-50's 2.36M-element conv), where its
        ``sum`` stays within 1e-7; on the card ``_foreach_norm``'s tree
        reduction is as exact and is one launch."""
        views = self._leaf_views(flat)
        if flat.device.type == 'cpu' and ord == 2:
            return torch.stack([torch.sqrt(torch.sum(v * v)) for v in views])
        return torch.stack(torch._foreach_norm(views, ord))

    def _add_decay(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """optax's ``add_decayed_weights(weight_decay, mask)``: u + wd * p on
        the leaves of the decay mask."""
        if not self.weight_decay or not any(self._decay.values()):
            return u
        decay = self._const('decay', lambda: self._flat_of(self._decay, torch.bool))
        return torch.where(decay, u + self.weight_decay * p, u)

    # -- steps -------------------------------------------------------------------
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

    def _update(self, g: torch.Tensor, p: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """(the update added to p, [(state buffer, its new value)]) for the
        clipped gradient ``g``: the inner optimizer, learning rate included."""
        raise NotImplementedError

    def _wrap(self, u, g, p, new):
        """The JAX factory's wrappers around the inner update, in its order."""
        if self.slow is not None:
            sync = torch.remainder(self.count + 1, LOOKAHEAD_SYNC_PERIOD) == 0
            target = self.slow + LOOKAHEAD_SLOW_STEP * ((p + u) - self.slow)
            new.append((self.slow, torch.where(sync, target, self.slow)))
            u = torch.where(sync, target - p, u)
        if self.caution:
            mask = (u * g < 0).to(u.dtype)
            sizes = self._const('leaf_sizes', lambda: torch.tensor(
                [float(p.numel()) for _, p in self._params], device=self.device))
            counts = self._leaf_norms(mask, 1)  # the sum of a 0/1 mask, exact in fp32
            u = u * mask * self._expand(sizes / torch.clamp_min(counts, 1.0))
        if self.lr_scales is not None:
            u = u * self._const('lr_scales', lambda: self._flat_of(
                {n: float(np.float32(s)) for n, s in self.lr_scales.items()}, torch.float32))
        return u

    def step(self, lr: Optional[float] = None, grad_scale: Optional[torch.Tensor] = None,
             ok: Optional[torch.Tensor] = None, ema_decay: Optional[float] = None) -> None:
        self.set_hyperparams(lr, ema_decay)
        self.sync_grads()
        p = self.flat_param
        g = self.flat_grad if grad_scale is None else self.flat_grad * grad_scale
        u, new = self._update(g, p)
        u = self._wrap(u, g, p, new)
        p_new = p + u
        new += [(p, p_new), (self.count, self.count + 1)]
        if self.ema is not None:
            d = self.ema_decay_t
            new.append((self.ema, self.ema * d + p_new * (1 - d)))
        for old, value in new:
            old.copy_(value if ok is None else torch.where(ok, value, old))

    # -- state ---------------------------------------------------------------------
    def slots(self) -> Dict[str, torch.Tensor]:
        """The state buffers by slot name: flat ones of this layout (or of
        its first leaves, see ``_cover``) and 0-d scalars."""
        return {} if self.slow is None else {'slow': self.slow}

    def _cover(self, slot: str) -> List[str]:
        """The leaves a flat slot holds state for: all of them, unless the
        optimizer says otherwise."""
        return [name for name, _ in self._params]

    def leaf_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """State outside the flat layout, {slot: {key: tensor}}: tensors of
        their own shapes (Adafactor's factored moments and SM3's accumulators
        in the JAX layout's dims, NovoGrad's per-leaf scalars), each under
        ``<slot>.<key>`` in ``state_arrays``."""
        return {}

    def state_keys(self) -> List[str]:
        """The keys ``state_arrays`` returns, without copying state."""
        keys = ['count', 'learning_rate']
        for slot, buf in self.slots().items():
            keys += [slot] if buf.ndim == 0 else [f'{slot}.{n}' for n in self._cover(slot)]
        for slot, tensors in self.leaf_state().items():
            keys += [f'{slot}.{k}' for k in tensors]
        return keys

    def host_views(self, flat: torch.Tensor, names: Optional[Sequence[str]] = None
                   ) -> Dict[str, np.ndarray]:
        """{parameter name: numpy copy} of a flat buffer, for ``names`` (every
        leaf by default): one device-to-host copy of the whole buffer, then
        slices of it."""
        host = to_numpy(flat)
        out = {}
        for name in names if names is not None else [n for n, _ in self._params]:
            offset, shape = self._slots[name]
            out[name] = host[offset:offset + shape.numel()].reshape(tuple(shape)).copy()
        return out

    def load_views(self, flat: torch.Tensor, arrays: Mapping[str, np.ndarray], what: str,
                   strict: bool = True, names: Optional[Sequence[str]] = None) -> List[str]:
        """Copy ``arrays`` ({parameter name: array}) into the views of
        ``flat`` in place, for ``names`` (every leaf by default); returns the
        names it did not find. A shape mismatch raises; a missing name
        raises under ``strict``."""
        staged = torch.empty(flat.numel(), dtype=torch.float32)
        staged.copy_(flat.detach().float().cpu())
        missing = []
        for name in names if names is not None else [n for n, _ in self._params]:
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
            if buf.ndim == 0:
                out[slot] = buf.cpu().numpy().copy()
            else:
                out.update({f'{slot}.{k}': v
                            for k, v in self.host_views(buf, self._cover(slot)).items()})
        for slot, tensors in self.leaf_state().items():
            out.update({f'{slot}.{k}': to_numpy(t).astype(np.float32) for k, t in tensors.items()})
        return out

    def load_state_arrays(self, state: Mapping[str, np.ndarray], strict: bool = True) -> None:
        """Load what ``state_arrays`` gave (keys without the ``optimizer.``
        prefix). Under ``strict`` a missing or an unknown key raises."""
        known = {'count', 'learning_rate'}
        for slot, buf in self.slots().items():
            if buf.ndim == 0:
                if slot in state:
                    known.add(slot)
                    buf.fill_(float(np.asarray(state[slot])))
                elif strict:
                    raise KeyError(f'Missing checkpoint keys: [optimizer.{slot}]')
                continue
            prefix = slot + '.'
            sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            known.update(prefix + k for k in sub)
            self.load_views(buf, sub, 'optimizer.' + slot, strict=strict, names=self._cover(slot))
        for slot, tensors in self.leaf_state().items():
            for k, t in tensors.items():
                key = f'{slot}.{k}'
                if key not in state:
                    if strict:
                        raise KeyError(f'Missing checkpoint keys: [optimizer.{key}]')
                    continue
                value = np.asarray(state[key])
                if tuple(value.shape) != tuple(t.shape):
                    raise ValueError(f'optimizer.{key}: checkpoint shape {tuple(value.shape)}, '
                                     f'state shape {tuple(t.shape)}')
                known.add(key)
                with torch.no_grad():
                    t.copy_(torch.from_numpy(np.array(value, np.float32)).to(t.device, t.dtype))
        unknown = sorted(set(state) - known)
        if strict and (unknown or 'count' not in state):
            raise KeyError(f'optimizer state: unknown keys {unknown[:5]}'
                           + ('' if 'count' in state else ', no count'))
        if 'count' in state:
            self.count.fill_(int(np.asarray(state['count'])))
        if 'learning_rate' in state:
            self.set_hyperparams(lr=float(np.asarray(state['learning_rate'])))


def _scale_by_adam(g, m, v, count, b1: float, b2: float, eps: float, nesterov: bool = False):
    """optax's ``scale_by_adam`` (eps_root 0) on flat buffers: (update, m',
    v'), m' in fp32 (the caller stores it in m's dtype). A bf16 m meets b1
    rounded to bf16, as the fused kernel's plain version has it."""
    c = _consts(b1, b2)
    t = (count + 1).to(torch.float32)
    b1_m = c['b1_bf16'] if m.dtype == torch.bfloat16 else b1
    m_new = c['one_minus_b1'] * g + m.float() * b1_m
    v_new = c['one_minus_b2'] * (g * g) + b2 * v
    if nesterov:
        mu_hat = (b1 * (m_new / (1 - torch.pow(b1, t + 1)))
                  + c['one_minus_b1'] * (g / (1 - torch.pow(b1, t))))
    else:
        mu_hat = m_new / (1 - torch.pow(b1, t))
    return mu_hat / (torch.sqrt(v_new / (1 - torch.pow(b2, t))) + eps), m_new, v_new


def _neg_lr(opt: _FlatOptimizer, u: torch.Tensor) -> torch.Tensor:
    """optax's ``scale_by_learning_rate``: -lr * u, lr read on the device."""
    return torch.neg(opt.lr_t) * u


class AdamW(_FlatOptimizer):
    """optax's ``adamw`` (``scale_by_adam -> add_decayed_weights(mask) ->
    scale_by_learning_rate``), with the EMA, through one kernel launch; with
    a wrapper, the same chain in plain PyTorch."""

    def __init__(self, named_params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 wd_mask: Optional[Mapping[str, bool]] = None,
                 mu_dtype: Optional[torch.dtype] = None, nesterov: bool = False, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.nesterov = nesterov
        mu_dtype = mu_dtype or torch.float32
        if mu_dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f'mu_dtype {mu_dtype}: the port stores m in fp32 or bf16')
        self.m = torch.zeros(self.flat_param.numel(), dtype=mu_dtype, device=self.device)
        self.v = torch.zeros_like(self.flat_param)

    @property
    def fused(self) -> bool:
        """True when the step is the fused AdamW + EMA kernel: the plain
        AdamW chain with no wrapper, what JAX's ``fused_adamw_args`` marks."""
        return not (self.nesterov or self.caution or self.slow is not None
                    or self.lr_scales is not None)

    def slots(self):
        return dict(mu=self.m, nu=self.v, **super().slots())

    def _update(self, g, p):
        u, m_new, v_new = _scale_by_adam(g, self.m, self.v, self.count, self.b1, self.b2,
                                         self.eps, self.nesterov)
        u = _neg_lr(self, self._add_decay(u, p))
        return u, [(self.m, m_new.to(self.m.dtype)), (self.v, v_new)]

    def step(self, lr=None, grad_scale=None, ok=None, ema_decay=None):
        if not self.fused:
            return super().step(lr, grad_scale, ok, ema_decay)
        self.set_hyperparams(lr, ema_decay)
        self.sync_grads()
        fused_adamw(self.flat_param, self.flat_grad, self.m, self.v, self.ema, self.count,
                    lr=self.lr_t, b1=self.b1, b2=self.b2, eps=self.eps,
                    weight_decay=self.weight_decay, n_decay=self.n_decay,
                    ema_decay=self.ema_decay_t, grad_scale=grad_scale, ok=ok)


class NAdamW(AdamW):
    """optax's ``nadamw``: ``adamw`` with Nesterov momentum, in plain
    PyTorch (the fused kernel mirrors the plain chain only)."""

    def __init__(self, named_params, **kw):
        super().__init__(named_params, nesterov=True, **kw)


class Lamb(AdamW):
    """optax's ``lamb`` (``scale_by_adam -> add_decayed_weights(mask) ->
    scale_by_trust_ratio -> scale_by_learning_rate``), the first moment in
    ``mu_dtype`` as the JAX factory's chain stores it."""

    def __init__(self, named_params, eps: float = 1e-6, **kw):
        super().__init__(named_params, eps=eps, **kw)

    @property
    def fused(self) -> bool:
        return False

    def _update(self, g, p):
        u, m_new, v_new = _scale_by_adam(g, self.m, self.v, self.count, self.b1, self.b2, self.eps)
        u = self._add_decay(u, p)
        p_norm, u_norm = self._leaf_norms(p), self._leaf_norms(u)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
        u = _neg_lr(self, u * self._expand(ratio))
        return u, [(self.m, m_new.to(self.m.dtype)), (self.v, v_new)]


class SGD(_FlatOptimizer):
    """optax's ``sgd`` (``trace(momentum, nesterov) ->
    scale_by_learning_rate``) behind the JAX factory's coupled L2
    (``add_decayed_weights(mask)`` first), in plain PyTorch."""

    def __init__(self, named_params, lr: float = 1e-3, momentum: Optional[float] = 0.9,
                 nesterov: bool = True, weight_decay: float = 0.0,
                 wd_mask: Optional[Mapping[str, bool]] = None, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.momentum = momentum
        self.nesterov = nesterov
        self.trace = torch.zeros_like(self.flat_param) if momentum else None

    def slots(self):
        return dict(**({} if self.trace is None else {'trace': self.trace}), **super().slots())

    def _update(self, g, p):
        g = self._add_decay(g, p)
        new = []
        if self.trace is not None:
            trace = g + self.momentum * self.trace
            g = g + self.momentum * trace if self.nesterov else trace
            new.append((self.trace, trace))
        return _neg_lr(self, g), new


def orthogonalize_via_newton_schulz(x: torch.Tensor) -> torch.Tensor:
    """optax's ``orthogonalize_via_newton_schulz`` for an fp32 matrix, or a
    batch of them (..., m, n): transposed so that rows <= cols, divided by
    its Frobenius norm + NS_EPS, NS_STEPS quintic steps X <- a X + (b A + c
    A A) X with A = X Xᵀ and (a, b, c) = NS_COEFFS, transposed back. The
    products are fp32 ``bmm``."""
    wide = x.shape[-2] <= x.shape[-1]
    X = (x if wide else x.mT).reshape(-1, *sorted(x.shape[-2:]))
    X = X / (torch.linalg.vector_norm(X, dim=(1, 2), keepdim=True) + NS_EPS)
    a, b, c = NS_COEFFS
    for _ in range(NS_STEPS):
        A = torch.bmm(X, X.mT)
        X = torch.baddbmm(X, torch.baddbmm(A, A, A, beta=b, alpha=c), X, beta=a)
    X = X.reshape(*x.shape[:-2], *X.shape[1:])
    return X if wide else X.mT


class Muon(_FlatOptimizer):
    """optax.contrib's ``muon`` as the JAX factory builds it: a leaf with 2
    dimensions takes Muon (Nesterov momentum with bias correction,
    Newton-Schulz orthogonalization, the scale sqrt(max(1, fan_out /
    fan_in)), masked weight decay, -lr); every other leaf takes optax's
    ``adamw(b1, b2, eps=1e-8, nesterov=True)`` without weight decay.

    The Adam leaves come first in the layout, so ``nu`` covers them alone.
    A JAX kernel is (in, out) where the port's weight is (out, in): each
    matrix is taken in the orientation optax orthogonalizes, (in, out) unless
    in > out, and the matrices of one oriented shape go through the
    Newton-Schulz steps as one batch (ViT-B/16: 12 of 768 x 2304, 12 of
    768 x 768, 24 of 768 x 3072, the head)."""

    def __init__(self, named_params, lr: float = 1e-3, momentum: float = 0.95,
                 weight_decay: float = 0.0, wd_mask: Optional[Mapping[str, bool]] = None,
                 betas: Tuple[float, float] = (0.9, 0.95), **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask,
                         group=lambda n, p: int(p.ndim == 2), **wrap)
        self.beta = float(momentum)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = 1e-8  # optax.contrib.muon's Adam eps: the JAX factory passes none
        self.adam_leaves = [n for n, p in self._params if p.ndim != 2]
        self.muon_leaves = [n for n, p in self._params if p.ndim == 2]
        self.n_adam = self._ends[self.adam_leaves[-1]] if self.adam_leaves else 0
        self.m = torch.zeros_like(self.flat_param)
        self.v = torch.zeros(self.n_adam, dtype=torch.float32, device=self.device)
        groups: Dict[Tuple[int, int], List[Tuple[str, bool, float]]] = {}
        for name in self.muon_leaves:
            out_f, in_f = self._slots[name][1]
            transpose = in_f <= out_f  # optax works on (in, out) unless in > out
            scale = float(np.sqrt(np.float32(max(1.0, out_f / in_f))))
            groups.setdefault((in_f, out_f) if transpose else (out_f, in_f), []).append(
                (name, transpose, scale))
        self._groups = [(leaves, torch.tensor([s for *_, s in leaves], device=self.device)
                         .reshape(-1, 1, 1)) for leaves in groups.values()]

    def slots(self):
        return dict(mu=self.m, nu=self.v, **super().slots())

    def _cover(self, slot):
        return self.adam_leaves if slot == 'nu' else super()._cover(slot)

    def _update(self, g, p):
        na, beta = self.n_adam, self.beta
        t = (self.count + 1).to(torch.float32)
        ua, ma, va = _scale_by_adam(g[:na], self.m[:na], self.v, self.count, self.b1, self.b2,
                                    self.eps, nesterov=True)
        gm = g[na:]
        mm = (1 - beta) * gm + beta * self.m[na:]
        mu_hat = (beta * (mm / (1 - torch.pow(beta, t + 1)))
                  + (1 - beta) * (gm / (1 - torch.pow(beta, t))))
        um = torch.zeros_like(mu_hat)
        for leaves, scale in self._groups:
            x = torch.stack([self._view(mu_hat, n, na).mT if tr else self._view(mu_hat, n, na)
                             for n, tr, _ in leaves])
            x = orthogonalize_via_newton_schulz(x) * scale
            for (name, tr, _), xb in zip(leaves, x):
                self._view(um, name, na).copy_(xb.mT if tr else xb)
        if self.weight_decay and any(self._decay[n] for n in self.muon_leaves):
            decay = self._const('decay', lambda: self._flat_of(self._decay, torch.bool))[na:]
            um = torch.where(decay, um + self.weight_decay * p[na:], um)
        u = _neg_lr(self, torch.cat([ua, um]))
        return u, [(self.m, torch.cat([ma, mm])), (self.v, va)]


class Madgrad(_FlatOptimizer):
    """The JAX package's ``madgrad`` (``timm_tpu/optim/_extra.py``):
    momentumized dual averaging with the cube-root denominator; coupled or
    (``decoupled_decay``) decoupled weight decay under the mask. The update
    is the new parameter less the old, as its delta is."""

    def __init__(self, named_params, lr: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 0.0, eps: float = 1e-6, decoupled_decay: bool = False,
                 wd_mask: Optional[Mapping[str, bool]] = None, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.momentum, self.eps, self.decoupled = float(momentum), float(eps), decoupled_decay
        self.grad_sum_sq = torch.zeros_like(self.flat_param)
        self.s = torch.zeros_like(self.flat_param)
        self.x0 = self.flat_param.clone()

    def slots(self):
        return dict(grad_sum_sq=self.grad_sum_sq, s=self.s, x0=self.x0, **super().slots())

    def _update(self, g, p):
        lr = self.lr_t
        lamb = (lr + self.eps) * torch.sqrt((self.count + 1).to(torch.float32))
        p_eff = p
        if self.weight_decay and any(self._decay.values()):
            decay = self._const('decay', lambda: self._flat_of(self._decay, torch.bool))
            if self.decoupled:
                p_eff = torch.where(decay, p * (1.0 - lr * self.weight_decay), p)
            else:
                g = torch.where(decay, g + self.weight_decay * p, g)
        gss = self.grad_sum_sq + lamb * g * g
        # cube root: fp64 pow rounded to fp32 (torch has no cbrt)
        rms = torch.pow(gss.double(), 1.0 / 3.0).float() + self.eps
        s = self.s + lamb * g
        z = self.x0 - s / rms
        ck = 1 - self.momentum
        new_p = z if self.momentum == 0 else (1 - ck) * p_eff + ck * z
        return new_p - p, [(self.grad_sum_sq, gss), (self.s, s)]


class Laprop(_FlatOptimizer):
    """The JAX package's ``laprop`` (``timm_tpu/optim/_extra.py``): the
    momentum accumulates lr-scaled normalized gradients; its two fp32
    scalars track the lr-weighted bias correction."""

    def __init__(self, named_params, lr: float = 4e-4, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-15, weight_decay: float = 0.0,
                 wd_mask: Optional[Mapping[str, bool]] = None, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.exp_avg = torch.zeros_like(self.flat_param)
        self.exp_avg_sq = torch.zeros_like(self.flat_param)
        self.exp_avg_lr_1 = torch.zeros((), dtype=torch.float32, device=self.device)
        self.exp_avg_lr_2 = torch.zeros((), dtype=torch.float32, device=self.device)

    def slots(self):
        return dict(exp_avg=self.exp_avg, exp_avg_sq=self.exp_avg_sq,
                    exp_avg_lr_1=self.exp_avg_lr_1, exp_avg_lr_2=self.exp_avg_lr_2,
                    **super().slots())

    def _update(self, g, p):
        lr, b1, b2 = self.lr_t, self.b1, self.b2
        ealr1 = self.exp_avg_lr_1 * b1 + (1 - b1) * lr
        ealr2 = self.exp_avg_lr_2 * b2 + (1 - b2)
        nonzero = lr != 0.0
        step_size = 1.0 / torch.where(nonzero, ealr1 / torch.where(nonzero, lr, 1.0), 1.0)
        eas = b2 * self.exp_avg_sq + (1 - b2) * g * g
        ea = b1 * self.exp_avg + lr * (1 - b1) * (g / (torch.sqrt(eas / ealr2) + self.eps))
        u = -step_size * ea
        if self.weight_decay and any(self._decay.values()):
            decay = self._const('decay', lambda: self._flat_of(self._decay, torch.bool))
            u = torch.where(decay, u - lr * self.weight_decay * p, u)
        return u, [(self.exp_avg, ea), (self.exp_avg_sq, eas),
                   (self.exp_avg_lr_1, ealr1), (self.exp_avg_lr_2, ealr2)]


class Mars(_FlatOptimizer):
    """The JAX package's ``mars`` (``timm_tpu/optim/_extra.py``): on leaves
    of 2 or more dimensions (all with ``optimize_1d``) the momentum takes the
    gradient plus its scaled difference from the last one, clipped to norm
    1 per leaf (the raw gradient on the first step), then an AdamW
    (``mars_type='adamw'``) or sign (``'lion'``) update; the other leaves
    take AdamW with ``betas_1d`` and ``lr * lr_1d_factor``."""

    def __init__(self, named_params, lr: float = 3e-3, betas: Tuple[float, float] = (0.9, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.0, gamma: float = 0.025,
                 mars_type: str = 'adamw', optimize_1d: bool = False, lr_1d_factor: float = 1.0,
                 betas_1d: Optional[Tuple[float, float]] = None,
                 wd_mask: Optional[Mapping[str, bool]] = None, **wrap):
        if mars_type not in ('adamw', 'lion'):
            raise ValueError(f"mars_type must be 'adamw' or 'lion'; got {mars_type!r}")
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.b1, self.b2 = (float(b) for b in betas)
        self.b1_1d, self.b2_1d = (float(b) for b in (betas_1d or betas))
        self.eps, self.gamma, self.mars_type = float(eps), float(gamma), mars_type
        self.lr_1d_factor = float(lr_1d_factor)
        self._md = {n: optimize_1d or p.ndim >= 2 for n, p in self._params}
        self.exp_avg = torch.zeros_like(self.flat_param)
        self.exp_avg_sq = torch.zeros_like(self.flat_param)
        self.last_grad = torch.zeros_like(self.flat_param)

    def slots(self):
        return dict(exp_avg=self.exp_avg, exp_avg_sq=self.exp_avg_sq, last_grad=self.last_grad,
                    **super().slots())

    def _update(self, g, p):
        t = (self.count + 1).to(torch.float32)
        lr, ea, eas = self.lr_t, self.exp_avg, self.exp_avg_sq
        pwd = p * self._const('wd', lambda: self._flat_of(
            {n: self.weight_decay if d else 0.0 for n, d in self._decay.items()}, torch.float32))
        parts = []  # (update, exp_avg, exp_avg_sq) of each branch present
        if any(self._md.values()):
            b1, b2 = self.b1, self.b2
            c_raw = g + self.gamma * (b1 / (1 - b1)) * (g - self.last_grad)
            norm = self._leaf_norms(c_raw)
            divisor = torch.where(norm > 1.0, torch.clamp_min(norm, 1e-12), 1.0)
            c_clip = c_raw / self._expand(divisor)
            c = torch.where(t == 1, g, c_clip)
            ea_m = b1 * ea + (1 - b1) * c
            if self.mars_type == 'adamw':
                eas_m = b2 * eas + (1 - b2) * c * c
                denom = torch.sqrt(eas_m) / torch.sqrt(1.0 - torch.pow(b2, t)) + self.eps
                upd = pwd + (ea_m / (1.0 - torch.pow(b1, t))) / denom
            else:
                eas_m = eas
                upd = pwd + torch.sign(ea_m)
            parts.append((torch.neg(lr) * upd, ea_m, eas_m))
        if not all(self._md.values()):
            b1, b2 = self.b1_1d, self.b2_1d
            ea_1 = b1 * ea + (1 - b1) * g
            eas_1 = b2 * eas + (1 - b2) * g * g
            denom = torch.sqrt(eas_1) / torch.sqrt(1.0 - torch.pow(b2, t)) + self.eps
            upd = pwd + (ea_1 / (1.0 - torch.pow(b1, t))) / denom
            parts.append((torch.neg(lr * self.lr_1d_factor) * upd, ea_1, eas_1))
        if len(parts) == 2:
            md = self._const('md', lambda: self._flat_of(self._md, torch.bool))
            parts = [tuple(torch.where(md, a, b) for a, b in zip(*parts))]
        u, ea_new, eas_new = parts[0]
        return u, [(self.exp_avg, ea_new), (self.exp_avg_sq, eas_new), (self.last_grad, g)]


# ---- the rest of the JAX registry ---------------------------------------------------------
#
# Each class below is an optax chain as the JAX factory builds it, in plain
# PyTorch on the flat buffers. A name whose JAX factory has no weight-decay
# argument (adam, nadam, radam, adamax, adabelief, adagrad, rmsprop, yogi,
# sm3, adopt, 'momentum', 'lookahead') takes the JAX factory's coupled L2
# first: its builder passes that L2 as ``weight_decay`` and the class adds
# it to the gradient (``_add_decay``) before the inner transform, as the
# existing SGD does. Branches on the step count (RAdam's rho test, ADOPT's
# first step, NovoGrad's first step, Adafactor's decay) are ``torch.where``
# on device scalars, so a captured step replays them; nothing is read back
# to the host.

def _t(opt: _FlatOptimizer) -> torch.Tensor:
    """optax's ``count_inc``: the step being taken, fp32 on the device."""
    return (opt.count + 1).to(torch.float32)


def _bias_correction(moment: torch.Tensor, decay: float, t: torch.Tensor) -> torch.Tensor:
    """optax's ``tree_bias_correction``: moment / (1 - decay ** t)."""
    return moment / (1 - torch.pow(decay, t))


class Adam(AdamW):
    """optax's ``adam`` (``nadam`` with ``nesterov``) behind the JAX factory's
    coupled L2: ``add_decayed_weights(l2, mask) -> scale_by_adam ->
    scale_by_learning_rate``; 'adamp' is ``AdamP`` below."""

    @property
    def fused(self) -> bool:
        return False

    def _update(self, g, p):
        g = self._add_decay(g, p)
        u, m_new, v_new = _scale_by_adam(g, self.m, self.v, self.count, self.b1, self.b2,
                                         self.eps, self.nesterov)
        return _neg_lr(self, u), [(self.m, m_new.to(self.m.dtype)), (self.v, v_new)]


class AdamP(AdamW):
    """'adamp' of the JAX registry, which is optax's ``adamw`` (no real
    AdamP): the plain chain, never the fused kernel, as JAX marks only
    'adamw' fused."""

    @property
    def fused(self) -> bool:
        return False


class RAdam(_FlatOptimizer):
    """optax's ``radam``: Adam's moments, and below the variance threshold
    (rho < ``threshold``) the bias-corrected first moment alone; coupled L2
    first."""

    def __init__(self, named_params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 threshold: float = 5.0, weight_decay: float = 0.0, wd_mask=None, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps, self.threshold = float(eps), float(threshold)
        self.m = torch.zeros_like(self.flat_param)
        self.v = torch.zeros_like(self.flat_param)

    def slots(self):
        return dict(mu=self.m, nu=self.v, **super().slots())

    def _update(self, g, p):
        g = self._add_decay(g, p)
        b1, b2, t = self.b1, self.b2, _t(self)
        m = (1 - b1) * g + b1 * self.m
        v = (1 - b2) * (g * g) + b2 * self.v
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = torch.pow(b2, t)
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        mu_hat = _bias_correction(m, b1, t)
        nu_hat = _bias_correction(v, b2, t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        u = torch.where(ro >= self.threshold, r * mu_hat / (torch.sqrt(nu_hat) + self.eps), mu_hat)
        return _neg_lr(self, u), [(self.m, m), (self.v, v)]


class Adamax(RAdam):
    """optax's ``adamax``: the infinity-norm second moment
    max(|g| + eps, b2 * nu), no bias correction on it; coupled L2 first."""

    def _update(self, g, p):
        g = self._add_decay(g, p)
        b1, t = self.b1, _t(self)
        m = (1 - b1) * g + b1 * self.m
        v = torch.maximum(torch.abs(g) + self.eps, self.b2 * self.v)
        return _neg_lr(self, _bias_correction(m, b1, t) / v), [(self.m, m), (self.v, v)]


class AdaBelief(RAdam):
    """optax's ``adabelief``: the second moment of g - m (+ eps_root), Adam's
    bias corrections; coupled L2 first."""

    def __init__(self, named_params, eps: float = 1e-16, eps_root: float = 1e-16, **kw):
        super().__init__(named_params, eps=eps, **kw)
        self.eps_root = float(eps_root)

    def _update(self, g, p):
        g = self._add_decay(g, p)
        b1, b2, t = self.b1, self.b2, _t(self)
        m = (1 - b1) * g + b1 * self.m
        err = g - m
        v = (1 - b2) * (err * err) + b2 * self.v + self.eps_root
        u = _bias_correction(m, b1, t) / (torch.sqrt(_bias_correction(v, b2, t)) + self.eps)
        return _neg_lr(self, u), [(self.m, m), (self.v, v)]


class Yogi(RAdam):
    """optax's ``yogi``: nu <- nu - (1 - b2) sign(nu - g^2) g^2, both
    moments starting at 1e-6 (optax's ``initial_accumulator_value``), eps
    1e-3; coupled L2 first."""

    def __init__(self, named_params, eps: float = 1e-3, **kw):
        super().__init__(named_params, eps=eps, **kw)
        self.m.fill_(1e-6)
        self.v.fill_(1e-6)

    def _update(self, g, p):
        g = self._add_decay(g, p)
        b1, b2, t = self.b1, self.b2, _t(self)
        m = (1 - b1) * g + b1 * self.m
        g2 = g * g
        v = self.v - (1 - b2) * torch.sign(self.v - g2) * g2
        u = _bias_correction(m, b1, t) / (torch.sqrt(_bias_correction(v, b2, t)) + self.eps)
        return _neg_lr(self, u), [(self.m, m), (self.v, v)]


class Adopt(AdamW):
    """optax.contrib's ``adopt``: the gradient normalized by the previous
    second moment and clipped to step ** 0.25, then momentum; at step 0
    only the second moment starts (b2 and b1 switched to 0 and 1 on the
    device); coupled L2 first."""

    def __init__(self, named_params, eps: float = 1e-6, betas=(0.9, 0.9999), **kw):
        super().__init__(named_params, eps=eps, betas=betas, **kw)

    @property
    def fused(self) -> bool:
        return False

    def _update(self, g, p):
        g = self._add_decay(g, p)
        first = self.count > 0
        b2 = torch.where(first, self.b2, 0.0)
        b1 = torch.where(first, self.b1, 1.0)
        v = (1 - b2) * (g * g) + b2 * self.v
        clip = torch.pow(self.count.to(torch.float32), 0.25)
        mu_updates = torch.clamp(g / torch.clamp_min(torch.sqrt(self.v), self.eps), -clip, clip)
        m = (1 - b1) * mu_updates + b1 * self.m.float()
        return _neg_lr(self, m), [(self.m, m.to(self.m.dtype)), (self.v, v)]


class Lion(_FlatOptimizer):
    """optax's ``lion``: sign((1 - b1) g + b1 m), then m <- (1 - b2) g + b2 m
    (stored in ``mu_dtype``), masked decoupled weight decay, -lr."""

    def __init__(self, named_params, lr: float = 1e-3, betas=(0.9, 0.99),
                 weight_decay: float = 1e-3, wd_mask=None,
                 mu_dtype: Optional[torch.dtype] = None, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.b1, self.b2 = (float(b) for b in betas)
        self.m = torch.zeros(self.flat_param.numel(), dtype=mu_dtype or torch.float32,
                             device=self.device)

    def slots(self):
        return dict(mu=self.m, **super().slots())

    def _update(self, g, p):
        b1, b2 = self.b1, self.b2
        u = torch.sign((1.0 - b1) * g + b1 * self.m)
        m = (1 - b2) * g + b2 * self.m
        return _neg_lr(self, self._add_decay(u, p)), [(self.m, m.to(self.m.dtype))]


class Lars(_FlatOptimizer):
    """optax's ``lars`` as the JAX factory builds it:
    ``add_decayed_weights(wd, mask) -> scale_by_trust_ratio(trust_coefficient)
    -> scale_by_learning_rate -> trace(momentum)``; the trust ratio per
    leaf, 1 where either norm is 0; the trace holds lr-scaled updates."""

    def __init__(self, named_params, lr: float = 1e-3, momentum: float = 0.9,
                 weight_decay: float = 0.0, trust_coefficient: float = 0.001, wd_mask=None,
                 **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.momentum, self.trust_coefficient = float(momentum), float(trust_coefficient)
        self.trace = torch.zeros_like(self.flat_param)

    def slots(self):
        return dict(trace=self.trace, **super().slots())

    def _update(self, g, p):
        u = self._add_decay(g, p)
        p_norm, u_norm = self._leaf_norms(p), self._leaf_norms(u)
        ratio = self.trust_coefficient * p_norm / u_norm
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, ratio)
        u = _neg_lr(self, u * self._expand(ratio))
        trace = u + self.momentum * self.trace
        return trace, [(self.trace, trace)]


class Adan(_FlatOptimizer):
    """optax's ``adan``: the moments of g, of its difference from the last
    gradient (0 at the first step) and of their Nesterov mix, each bias
    corrected; masked decoupled weight decay, -lr."""

    def __init__(self, named_params, lr: float = 1e-3, betas=(0.98, 0.92, 0.99),
                 eps: float = 1e-8, eps_root: float = 1e-8, weight_decay: float = 0.0,
                 wd_mask=None, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.b1, self.b2, self.b3 = (float(b) for b in betas)
        self.eps, self.eps_root = float(eps), float(eps_root)
        self.m, self.v, self.n, self.g = (torch.zeros_like(self.flat_param) for _ in range(4))

    def slots(self):
        return dict(m=self.m, v=self.v, n=self.n, g=self.g, **super().slots())

    def _update(self, g, p):
        b1, b2, b3, t = self.b1, self.b2, self.b3, _t(self)
        diff = torch.where(self.count == 0, 0.0, g - self.g)
        m = (1 - b1) * g + b1 * self.m
        v = (1 - b2) * diff + b2 * self.v
        sq = g + (1 - b2) * diff
        n = (1 - b3) * (sq * sq) + b3 * self.n
        u = _bias_correction(m, b1, t) + (1 - b2) * _bias_correction(v, b2, t)
        u = u / (torch.sqrt(_bias_correction(n, b3, t) + self.eps_root) + self.eps)
        return _neg_lr(self, self._add_decay(u, p)), [
            (self.m, m), (self.v, v), (self.n, n), (self.g, g)]


class NovoGrad(_FlatOptimizer):
    """optax's ``novograd``: a per-leaf second moment of the squared
    gradient norm (the norm itself at the first step), the first moment of
    g / (sqrt(nu) + eps) + wd * p over every leaf (optax's own weight decay,
    no mask), -lr."""

    def __init__(self, named_params, lr: float = 1e-3, betas=(0.9, 0.25), eps: float = 1e-6,
                 eps_root: float = 0.0, weight_decay: float = 0.0, **wrap):
        super().__init__(named_params, lr, **wrap)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps, self.eps_root, self.wd = float(eps), float(eps_root), float(weight_decay)
        self.m = torch.zeros_like(self.flat_param)
        self.nu = torch.zeros(len(self._params), dtype=torch.float32, device=self.device)

    def slots(self):
        return dict(mu=self.m, **super().slots())

    def leaf_state(self):
        return {'nu': {name: self.nu[i] for i, (name, _) in enumerate(self._params)}}

    def _update(self, g, p):
        first = self.count == 0
        sq = self._leaf_norms(g) ** 2
        nu = torch.where(first, sq, (1 - self.b2) * sq + self.b2 * self.nu)
        add = g / (torch.sqrt(self._expand(nu) + self.eps_root) + self.eps) + self.wd * p
        m = torch.where(first, add, self.b1 * self.m + add)
        return _neg_lr(self, m), [(self.m, m), (self.nu, nu)]


class RMSprop(_FlatOptimizer):
    """optax's ``rmsprop(decay=0.9, momentum=0.9)`` as the JAX registry
    binds it: nu <- decay nu + (1 - decay) g^2 from 0, g / sqrt(nu + eps),
    -lr, then the momentum trace; coupled L2 first. With ``tf=True`` the
    JAX package's ``_rmsprop_tf`` (TF1 RMSprop): the same scaling, then
    masked weight decay, then the trace (none at momentum 0), then -lr."""

    def __init__(self, named_params, lr: float = 1e-3, decay: float = 0.9, eps: float = 1e-8,
                 momentum: Optional[float] = 0.9, weight_decay: float = 0.0, wd_mask=None,
                 tf: bool = False, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.decay, self.eps, self.tf = float(decay), float(eps), tf
        self.momentum = momentum
        self.nu = torch.zeros_like(self.flat_param)
        has_trace = bool(momentum) if tf else momentum is not None
        self.trace = torch.zeros_like(self.flat_param) if has_trace else None

    def slots(self):
        return dict(nu=self.nu, **({} if self.trace is None else {'trace': self.trace}),
                    **super().slots())

    def _update(self, g, p):
        if not self.tf:
            g = self._add_decay(g, p)
        d = self.decay
        nu = (1 - d) * (g * g) + d * self.nu
        u = torch.rsqrt(nu + self.eps) * g
        new = [(self.nu, nu)]
        if self.tf:
            u = self._add_decay(u, p)
        else:
            u = _neg_lr(self, u)
        if self.trace is not None:
            u = u + self.momentum * self.trace
            new.append((self.trace, u))
        return (_neg_lr(self, u) if self.tf else u), new


class SGDW(SGD):
    """The JAX package's ``_sgdw`` ('sgdw', and 'sgdp', which JAX
    approximates by it): ``trace(momentum, nesterov) ->
    add_decayed_weights(wd, mask) -> scale_by_learning_rate`` (decoupled
    from the trace, scaled by lr)."""

    def __init__(self, named_params, momentum: Optional[float] = 0.9, nesterov: bool = False,
                 **kw):
        super().__init__(named_params, momentum=momentum, nesterov=nesterov, **kw)

    def _update(self, g, p):
        new = []
        if self.trace is not None:
            trace = g + self.momentum * self.trace
            g = g + self.momentum * trace if self.nesterov else trace
            new.append((self.trace, trace))
        return _neg_lr(self, self._add_decay(g, p)), new


class Adadelta(_FlatOptimizer):
    """optax's ``adadelta``: masked weight decay first (optax's own), then
    u = sqrt(e_x + eps) / sqrt(e_g + eps) g with e_g, e_x the running means
    of g^2 and u^2, -lr."""

    def __init__(self, named_params, lr: float = 1e-3, rho: float = 0.9, eps: float = 1e-6,
                 weight_decay: float = 0.0, wd_mask=None, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.rho, self.eps = float(rho), float(eps)
        self.e_g = torch.zeros_like(self.flat_param)
        self.e_x = torch.zeros_like(self.flat_param)

    def slots(self):
        return dict(e_g=self.e_g, e_x=self.e_x, **super().slots())

    def _update(self, g, p):
        g = self._add_decay(g, p)
        rho, eps = self.rho, self.eps
        e_g = (1 - rho) * (g * g) + rho * self.e_g
        u = torch.sqrt(self.e_x + eps) / torch.sqrt(e_g + eps) * g
        e_x = (1 - rho) * (u * u) + rho * self.e_x
        return _neg_lr(self, u), [(self.e_g, e_g), (self.e_x, e_x)]


class Adagrad(_FlatOptimizer):
    """optax's ``adagrad``: the sum of squares from 0.1 (optax's
    ``initial_accumulator_value``), g * rsqrt(sum + eps) where the sum is
    positive, -lr; coupled L2 first."""

    def __init__(self, named_params, lr: float = 1e-3, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7, weight_decay: float = 0.0, wd_mask=None, **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self.eps = float(eps)
        self.sum_of_squares = torch.full_like(self.flat_param, float(initial_accumulator_value))

    def slots(self):
        return dict(sum_of_squares=self.sum_of_squares, **super().slots())

    def _update(self, g, p):
        g = self._add_decay(g, p)
        sos = g * g + self.sum_of_squares
        inv = torch.where(sos > 0, torch.rsqrt(sos + self.eps), 0.0)
        return _neg_lr(self, inv * g), [(self.sum_of_squares, sos)]


def _jax_perm(ndim: int, kernel: bool) -> Tuple[int, ...]:
    """The permutation from a port weight's layout to its JAX kernel's:
    (out, in) -> (in, out), (O, I, W) -> (W, I, O), OIHW -> HWIO."""
    if not kernel or ndim < 2:
        return tuple(range(ndim))
    return (2, 3, 1, 0) if ndim == 4 else tuple(reversed(range(ndim)))


class _JaxLayout:
    """Per-leaf state built on the JAX layout's dims: a leaf's gradient and
    parameter seen through a permuted view (``jax``), and back (``port``).
    ``kernels`` names the weights that are conv or linear kernels in JAX."""

    def _init_layout(self, kernels) -> None:
        self._perm = {n: _jax_perm(p.ndim, n in kernels) for n, p in self._params}

    def _jax_shape(self, name: str) -> Tuple[int, ...]:
        shape = self._slots[name][1]
        return tuple(shape[i] for i in self._perm[name])

    def _jax(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        return self._view(flat, name).permute(self._perm[name])

    def _port(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x.permute(tuple(int(i) for i in np.argsort(self._perm[name])))


def factored_dims(shape: Sequence[int], factored: bool, min_dim_size_to_factor: int):
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest dims by numpy's argsort, or None."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(_JaxLayout, _FlatOptimizer):
    """optax's ``adafactor`` as the JAX factory builds it (``_adafactor``):
    factored second moments (rows and columns of the two largest dims of at
    least ``min_dim_size_to_factor``, else a full one) with the decay
    1 - (step + 1) ** -decay_rate, the block RMS clip at
    ``clipping_threshold``, x lr, x the parameter's RMS (at least 1e-3),
    masked weight decay after the lr (optax's ``weight_decay_rate``), -1.

    The moments are built on the JAX layout's dims (see ``_JaxLayout``), so
    the factored dims are JAX's and a JAX checkpoint loads as it is:
    ``v_row``, ``v_col`` and ``v`` per leaf, (1,) where a leaf has none."""

    def __init__(self, named_params, lr: float = 1e-3, clipping_threshold: Optional[float] = 1.0,
                 decay_rate: float = 0.8, weight_decay: float = 0.0, wd_mask=None,
                 min_dim_size_to_factor: int = 32, kernels=(), **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self._init_layout(kernels)
        self.clipping_threshold, self.decay_rate = clipping_threshold, float(decay_rate)
        self.eps = 1e-30
        self.v_row, self.v_col, self.v, self._dims = {}, {}, {}, {}
        one = lambda: torch.zeros(1, device=self.device)  # noqa: E731
        for name, _ in self._params:
            shape = self._jax_shape(name)
            dims = factored_dims(shape, True, min_dim_size_to_factor)
            self._dims[name] = dims
            if dims is None:
                self.v_row[name], self.v_col[name] = one(), one()
                self.v[name] = torch.zeros(shape, device=self.device)
            else:
                d1, d0 = dims
                self.v_row[name] = torch.zeros(np.delete(shape, d0).tolist(), device=self.device)
                self.v_col[name] = torch.zeros(np.delete(shape, d1).tolist(), device=self.device)
                self.v[name] = one()

    def leaf_state(self):
        return {'v_row': self.v_row, 'v_col': self.v_col, 'v': self.v}

    def _update(self, g, p):
        i = self.count.to(torch.float32) + 1
        dr = 1.0 - torch.pow(i, -self.decay_rate)
        u = torch.zeros_like(p)
        new = []
        for name, _ in self._params:
            gj = self._jax(g, name)
            g2 = gj * gj + self.eps
            dims = self._dims[name]
            if dims is None:
                v = dr * self.v[name] + (1.0 - dr) * g2
                upd = gj * torch.pow(v, -0.5)
                new.append((self.v[name], v))
            else:
                d1, d0 = dims
                vr = dr * self.v_row[name] + (1.0 - dr) * g2.mean(dim=d0)
                vc = dr * self.v_col[name] + (1.0 - dr) * g2.mean(dim=d1)
                rd1 = d1 - 1 if d1 > d0 else d1
                row = torch.pow(vr / vr.mean(dim=rd1, keepdim=True), -0.5)
                col = torch.pow(vc, -0.5)
                upd = gj * row.unsqueeze(d0) * col.unsqueeze(d1)
                new += [(self.v_row[name], vr), (self.v_col[name], vc)]
            if self.clipping_threshold is not None:
                denom = torch.clamp_min(torch.sqrt(torch.mean(upd * upd))
                                        / self.clipping_threshold, 1.0)
                upd = upd / denom
            upd = upd * self.lr_t
            pj = self._jax(p, name)
            rms = torch.sqrt(torch.mean(pj * pj))
            upd = upd * torch.where(rms <= 1e-3, 1e-3, rms)
            self._view(u, name).copy_(self._port(upd, name))
        return -self._add_decay(u, p), new


class SM3(_JaxLayout, _FlatOptimizer):
    """optax's ``sm3(lr, momentum)``: one accumulator vector per dim of the
    leaf's JAX shape (the leaf's own squares for a 1-d leaf), the update
    g * rsqrt(g^2 + min over the dims' accumulators + 1e-8) where that is
    positive, its momentum ``nu`` (1 - b1) u + b1 nu, -lr; coupled L2
    first. The accumulators are ``mu.<leaf>.<dim>`` over the JAX layout's
    dims (see ``_JaxLayout``)."""

    def __init__(self, named_params, lr: float = 1e-3, momentum: float = 0.9,
                 weight_decay: float = 0.0, wd_mask=None, kernels=(), **wrap):
        super().__init__(named_params, lr, weight_decay, wd_mask, **wrap)
        self._init_layout(kernels)
        self.b1, self.eps = float(momentum), 1e-8
        self.nu = torch.zeros_like(self.flat_param)
        self.mu = {name: [torch.zeros(s, device=self.device) for s in self._jax_shape(name)]
                   for name, _ in self._params}

    def slots(self):
        return dict(nu=self.nu, **super().slots())

    def leaf_state(self):
        return {'mu': {f'{name}.{i}': a for name, accs in self.mu.items()
                       for i, a in enumerate(accs)}}

    def _update(self, g, p):
        g = self._add_decay(g, p)
        up, new = torch.zeros_like(p), []
        for name, _ in self._params:
            gj, accs = self._jax(g, name), self.mu[name]
            if gj.ndim < 2:
                accum = gj * gj + accs[0]
                new.append((accs[0], accum))
            else:
                shaped = [a.reshape([1] * i + [-1] + [1] * (gj.ndim - i - 1))
                          for i, a in enumerate(accs)]
                low = shaped[0]
                for a in shaped[1:]:
                    low = torch.minimum(low, a)
                accum = gj * gj + low
                for i, a in enumerate(accs):
                    others = [d for d in range(gj.ndim) if d != i]
                    new.append((a, torch.amax(accum, dim=others)))
            inv = torch.where(accum > 0, torch.rsqrt(accum + self.eps), 0.0)
            self._view(up, name).copy_(self._port(gj * inv, name))
        nu = (1 - self.b1) * up + self.b1 * self.nu
        return _neg_lr(self, nu), new + [(self.nu, nu)]
