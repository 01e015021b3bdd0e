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
           'NS_COEFFS', 'NS_STEPS', 'orthogonalize_via_newton_schulz']

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
        """(L,) fp32 norms of each leaf of ``flat`` (its padding is zero)."""
        return torch.stack(torch._foreach_norm(self._leaf_views(flat), ord))

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

    def state_keys(self) -> List[str]:
        """The keys ``state_arrays`` returns, without copying state."""
        keys = ['count', 'learning_rate']
        for slot, buf in self.slots().items():
            keys += [slot] if buf.ndim == 0 else [f'{slot}.{n}' for n in self._cover(slot)]
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
