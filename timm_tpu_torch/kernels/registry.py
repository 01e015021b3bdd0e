# no-kernel-registry: infrastructure module — the registry itself, not a kernel
"""Kernel registry: every hand-written kernel of the port declares, as data,
its plain version, its regime and its tolerance (counterpart of
``timm_tpu/kernels/registry.py``).

A registered kernel carries (a) a **plain PyTorch version**, the parity
oracle and the A/B baseline, (b) a **declared regime**: the shapes and
dtypes where it runs, split into a ``dry`` arm (tiny, runs on the CPU in
the tests) and a ``live`` arm (the main path's shapes, decided on the card),
and (c) a **parity tolerance**, the JAX registry's. ``harness.py`` consumes
these specs for the parity grid, the bounds and the keep/delete verdict
lines; an unregistered module in ``kernels/`` fails
``tests/test_torch_kernels.py``.

Beyond the JAX spec, a port spec may say how many operations the function
does (``flops``), so that its least time on the card comes from the
registry (``roofline``), and which single PyTorch call computes the same
function (``library_fn``), timed beside the kernel and used nowhere else,
and how far the two may differ element by element (``error_bound``), where
a tolerance scaled to each output holds the kernel tighter on the card than
the JAX registry's one ``parity_tol``.

Kernel modules register themselves at import time; ``ensure_registered()``
imports the portfolio so that a consumer never sees a half-filled table.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ['KernelCase', 'KernelSpec', 'PEAK_BYTES_PER_S', 'PEAK_OPS_PER_S', 'all_specs',
           'default_io_bytes', 'ensure_registered', 'get', 'kernel_names', 'launch_counters',
           'register', 'roofline', 'unregister']

# modules whose import fills the registry (the portfolio)
_PORTFOLIO = ('flash_attention', 'fused_adamw', 'augment_epilogue')

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit):
# device memory, and operations by the type they run in (fp32 outside the
# tensor cores, no TF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'bfloat16': 989e12, 'float16': 989e12, 'float32': 67e12}


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One point of a kernel's declared regime. ``dry`` and ``live`` are
    keyword arguments of the spec's ``make_inputs``: the same runner at two
    scales, dry tiny and CPU-provable, live the main path's shapes that the
    card decides on. ``statics`` go to the kernel, the plain version and the
    library call alike (dtypes, coefficients)."""
    name: str
    dry: Dict = dataclasses.field(default_factory=dict)
    live: Dict = dataclasses.field(default_factory=dict)
    statics: Dict = dataclasses.field(default_factory=dict)
    desc: str = ''


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A registered kernel: implementation, plain version and regime.

    ``kernel_fn`` and ``reference_fn`` share one signature, ``fn(**inputs,
    **case.statics)`` with ``inputs = make_inputs(seed=..., device=...,
    **case.dry)`` (or ``.live``), and are functional: outputs are a tensor or
    a tuple, list or dict of tensors, compared leaf for leaf. A kernel that
    updates in place gives its in-place calls as ``kernel_step`` and
    ``reference_step``; the A/B times those, so the copies that make the
    functional forms stay out of the timed region.

    ``make_inputs(seed=0, device='cuda', **case_kwargs)`` draws with numpy
    from the seed and returns tensors on ``device`` (and plain Python values
    the function takes, such as a learning rate). ``flops(**inputs,
    **statics)`` returns (operations, the type they run in: a key of
    ``PEAK_OPS_PER_S``) for these inputs, counting what their data needs.
    ``library_fn(**inputs, **statics)`` sets up the one PyTorch call that
    computes the same function and returns it as a thunk, or None where
    there is none for this case. ``error_bound(out, **inputs, **statics)``
    returns, from the plain version's output, a tensor that bounds
    |kernel - plain| element by element (broadcast to the one output leaf);
    parity then also holds every element within it. ``backends`` are the
    device types where the verdict is decided; off them it is ``pending``
    and parity is still measured."""
    name: str
    module: str                      # the python module the lint checks off
    regime: str                      # prose: where the kernel runs
    gate: str                        # the keep-or-delete sentence
    parity_tol: float
    kernel_fn: Callable
    reference_fn: Callable
    make_inputs: Callable
    cases: Tuple[KernelCase, ...]
    backends: Tuple[str, ...] = ('cuda',)
    flops: Optional[Callable] = None
    library_fn: Optional[Callable] = None
    error_bound: Optional[Callable] = None
    kernel_step: Optional[Callable] = None
    reference_step: Optional[Callable] = None

    def __post_init__(self):
        if not self.cases:
            raise ValueError(f'kernel {self.name!r}: declared regime is empty '
                             '(at least one KernelCase required)')
        if not (self.parity_tol > 0):
            raise ValueError(f'kernel {self.name!r}: parity_tol must be > 0')


_REGISTRY: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f'kernel {spec.name!r} already registered')
    _REGISTRY[spec.name] = spec
    return spec


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def ensure_registered() -> None:
    """Import the portfolio modules (idempotent) so that every kernel's
    import-time registration has run before the registry is read."""
    for mod in _PORTFOLIO:
        importlib.import_module(f'{__package__}.{mod}')


def get(name: str) -> KernelSpec:
    ensure_registered()
    if name not in _REGISTRY:
        raise KeyError(f'kernel {name!r} not registered (have: {sorted(_REGISTRY)})')
    return _REGISTRY[name]


def all_specs() -> Tuple[KernelSpec, ...]:
    ensure_registered()
    return tuple(_REGISTRY[name] for name in sorted(_REGISTRY))


def kernel_names() -> Tuple[str, ...]:
    ensure_registered()
    return tuple(sorted(_REGISTRY))


def launch_counters() -> Dict[str, Callable]:
    """{kernel name: the wrapper of that name in its module, whose
    ``launches`` counts the kernel's launches}."""
    return {spec.name: getattr(importlib.import_module(spec.module), spec.name)
            for spec in all_specs()}


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [leaf for v in out.values() for leaf in _leaves(v)]
    if isinstance(out, (tuple, list)):
        return [leaf for v in out for leaf in _leaves(v)]
    return []


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(out))


def default_io_bytes(spec: KernelSpec, case: KernelCase, inputs: Optional[Dict] = None,
                     seed: int = 0) -> int:
    """Bytes of one call that device memory must carry at least: every
    input tensor read once and every output written once. The outputs are
    sized without running the kernel: the plain version runs on ``meta``
    copies of the inputs (the case's dry arm on the CPU by default)."""
    if inputs is None:
        inputs = spec.make_inputs(seed=seed, device='cpu', **case.dry)
    meta = {k: v.to('meta') if isinstance(v, torch.Tensor) else v for k, v in inputs.items()}
    return _nbytes(inputs) + _nbytes(spec.reference_fn(**meta, **case.statics))


def roofline(spec: KernelSpec, case: KernelCase, inputs: Optional[Dict] = None,
             seed: int = 0) -> Dict:
    """The least time the card could take for one call, ``bound_ms``: the
    larger of the bytes over device memory's rate and the operations over
    the peak rate of their type, with which of the two bounds it."""
    if inputs is None:
        inputs = spec.make_inputs(seed=seed, device='cpu', **case.dry)
    io = default_io_bytes(spec, case, inputs)
    t_bytes = io / PEAK_BYTES_PER_S * 1e3
    ops, t_ops = 0, 0.0
    if spec.flops is not None:
        ops, kind = spec.flops(**inputs, **case.statics)
        t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {'io_bytes': int(io), 'flops': int(ops), 'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}
