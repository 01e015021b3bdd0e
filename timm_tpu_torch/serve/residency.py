"""Multi-model residency: a memory-budgeted LRU pool on one device
(counterpart of timm_tpu/serve/residency.py; mesh sharding and int8 wait).

The pool builds models lazily from registered factories, moves them to its
``torch.device`` in eval mode with gradients off, hands each new resident to
the engine's prewarm hook, and evicts the least-recently-used resident when
the budget would be exceeded. A model's bytes are counted from its
parameters and buffers. A single model larger than the whole budget is kept
with a warning rather than evicted in a loop.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

_logger = logging.getLogger(__name__)

__all__ = ['ResidentModel', 'ModelPool', 'module_bytes']


def module_bytes(model: nn.Module) -> int:
    """Device bytes of a module's parameters and buffers."""
    tensors = list(model.parameters()) + list(model.buffers())
    return int(sum(t.numel() * t.element_size() for t in tensors))


class ResidentModel:
    """One loaded model and what the engine records at prewarm."""

    def __init__(self, name: str, model: nn.Module, param_bytes: int,
                 input_size: Tuple[int, int, int]):
        self.name = name
        self.model = model
        self.param_bytes = int(param_bytes)
        self.input_size = input_size  # (H, W, C) the warmed buckets expect
        self.prewarm_stats: Dict[str, object] = {}


class ModelPool:
    """LRU residency over lazily built models on one device.

    ``register(name, factory)`` declares how to build a model (it is NOT
    loaded yet); ``acquire(name)`` returns the resident entry, loading and
    evicting as needed. ``prewarm_fn`` runs once per load, before the model
    serves its first request.
    """

    def __init__(self, device: torch.device, budget_bytes: Optional[int] = None,
                 prewarm_fn: Optional[Callable[[ResidentModel], None]] = None):
        self.device = torch.device(device)
        self.budget_bytes = budget_bytes
        self.prewarm_fn = prewarm_fn
        self._factories: Dict[str, Tuple[Callable[[], nn.Module], Optional[Tuple[int, int, int]]]] = {}
        self._resident: 'OrderedDict[str, ResidentModel]' = OrderedDict()
        self._lock = threading.RLock()
        self.stats = {'loads': 0, 'evictions': 0, 'hits': 0}

    def register(self, name: str, factory: Callable[[], nn.Module], input_size=None):
        """``input_size``: the (H, W, C) requests will have; resolved from the
        model's default_cfg when omitted."""
        with self._lock:
            self._factories[name] = (factory, input_size)

    @property
    def registered(self):
        return tuple(self._factories)

    @property
    def resident_names(self):
        with self._lock:
            return tuple(self._resident)

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(r.param_bytes for r in self._resident.values())

    def acquire(self, name: str) -> ResidentModel:
        with self._lock:
            res = self._resident.get(name)
            if res is not None:
                self._resident.move_to_end(name)
                self.stats['hits'] += 1
                return res
            if name not in self._factories:
                raise KeyError(f'model {name!r} not registered with the serve pool '
                               f'(registered: {list(self._factories)})')
            return self._load(name)

    def _load(self, name: str) -> ResidentModel:
        t0 = time.perf_counter()
        factory, input_size = self._factories[name]
        model = factory().to(self.device).eval().requires_grad_(False)
        if input_size is None:
            cfg = getattr(model, 'default_cfg', None) or {}
            chw = cfg.get('input_size') or (3, 224, 224)
            input_size = (int(chw[1]), int(chw[2]), int(chw[0]))  # CHW cfg -> HWC input
        nbytes = module_bytes(model)
        self._evict_to_fit(nbytes, loading=name)
        res = ResidentModel(name, model, nbytes, tuple(int(s) for s in input_size))
        res.prewarm_stats['load_ms'] = (time.perf_counter() - t0) * 1e3
        if self.prewarm_fn is not None:
            self.prewarm_fn(res)
        self._resident[name] = res
        self.stats['loads'] += 1
        _logger.info(f'serve pool: loaded {name} ({nbytes / 1e6:.1f} MB, '
                     f'{len(self._resident)} resident on {self.device})')
        return res

    def _evict_to_fit(self, incoming_bytes: int, loading: str):
        if self.budget_bytes is None:
            return
        if incoming_bytes > self.budget_bytes:
            _logger.warning(
                f'serve pool: model {loading!r} alone ({incoming_bytes / 1e6:.1f} MB) exceeds '
                f'the memory budget ({self.budget_bytes / 1e6:.1f} MB); keeping it resident anyway')
        while self._resident and self.resident_bytes() + incoming_bytes > self.budget_bytes:
            victim, res = self._resident.popitem(last=False)  # LRU order
            self.stats['evictions'] += 1
            _logger.info(f'serve pool: evicted {victim} ({res.param_bytes / 1e6:.1f} MB) '
                         f'to fit {loading} within the {self.budget_bytes / 1e6:.1f} MB budget')
