"""Compiled steps: one CUDA graph per input signature, the port's
counterpart of ``jax.jit``.

``StepGraphs(fn, device)`` wraps a step ``fn(tensors, *statics)`` whose
``tensors`` is a dict of tensors and whose ``statics`` are hashable. The
key of a call is what ``jax.jit`` re-specializes on: each tensor's name,
shape and dtype, and the statics. On CUDA the first call of a key copies
its tensors into static input buffers and runs ``fn`` eagerly on the
helper's side stream (the warm-up: it builds the kernel libraries, creates
cuBLAS's handles and workspaces, and is a real step); the second call
captures ``fn`` into a graph (a capture runs no kernel) and replays it;
every later call copies into the static inputs and replays. So every call
is exactly one step. A capture that fails raises with the reason: there is
no eager fallback on the card. On the CPU ``fn`` runs eagerly on the
tensors as given.

* Inputs. NumPy arrays and CPU tensors reach the static inputs through
  pinned host memory (``non_blocking``; the caching host allocator keeps a
  block until its copy is done); device tensors by a device copy. All of it
  runs on the caller's current stream, as the replay and the clones do.
* Outputs are **clones** of the static outputs: the next replay overwrites
  those, and a caller may keep many steps' results before reading them.
* Memory. The graphs of one ``StepGraphs`` share one memory pool;
  ``pool_bytes()`` is what its segments hold. Captures forbid unsafe CUDA
  calls on the capturing thread only (``capture_error_mode=
  'thread_local'``), so a loader or scheduler thread may go on meanwhile.
* Random numbers. The generators that ``generators()`` returns at a
  capture (the drop-path / dropout generator) are registered with its graph, so each replay draws new numbers and
  advances each generator's state exactly as an eager call does.
* A replay runs no Python: the kernel wrappers' launch counters move at the
  warm-up and the capture only. Count what replays run with the profiler.

State that ``fn`` updates in place (parameters, optimizer buffers,
counters) must keep its storage: a graph holds device addresses.
``clear()`` drops the graphs, as JAX drops a jitted step whose static
configuration changed.
"""
from __future__ import annotations

import inspect
import weakref
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ['StepGraphs', 'pool_bytes']


def pool_bytes(pool) -> int:
    """Device bytes of the caching allocator's segments that belong to the
    graph memory pool ``pool`` (its id is unique in the process)."""
    return sum(seg['total_size'] for seg in torch.cuda.memory_snapshot()
               if tuple(seg['segment_pool_id']) == tuple(pool))


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(v) for v in out)
    return out


class _Entry:
    __slots__ = ('static_in', 'graph', 'static_out')

    def __init__(self, static_in: Dict[str, torch.Tensor]):
        self.static_in = static_in
        self.graph = None
        self.static_out = None


class StepGraphs:
    """See module docstring."""

    def __init__(self, fn: Callable, device,
                 generators: Callable[[], Sequence[Optional[torch.Generator]]] = tuple):
        self._fn = _weak(fn)
        self.device = torch.device(device)
        self._generators = _weak(generators)  # called at each capture
        self._entries: Dict[Hashable, _Entry] = {}
        self._pool = None
        self._stream = None
        self.captures = 0
        self.replays = 0

    def clear(self) -> None:
        self._entries.clear()
        self._pool = None

    def pool_bytes(self) -> int:
        """Device bytes the graphs' shared pool holds (0 before a capture)."""
        return 0 if self._pool is None else pool_bytes(self._pool)

    def static_bytes(self) -> int:
        """Device bytes of the static input buffers."""
        return sum(t.numel() * t.element_size() for e in self._entries.values()
                   for t in e.static_in.values())

    def __call__(self, tensors: Dict[str, Any], *statics: Hashable):
        if self.device.type != 'cuda':
            return _clone(self._fn()({k: torch.as_tensor(v).to(self.device)
                                      for k, v in tensors.items()}, *statics))
        key = (tuple((k, tuple(v.shape), _torch_dtype(v)) for k, v in sorted(tensors.items())),
               statics)
        entry = self._entries.get(key)
        current = torch.cuda.current_stream(self.device)
        if entry is None:
            entry = _Entry({k: torch.empty(tuple(v.shape), dtype=_torch_dtype(v), device=self.device)
                            for k, v in tensors.items()})
            self._stage(entry, tensors)
            out = self._on_side_stream(current,
                                       lambda: _clone(self._fn()(entry.static_in, *statics)))
            self._entries[key] = entry
            return out
        self._stage(entry, tensors)
        if entry.graph is None:
            self._capture(entry, statics, current)
        entry.graph.replay()
        self.replays += 1
        return _clone(entry.static_out)

    def _stage(self, entry: _Entry, tensors: Dict[str, Any]) -> None:
        for k, v in tensors.items():
            src = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
            if src.device.type == 'cpu':
                src = src.pin_memory()
            entry.static_in[k].copy_(src, non_blocking=True)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _on_side_stream(self, current, fn):
        side = self._side_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        return out

    def _capture(self, entry: _Entry, statics: Tuple, current) -> None:
        graph = torch.cuda.CUDAGraph()
        generators = [g for g in self._generators()() if g is not None]
        if generators and not hasattr(graph, 'register_generator_state'):
            raise RuntimeError(
                f'torch {torch.__version__} has no CUDAGraph.register_generator_state: a graph '
                'of a step that draws random numbers from its own generator cannot be captured')
        for g in generators:
            graph.register_generator_state(g)
        side = self._side_stream()
        side.wait_stream(current)
        with torch.cuda.graph(graph, pool=self._pool, stream=side,
                              capture_error_mode='thread_local'):
            static_out = self._fn()(entry.static_in, *statics)
        current.wait_stream(side)
        if self._pool is None:
            self._pool = graph.pool()
        entry.graph, entry.static_out = graph, static_out
        self.captures += 1


def _weak(fn: Callable) -> Callable[[], Callable]:
    """A callable that gives ``fn`` back; for a bound method, through a weak
    reference, so that the object owning the graphs (whose step is the
    method) is not kept alive by them, and its graphs' memory goes with it."""
    if inspect.ismethod(fn):
        return weakref.WeakMethod(fn)
    return lambda: fn


def _torch_dtype(v) -> torch.dtype:
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.zeros(0, dtype=np.asarray(v).dtype)).dtype
