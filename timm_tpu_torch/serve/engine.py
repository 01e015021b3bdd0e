"""Continuous-batching inference engine over bucketed batch shapes
(counterpart of timm_tpu/serve/engine.py).

  * Requests land in a :class:`~timm_tpu_torch.serve.queueing.RequestQueue`;
    the scheduler thread admits runs of up to the largest declared bucket —
    full buckets at once, partial buckets when the oldest request's deadline
    expires, so no request starves waiting for batch-mates.
  * Every admitted run is padded to the smallest fitting bucket, and the
    engine asserts that only declared buckets dispatch, so the kernels see a
    fixed family of shapes.
  * **One CUDA graph per (model, bucket)**, captured at ``add_model`` (the
    prewarm, timed in ``stats['prewarm']``): the counterpart of the JAX
    engine's AOT bucket executables. Each bucket gets a static input
    buffer; warm-up forwards on a side stream build the kernels and create
    cuBLAS's handles and workspaces; then one forward is captured, into a
    memory pool that the buckets of a model share. A step copies its padded
    batch into the bucket's static input, replays the graph and clones the
    static output, all on the stream that replays, so a second step of the
    bucket in flight cannot overwrite the first's output before its clone.
    One replay is one launch for the whole forward. A shape outside the
    captured ones raises, as an AOT executable does. A replay runs no
    Python, so the kernels' launch counters move at capture only; each
    graph records what its capture launched (``BucketGraph.launches``, the
    kernels one replay runs) and the engine counts replays per bucket
    (``stats['replays_by_bucket']``). A capture holds its own thread only
    (``capture_error_mode='thread_local'``), so a model may be added from
    the caller's thread while the scheduler serves. The memory the graphs
    keep (their pool and static inputs) is measured at prewarm and counted
    in the model's bytes against the pool's budget. The graphs hold the
    weights' device addresses and live and die with the
    :class:`~timm_tpu_torch.serve.residency.ResidentModel`: an evicted
    model is captured anew when it is loaded again, and weights loaded into
    a resident model must be copied in place (``load_state_dict``, as
    ``load_jax_state_dict`` does). A capture that fails raises: on the card
    the engine never runs a bucket eagerly. With ``device='cpu'`` the
    engine stays eager, and its prewarm runs one forward per bucket.
  * Up to ``transfer_depth`` steps are in flight: a batch is uploaded from
    pinned host memory with ``non_blocking=True`` and its forward is queued
    while the device still runs the previous one; a step retires when its
    logits come back with ``.cpu()``.
  * Several models stay resident through a memory-budgeted LRU
    :class:`~timm_tpu_torch.serve.residency.ModelPool`.

The engine runs on ``cuda`` unless built with ``device='cpu'``. Its
forward passes, captures and replays run under ``torch.inference_mode()``,
set inside the scheduler thread because grad mode is thread-local.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import Counter, deque
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import _build, registry
from ..utils.cuda_graph import pool_bytes
from .bucketing import DEFAULT_BUCKETS, pad_rows, select_bucket, strip_rows, validate_buckets
from .queueing import RequestQueue, ServeFuture
from .residency import ModelPool, ResidentModel

_logger = logging.getLogger(__name__)

__all__ = ['InferenceEngine']


class BucketGraph:
    """One captured forward of a model at one bucket: the graph, its static
    input and output, and the kernel launches its capture counted, which
    are the kernels one replay runs."""

    def __init__(self, graph: torch.cuda.CUDAGraph, static_in: torch.Tensor,
                 static_out: torch.Tensor, launches: Dict[str, int]):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """Copy ``x`` (pinned host or device memory) into the static input,
        replay and return a clone of the output, on the current stream."""
        if tuple(x.shape) != tuple(self.static_in.shape):
            raise ValueError(f'Input shape {tuple(x.shape)} is not the captured '
                             f'{tuple(self.static_in.shape)}: only declared buckets run')
        self.static_in.copy_(x, non_blocking=True)
        self.graph.replay()
        return self.static_out.clone()


class _Inflight:
    __slots__ = ('out', 'requests')

    def __init__(self, out, requests):
        self.out = out
        self.requests = requests


class InferenceEngine:
    """See module docstring. Typical use::

        engine = InferenceEngine(buckets=(1, 4, 16, 64), max_wait_ms=5.0)
        engine.add_model('vit_base_patch16_224', dtype=torch.bfloat16)
        engine.start()
        future = engine.submit(image)           # (H, W, C) float32, normalized
        logits = future.result(timeout=1.0)     # (num_classes,) float32
        engine.shutdown(drain=True)
    """

    def __init__(
            self,
            buckets: Sequence[int] = DEFAULT_BUCKETS,
            max_wait_ms: float = 10.0,
            device=None,
            transfer_depth: int = 2,
            memory_budget_bytes: Optional[int] = None,
            max_pending: int = 10_000,
    ):
        self.device = resolve_device(device)
        self.buckets = validate_buckets(buckets)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.transfer_depth = max(1, int(transfer_depth))
        self._queue = RequestQueue(max_bucket=self.buckets[-1], max_wait_s=self.max_wait_s,
                                   max_pending=max_pending)
        self.pool = ModelPool(self.device, budget_bytes=memory_budget_bytes,
                              prewarm_fn=self._prewarm)
        self._inflight: 'deque[_Inflight]' = deque()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self.stats: Dict = {
            'submitted': 0, 'completed': 0, 'failed': 0, 'steps': 0,
            'padded_slots': 0, 'steps_by_bucket': Counter(), 'replays_by_bucket': Counter(),
            'request_sizes': Counter(),   # dispatched-batch size histogram
            'prewarm': {}, 'max_inflight': 0,
        }

    # -- model registration / prewarm -----------------------------------------

    def add_model(self, name: str, factory=None, input_size: Optional[Tuple[int, int, int]] = None,
                  prewarm: bool = True, **model_kwargs) -> None:
        """Register ``name`` with the residency pool. ``factory`` overrides the
        default ``timm_tpu_torch.create_model(name, device=<engine device>,
        **model_kwargs)``. ``prewarm=True`` loads the model and runs every
        bucket once now; otherwise the first request pays it."""
        if factory is None:
            def factory():
                from ..models import create_model
                return create_model(name, device=self.device, **model_kwargs)
        if input_size is None and 'img_size' in model_kwargs:
            s = int(model_kwargs['img_size'])
            input_size = (s, s, 3)
        self.pool.register(name, factory, input_size=input_size)
        if prewarm:
            self.pool.acquire(name)

    def _run(self, res: ResidentModel, x: torch.Tensor) -> torch.Tensor:
        return res.model(x).float()

    def _prewarm(self, res: ResidentModel) -> None:
        """Every declared bucket of a freshly loaded model, timed to
        completion on the device: on cuda its graph is captured; on the CPU
        one eager forward runs. ``cache_hits`` and ``fresh_compiles`` count
        the kernel libraries loaded during the prewarm that were already
        built and that ``nvcc`` built. ``graph_bytes`` is the device memory
        the graphs keep: their pool's segments and the static inputs."""
        h, w, c = res.input_size
        bucket_ms = {}
        loaded = set(_build.loaded_libraries())
        t0 = time.perf_counter()
        with torch.inference_mode():
            pool = torch.cuda.graph_pool_handle() if self.device.type == 'cuda' else None
            for bucket in self.buckets:
                tb = time.perf_counter()
                x = torch.zeros((bucket, h, w, c), device=self.device)
                if pool is None:
                    self._run(res, x).cpu()
                else:
                    res.compiled[bucket] = self._capture(res, x, pool)
                bucket_ms[bucket] = (time.perf_counter() - tb) * 1e3
            if pool is not None:
                torch.cuda.synchronize(self.device)
                res.graph_bytes = pool_bytes(pool) + sum(
                    g.static_in.numel() * g.static_in.element_size() for g in res.compiled.values())
        new = [lib for key, lib in _build.loaded_libraries().items() if key not in loaded]
        stats = {'programs': len(res.compiled) if pool is not None else len(self.buckets),
                 'mode': 'graph' if pool is not None else 'eager',
                 'ms': (time.perf_counter() - t0) * 1e3, 'bucket_ms': bucket_ms,
                 'graph_bytes': res.graph_bytes,
                 'cache_hits': sum(not lib.built for lib in new),
                 'fresh_compiles': sum(lib.built for lib in new)}
        res.prewarm_stats.update(stats)
        self.stats['prewarm'][res.name] = stats

    def _capture(self, res: ResidentModel, static_in: torch.Tensor, pool) -> BucketGraph:
        """Warm up on a side stream, then capture one forward into ``pool``.
        The capture forbids unsafe CUDA calls on this thread only, so the
        scheduler thread may go on retiring steps meanwhile."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._run(res, static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        counters = registry.launch_counters()
        before = {name: fn.launches for name, fn in counters.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, capture_error_mode='thread_local'):
            static_out = self._run(res, static_in)
        launches = {name: fn.launches - before[name] for name, fn in counters.items()
                    if fn.launches != before[name]}
        return BucketGraph(graph, static_in, static_out, launches)

    def aot_executables(self, model: str) -> Dict[int, BucketGraph]:
        """bucket -> captured graph of ``model`` while it is resident (empty
        on the CPU, where the engine runs eagerly)."""
        return dict(self.pool.acquire(model).compiled)

    # -- request path ---------------------------------------------------------

    def submit(self, image, model: Optional[str] = None) -> ServeFuture:
        """Enqueue one image; returns a future resolving to its logits row."""
        if not self._started:
            raise RuntimeError('InferenceEngine.submit before start(); call start() first')
        if model is None:
            registered = self.pool.registered
            if len(registered) != 1:
                raise ValueError(
                    f'model= is required when {len(registered)} models are registered '
                    f'({list(registered)})')
            model = registered[0]
        future = self._queue.submit(model, image)
        self.stats['submitted'] += 1
        return future

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> 'InferenceEngine':
        if self._started:
            return self
        self._started = True
        self._thread = threading.Thread(target=self._loop, name='serve-scheduler', daemon=True)
        self._thread.start()
        return self

    def shutdown(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Stop the engine. ``drain=True`` completes every pending and
        in-flight request first; ``drain=False`` fails pending requests and
        completes only the in-flight steps."""
        if not self._started:
            return
        self._queue.close(drain=drain)
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(f'serve scheduler failed to drain within {timeout}s at shutdown')
            self._thread = None
        self._started = False

    # -- scheduler ------------------------------------------------------------

    def _loop(self) -> None:
        with torch.inference_mode():
            try:
                while True:
                    # with steps in flight, poll briefly so retirement
                    # interleaves with admission; otherwise block until work,
                    # a deadline, or shutdown
                    timeout = 0.0005 if self._inflight else None
                    admission = self._queue.wait_admission(timeout=timeout)
                    if admission is None:
                        if self._inflight:
                            self._retire(self._inflight.popleft())
                            continue
                        if self._queue.finished():
                            break
                        continue
                    self._dispatch(*admission)
                    while len(self._inflight) >= self.transfer_depth:
                        self._retire(self._inflight.popleft())
            finally:
                while self._inflight:
                    self._retire(self._inflight.popleft())

    def _dispatch(self, model_name: str, requests) -> None:
        try:
            res = self.pool.acquire(model_name)
            bucket = select_bucket(len(requests), self.buckets)
            x = np.stack([np.asarray(r.image, dtype=np.float32) for r in requests])
            x, _valid = pad_rows(x, bucket)
            # hard guarantee: only declared bucket shapes are dispatched
            assert x.shape[0] in self.buckets, \
                f'batch shape {x.shape[0]} outside declared buckets {self.buckets}'
            x_host = torch.from_numpy(x)
            if self.device.type == 'cuda':
                # asynchronous upload from pinned memory, then the replay,
                # on one stream: overlaps the running step
                out = res.compiled[bucket].run(x_host.pin_memory())
                self.stats['replays_by_bucket'][bucket] += 1
            else:
                out = self._run(res, x_host)
            self._inflight.append(_Inflight(out, requests))
            self.stats['steps'] += 1
            self.stats['steps_by_bucket'][bucket] += 1
            self.stats['request_sizes'][len(requests)] += 1
            self.stats['padded_slots'] += bucket - len(requests)
            self.stats['max_inflight'] = max(self.stats['max_inflight'], len(self._inflight))
        except Exception as e:
            _logger.exception(f'serve dispatch failed for {model_name} x{len(requests)}: {e}')
            for r in requests:
                r.future._set_exception(e)
            self.stats['failed'] += len(requests)

    def _retire(self, item: _Inflight) -> None:
        try:
            logits = item.out.cpu().numpy()  # waits for the device step
            logits = strip_rows(logits, len(item.requests))
            for i, r in enumerate(item.requests):
                r.future._set_result(logits[i])
            self.stats['completed'] += len(item.requests)
        except Exception as e:
            _logger.exception(f'serve step failed at retirement: {e}')
            for r in item.requests:
                r.future._set_exception(e)
            self.stats['failed'] += len(item.requests)

    # -- introspection --------------------------------------------------------

    def pending(self) -> int:
        return len(self._queue)

    def snapshot_stats(self) -> Dict:
        """Point-in-time copy of engine and pool counters."""
        out = dict(self.stats)
        out['steps_by_bucket'] = dict(self.stats['steps_by_bucket'])
        out['replays_by_bucket'] = dict(self.stats['replays_by_bucket'])
        out['request_sizes'] = dict(self.stats['request_sizes'])
        out['pool'] = dict(self.pool.stats)
        out['resident'] = list(self.pool.resident_names)
        return out
