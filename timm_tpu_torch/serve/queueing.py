"""Continuous-batching admission queue (a copy of timm_tpu/serve/queueing.py,
which the port keeps as its own so that it imports nothing of the JAX
package).

Requests arrive one at a time (open-loop traffic); the device steps over
bucket-shaped batches. This queue decouples the two: arrivals append to a
per-model FIFO, and the engine's scheduler asks for the next ADMISSION — a
(model, requests) run that is ready to step. A model's pending run is ready
when any of:

  * it can fill the LARGEST declared bucket (throughput-optimal), or
  * its oldest request's deadline (submit time + max_wait) has expired —
    the run is admitted PARTIAL into the smallest bucket that fits, padded
    with masked slots, so no request ever starves waiting for a full batch, or
  * the queue is draining (shutdown flushes everything immediately).

Among ready models the one whose oldest request has waited longest goes
first (global FIFO fairness across models).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

__all__ = ['ServeFuture', 'ServeRequest', 'RequestQueue']


class ServeFuture:
    """Completion handle for one submitted request (threading, not asyncio:
    the engine's scheduler is a thread and callers may be WSGI workers)."""

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.done_at: Optional[float] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError('serve request not completed within timeout')
        if self._exc is not None:
            raise self._exc
        return self._result

    def _set_result(self, value):
        self._result = value
        self.done_at = time.perf_counter()
        self._done.set()

    def _set_exception(self, exc: BaseException):
        self._exc = exc
        self.done_at = time.perf_counter()
        self._done.set()


class ServeRequest:
    __slots__ = ('id', 'model', 'image', 'submit_t', 'deadline', 'future')

    def __init__(self, rid: int, model: str, image, submit_t: float, deadline: float):
        self.id = rid
        self.model = model
        self.image = image
        self.submit_t = submit_t
        self.deadline = deadline
        self.future = ServeFuture()


class RequestQueue:
    """Thread-safe admission queue. ``submit`` is called from request
    threads; ``wait_admission`` blocks the scheduler until a run is ready
    (or the timeout/next-deadline passes)."""

    def __init__(self, max_bucket: int, max_wait_s: float = 0.010,
                 max_pending: int = 10_000):
        self.max_bucket = int(max_bucket)
        self.max_wait_s = float(max_wait_s)
        self.max_pending = int(max_pending)
        self._cond = threading.Condition()
        self._pending: 'OrderedDict[str, deque[ServeRequest]]' = OrderedDict()
        self._n_pending = 0
        self._ids = itertools.count()
        self._closed = False
        self._draining = False

    # -- producer side --------------------------------------------------------

    def submit(self, model: str, image, now: Optional[float] = None) -> ServeFuture:
        now = time.perf_counter() if now is None else now
        with self._cond:
            if self._closed:
                raise RuntimeError('serve queue is shut down; no new requests accepted')
            if self._n_pending >= self.max_pending:
                raise RuntimeError(
                    f'serve queue over capacity ({self._n_pending} pending >= '
                    f'max_pending={self.max_pending}); shed load upstream')
            req = ServeRequest(next(self._ids), model, image, now, now + self.max_wait_s)
            self._pending.setdefault(model, deque()).append(req)
            self._n_pending += 1
            self._cond.notify_all()
            return req.future

    # -- scheduler side -------------------------------------------------------

    def __len__(self) -> int:
        with self._cond:
            return self._n_pending

    def pending(self, model: str) -> int:
        with self._cond:
            return len(self._pending.get(model, ()))

    def finished(self) -> bool:
        """True once the queue is closed and fully drained (scheduler exit)."""
        with self._cond:
            return self._closed and self._n_pending == 0

    def _ready_model(self, now: float) -> Optional[str]:
        """Oldest-first among models whose run is ready (locked)."""
        best, best_t = None, None
        for model, q in self._pending.items():
            if not q:
                continue
            head = q[0]
            if self._draining or len(q) >= self.max_bucket or head.deadline <= now:
                if best_t is None or head.submit_t < best_t:
                    best, best_t = model, head.submit_t
        return best

    def _next_deadline(self) -> Optional[float]:
        heads = [q[0].deadline for q in self._pending.values() if q]
        return min(heads) if heads else None

    def wait_admission(self, timeout: Optional[float] = None
                       ) -> Optional[Tuple[str, List[ServeRequest]]]:
        """Block until a run is ready and pop it: up to ``max_bucket``
        requests of one model, oldest model first. Returns None when the
        timeout expires with nothing ready (the engine uses those gaps to
        retire in-flight device steps)."""
        end = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while True:
                now = time.perf_counter()
                model = self._ready_model(now)
                if model is not None:
                    q = self._pending[model]
                    take = min(len(q), self.max_bucket)
                    reqs = [q.popleft() for _ in range(take)]
                    self._n_pending -= take
                    return model, reqs
                if self._closed and self._n_pending == 0:
                    return None
                # sleep until a new arrival, the nearest deadline, or timeout
                waits = []
                if end is not None:
                    waits.append(end - now)
                nd = self._next_deadline()
                if nd is not None:
                    waits.append(nd - now)
                if end is not None and now >= end:
                    return None
                self._cond.wait(timeout=min(waits) if waits else None)
                if end is not None and time.perf_counter() >= end and \
                        self._ready_model(time.perf_counter()) is None:
                    return None

    # -- shutdown -------------------------------------------------------------

    def drain(self):
        """Flush: every pending run becomes immediately ready (partial
        buckets allowed) regardless of deadline."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def close(self, drain: bool = True):
        with self._cond:
            self._closed = True
            self._draining = self._draining or drain
            if not drain:
                failed = [r for q in self._pending.values() for r in q]
                self._pending.clear()
                self._n_pending = 0
            else:
                failed = []
            self._cond.notify_all()
        for r in failed:
            r.future._set_exception(RuntimeError('serve queue shut down without drain'))
