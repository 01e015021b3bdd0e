"""Reader retry policy: jittered exponential backoff + poison-sample budget
(copy of timm_tpu/resilience/retry.py).

Transient faults (OSError/IOError from network filesystems, GCS fuse mounts,
flaky tar reads) are retried with jittered exponential backoff. Permanent
per-sample faults (undecodable images, malformed records) are SKIPPED against
a bounded budget — replacing the previous behaviour where a single bad sample
either killed the epoch or was silently swallowed.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

_logger = logging.getLogger(__name__)

__all__ = ['retry_io', 'backoff_delays', 'SkipBudget', 'TooManyBadSamples',
           'DEFAULT_POISON_BUDGET']

# env TIMM_TPU_POISON_BUDGET: max permanently-bad samples tolerated per
# loader pass before the run aborts (a corrupt dataset should fail loudly)
DEFAULT_POISON_BUDGET = 16


class TooManyBadSamples(RuntimeError):
    """The poison-sample skip budget was exhausted; the dataset (not a
    transient fault) is broken and the run must stop."""


def backoff_delays(retries: int, base_delay: float, max_delay: float, jitter: float,
                   rng: Optional[random.Random] = None):
    """Yield `retries` jittered exponential delays: base*2^i * U[1-j, 1+j]."""
    rng = rng or random
    for i in range(retries):
        d = min(base_delay * (2 ** i), max_delay)
        yield max(0.0, d * (1.0 + jitter * (2.0 * rng.random() - 1.0)))


def retry_io(
        fn: Callable,
        retries: int = 3,
        base_delay: float = 0.05,
        max_delay: float = 2.0,
        jitter: float = 0.5,
        retry_on: Tuple[Type[BaseException], ...] = (OSError,),
        desc: str = '',
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
):
    """Call `fn()`; on a transient (`retry_on`) exception, back off and retry
    up to `retries` times. The final failure re-raises. Non-transient
    exceptions propagate immediately (those are poison, not flakiness)."""
    delays = backoff_delays(retries, base_delay, max_delay, jitter, rng)
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            try:
                delay = next(delays)
            except StopIteration:
                raise e
            _logger.warning(
                f'Transient I/O error{f" ({desc})" if desc else ""}: {e!r}; '
                f'retry {attempt}/{retries} in {delay:.2f}s')
            sleep(delay)


class SkipBudget:
    """Thread-safe poison-sample budget. `record` logs the skip and raises
    TooManyBadSamples once more than `budget` samples have been dropped."""

    def __init__(self, budget: Optional[int] = None):
        if budget is None:
            import os
            budget = int(os.environ.get('TIMM_TPU_POISON_BUDGET', DEFAULT_POISON_BUDGET))
        self.budget = budget
        self.skipped = 0
        self._lock = threading.Lock()

    def record(self, exc: BaseException, where: str = ''):
        with self._lock:
            self.skipped += 1
            n = self.skipped
        if n > self.budget:
            raise TooManyBadSamples(
                f'{n} bad samples exceed the poison budget of {self.budget} '
                f'(last: {where}: {exc!r}); set TIMM_TPU_POISON_BUDGET to raise it') from exc
        _logger.warning(f'Skipped bad sample {where}: {exc!r} ({n}/{self.budget} budget used)')
