"""Preemption-aware shutdown, one process (counterpart of
timm_tpu/resilience/preemption.py).

``GracefulShutdown`` turns SIGTERM / SIGINT into a flag the train loop
polls between updates; the loop then writes a step-granular recovery
checkpoint (loader position, host RNG state, update counter) and exits 0,
so a scheduler restarts the job and ``--resume auto`` continues mid-epoch.
The cross-host stop consensus of a multi-process run is not ported
(ROADMAP A.5.11): ``should_stop`` raises under an initialised
``torch.distributed`` group of more than one process.
"""
from __future__ import annotations

import logging
import signal
import threading

import torch

_logger = logging.getLogger(__name__)

__all__ = ['GracefulShutdown', 'TrainingPreempted']


class TrainingPreempted(Exception):
    """Raised by the train loop after the recovery checkpoint is written; the
    top level logs and exits 0 (preemption is a normal, reschedulable exit)."""

    def __init__(self, recovery_path: str = ''):
        self.recovery_path = recovery_path
        super().__init__(f'preempted; recovery checkpoint: {recovery_path or "n/a"}')


class GracefulShutdown:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._prev_handlers = {}
        self._installed = False

    def install(self) -> 'GracefulShutdown':
        """Install the handlers (main thread only; elsewhere a no-op).
        Idempotent, and a partial install rolls back."""
        if threading.current_thread() is not threading.main_thread():
            _logger.warning('GracefulShutdown.install() skipped: not on the main thread')
            return self
        if self._installed:
            return self
        installed = []
        try:
            for sig in self.signals:
                self._prev_handlers[sig] = signal.signal(sig, self._handle)
                installed.append(sig)
        except BaseException:
            for sig in installed:
                signal.signal(sig, self._prev_handlers.pop(sig))
            raise
        self._installed = True
        return self

    def uninstall(self):
        """Restore the previous handlers, all of them even when one restore
        raises; the first error propagates after the rest are back."""
        first_err = None
        for sig in list(self._prev_handlers):
            prev = self._prev_handlers.pop(sig)
            try:
                signal.signal(sig, prev)
            except BaseException as e:  # keep restoring the remaining signals
                if first_err is None:
                    first_err = e
        self._installed = False
        if first_err is not None:
            raise first_err

    def _handle(self, signum, frame):
        if self._flag.is_set() and signum == signal.SIGINT:
            raise KeyboardInterrupt  # a second ctrl-c means it
        self._flag.set()
        _logger.warning(
            f'Received {signal.Signals(signum).name}: finishing the current update, '
            f'then writing a recovery checkpoint and exiting cleanly')

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def should_stop(self, update_idx: int) -> bool:
        """Poll between updates: the local flag."""
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                'the cross-process preemption consensus is not ported yet (ROADMAP A.5.11)')
        return self.requested
