"""Fault injection for resilience drills (counterpart of
timm_tpu/resilience/faultinject.py), the ``sigterm@N`` spec only.

  sigterm@N   deliver SIGTERM to this process at global update N (one-shot)

``train --fault-inject SPEC`` builds a ``FaultInjector`` and hands it to the
train loop. Every other spec of the JAX package (``truncate_ckpt``,
``nan_grads@N``, ``io_error%M``, ``resize@N:D``, ``kill_host@N``) raises
``NotImplementedError`` (ROADMAP A.5.4).
"""
from __future__ import annotations

from typing import Optional

__all__ = ['FaultInjector']

_NOT_PORTED = ('truncate_ckpt', 'nan_grads', 'io_error', 'resize', 'kill_host')


class FaultInjector:
    def __init__(self, spec: str = ''):
        self.spec = (spec or '').strip()
        self._sigterm_at: Optional[int] = None
        self._fired = False
        for part in filter(None, (p.strip() for p in self.spec.split(','))):
            kind = part.split('@')[0].split('%')[0]
            if kind in _NOT_PORTED:
                raise NotImplementedError(
                    f'fault {part!r} is not ported yet (ROADMAP A.5.4); the port has sigterm@N')
            if kind != 'sigterm' or '@' not in part:
                raise ValueError(f'unknown fault {part!r} in spec {spec!r} (known: sigterm@N)')
            n = part.partition('@')[2]
            if not n.isdigit():
                raise ValueError(f'sigterm needs an update index: {part!r} (want sigterm@N)')
            self._sigterm_at = int(n)

    def __bool__(self):
        return self._sigterm_at is not None

    def sigterm_at(self, update_idx: int) -> bool:
        """True exactly once, at update ``N``."""
        if self._sigterm_at == update_idx and not self._fired:
            self._fired = True
            return True
        return False
