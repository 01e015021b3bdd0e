"""Non-finite (NaN/Inf) step sentinel (counterpart of
timm_tpu/resilience/sentinel.py).

Device side: ``tree_all_finite`` reduces loss and gradients to one bool
tensor on the device; the train step keeps an int32 ``[consecutive, total]``
counter pair on the device, and the optimizer reads the flag so that a bad
step commits nothing (parameters, moments, step count and EMA stay
bit-identical) without a host round trip.

Host side: ``NonFiniteSentinel.observe`` polls the counters every
``check_every`` steps (TIMM_TPU_NONFINITE_CHECK_EVERY, default 1) and raises
``NonFiniteError`` after ``tolerance`` consecutive bad steps
(TIMM_TPU_NONFINITE_TOLERANCE, default 3). The guard is on unless
TIMM_TPU_NONFINITE_GUARD is 0.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Union

import torch

_logger = logging.getLogger(__name__)

__all__ = ['NonFiniteError', 'NonFiniteSentinel', 'guard_enabled', 'new_sentinel_state',
           'tree_all_finite', 'update_sentinel_state']

DEFAULT_TOLERANCE = 3


class NonFiniteError(RuntimeError):
    def __init__(self, consecutive: int, total: int, step: int, tolerance: int):
        self.consecutive = consecutive
        self.total = total
        self.step = step
        self.tolerance = tolerance
        super().__init__(
            f'{consecutive} consecutive non-finite train steps at update {step} '
            f'(tolerance {tolerance}, {total} bad steps total). Lower the LR or enable '
            f'grad clipping. Set TIMM_TPU_NONFINITE_TOLERANCE to adjust the abort threshold.')


def guard_enabled(explicit: Optional[bool] = None) -> bool:
    """Guard default: on, unless TIMM_TPU_NONFINITE_GUARD=0."""
    if explicit is not None:
        return explicit
    return os.environ.get('TIMM_TPU_NONFINITE_GUARD', '1') not in ('0', 'false', 'off')


def tree_all_finite(*trees: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
    """Bool tensor on the device: every floating-point tensor given (alone or
    in a list) is finite. Integer and bool tensors are skipped."""
    ok = None
    for tree in trees:
        for t in ([tree] if isinstance(tree, torch.Tensor) else tree):
            if t.is_floating_point():
                f = torch.isfinite(t).all()
                ok = f if ok is None else ok & f
    return torch.ones((), dtype=torch.bool) if ok is None else ok


def new_sentinel_state(device=None) -> torch.Tensor:
    """[consecutive_bad, total_bad] int32 counters."""
    return torch.zeros(2, dtype=torch.int32, device=device)


def update_sentinel_state(state: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Count a step into the carried ``[consecutive, total]`` counters, in
    place (a CUDA graph holds their address; JAX donates them), and
    return them."""
    bad = torch.logical_not(ok).to(torch.int32)
    consecutive = torch.where(ok, torch.zeros_like(state[0]), state[0] + 1)
    state.copy_(torch.stack([consecutive, state[1] + bad]))
    return state


class NonFiniteSentinel:
    def __init__(self, tolerance: Optional[int] = None, check_every: Optional[int] = None):
        if tolerance is None:
            tolerance = int(os.environ.get('TIMM_TPU_NONFINITE_TOLERANCE', DEFAULT_TOLERANCE))
        if check_every is None:
            check_every = int(os.environ.get('TIMM_TPU_NONFINITE_CHECK_EVERY', 1))
        if tolerance < 1:
            raise ValueError(f'nonfinite tolerance must be >= 1; got {tolerance}')
        self.tolerance = tolerance
        self.check_every = max(1, check_every)
        self.consecutive = 0   # as of the last poll
        self.total = 0
        self._calls = 0

    def reset(self):
        self.consecutive = 0
        self._calls = 0

    def observe(self, sentinel_state: torch.Tensor, step: int = 0) -> bool:
        """Poll the device counters; True if the last step was skipped.
        Raises NonFiniteError once ``tolerance`` consecutive steps went bad."""
        self._calls += 1
        if self._calls % self.check_every != 0:
            return False
        consecutive, total = (int(c) for c in sentinel_state.tolist())
        newly_bad = total - self.total
        self.consecutive, self.total = consecutive, total
        if newly_bad > 0:
            _logger.warning(f'Non-finite loss/grads at update {step}: update skipped '
                            f'({consecutive} consecutive, {total} total)')
        if consecutive >= self.tolerance:
            raise NonFiniteError(consecutive, total, step, self.tolerance)
        return newly_bad > 0
