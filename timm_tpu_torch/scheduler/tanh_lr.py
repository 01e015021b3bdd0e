"""Hyperbolic-tangent decay with warmup (counterpart of
timm_tpu/scheduler/tanh_lr.py)."""
from __future__ import annotations

import math
from typing import List

from .scheduler import Scheduler

__all__ = ['TanhLRScheduler']


class TanhLRScheduler(Scheduler):
    def __init__(
            self,
            base_lr,
            t_initial: int,
            lb: float = -7.0,
            ub: float = 3.0,
            lr_min: float = 0.0,
            cycle_mul: float = 1.0,
            cycle_decay: float = 1.0,
            cycle_limit: int = 1,
            warmup_t: int = 0,
            warmup_lr_init: float = 0.0,
            warmup_prefix: bool = False,
            t_in_epochs: bool = True,
            initialize: bool = True,
            **kwargs,
    ):
        super().__init__(base_lr, initialize=initialize, **kwargs)
        if t_initial <= 0 or not lb < ub:
            raise ValueError(f't_initial must be positive and lb below ub; got {t_initial}, {lb}, {ub}')
        self.lb = lb
        self.ub = ub
        self.t_initial = t_initial
        self.lr_min = lr_min
        self.cycle_mul = cycle_mul
        self.cycle_decay = cycle_decay
        self.cycle_limit = cycle_limit
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.warmup_prefix = warmup_prefix
        self.t_in_epochs = t_in_epochs
        if self.warmup_t:
            self.warmup_steps = [(v - warmup_lr_init) / self.warmup_t for v in self.base_values]
        else:
            self.warmup_steps = [1 for _ in self.base_values]

    def _get_lr(self, t: int) -> List[float]:
        if t < self.warmup_t:
            return [self.warmup_lr_init + t * s for s in self.warmup_steps]
        if self.warmup_prefix:
            t = t - self.warmup_t
        if self.cycle_mul != 1:
            i = math.floor(math.log(1 - t / self.t_initial * (1 - self.cycle_mul), self.cycle_mul))
            t_i = self.cycle_mul ** i * self.t_initial
            t_curr = t - (1 - self.cycle_mul ** i) / (1 - self.cycle_mul) * self.t_initial
        else:
            i = t // self.t_initial
            t_i = self.t_initial
            t_curr = t - (self.t_initial * i)

        if i < self.cycle_limit:
            gamma = self.cycle_decay ** i
            lr_max_values = [v * gamma for v in self.base_values]
            tr = t_curr / t_i
            return [
                self.lr_min + 0.5 * (lr_max - self.lr_min) * (
                    1 - math.tanh(self.lb * (1.0 - tr) + self.ub * tr))
                for lr_max in lr_max_values
            ]
        return [self.lr_min for _ in self.base_values]

    def get_cycle_length(self, cycles: int = 0) -> int:
        cycles = max(1, cycles or self.cycle_limit)
        if self.cycle_mul == 1.0:
            t = self.t_initial * cycles
        else:
            t = int(math.floor(-self.t_initial * (self.cycle_mul ** cycles - 1) / (1 - self.cycle_mul)))
        return t + self.warmup_t if self.warmup_prefix else t
