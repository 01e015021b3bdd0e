"""Cosine decay with linear warmup (counterpart of
timm_tpu/scheduler/cosine_lr.py, one cycle, no k-decay)."""
from __future__ import annotations

import math
from typing import List

from .scheduler import Scheduler

__all__ = ['CosineLRScheduler']


class CosineLRScheduler(Scheduler):
    def __init__(
            self,
            base_lr,
            t_initial: int,
            lr_min: float = 0.0,
            warmup_t: int = 0,
            warmup_lr_init: float = 0.0,
            t_in_epochs: bool = True,
    ):
        super().__init__(base_lr)
        if t_initial <= 0:
            raise ValueError(f't_initial must be positive; got {t_initial}')
        self.t_initial = t_initial
        self.lr_min = lr_min
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.t_in_epochs = t_in_epochs
        if self.warmup_t:
            self.warmup_steps = [(v - warmup_lr_init) / self.warmup_t for v in self.base_values]
        else:
            self.warmup_steps = [1 for _ in self.base_values]

    def _get_lr(self, t: int) -> List[float]:
        if t < self.warmup_t:
            return [self.warmup_lr_init + t * s for s in self.warmup_steps]
        if t >= self.t_initial:
            return [self.lr_min for _ in self.base_values]
        return [
            self.lr_min + 0.5 * (lr_max - self.lr_min) * (1 + math.cos(math.pi * t / self.t_initial))
            for lr_max in self.base_values
        ]
