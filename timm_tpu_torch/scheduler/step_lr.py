"""Step, multi-step, poly and plateau schedulers (counterpart of
timm_tpu/scheduler/step_lr.py)."""
from __future__ import annotations

import bisect
import math
from typing import List, Optional

from .scheduler import Scheduler

__all__ = ['StepLRScheduler', 'MultiStepLRScheduler', 'PolyLRScheduler', 'PlateauLRScheduler']


class StepLRScheduler(Scheduler):
    def __init__(
            self,
            base_lr,
            decay_t: float,
            decay_rate: float = 1.0,
            warmup_t: int = 0,
            warmup_lr_init: float = 0.0,
            warmup_prefix: bool = True,
            t_in_epochs: bool = True,
            **kwargs,
    ):
        super().__init__(base_lr, **kwargs)
        self.decay_t = decay_t
        self.decay_rate = decay_rate
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
        return [v * (self.decay_rate ** (t // self.decay_t)) for v in self.base_values]


class MultiStepLRScheduler(Scheduler):
    def __init__(
            self,
            base_lr,
            decay_t: List[int],
            decay_rate: float = 1.0,
            warmup_t: int = 0,
            warmup_lr_init: float = 0.0,
            warmup_prefix: bool = True,
            t_in_epochs: bool = True,
            **kwargs,
    ):
        super().__init__(base_lr, **kwargs)
        self.decay_t = decay_t
        self.decay_rate = decay_rate
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.warmup_prefix = warmup_prefix
        self.t_in_epochs = t_in_epochs
        if self.warmup_t:
            self.warmup_steps = [(v - warmup_lr_init) / self.warmup_t for v in self.base_values]
        else:
            self.warmup_steps = [1 for _ in self.base_values]

    def get_curr_decay_steps(self, t: int) -> int:
        return bisect.bisect_right(self.decay_t, t + 1)

    def _get_lr(self, t: int) -> List[float]:
        if t < self.warmup_t:
            return [self.warmup_lr_init + t * s for s in self.warmup_steps]
        if self.warmup_prefix:
            t = t - self.warmup_t
        return [v * (self.decay_rate ** self.get_curr_decay_steps(t)) for v in self.base_values]


class PolyLRScheduler(Scheduler):
    def __init__(
            self,
            base_lr,
            t_initial: int,
            power: float = 0.5,
            lr_min: float = 0.0,
            cycle_mul: float = 1.0,
            cycle_decay: float = 1.0,
            cycle_limit: int = 1,
            warmup_t: int = 0,
            warmup_lr_init: float = 0.0,
            warmup_prefix: bool = False,
            t_in_epochs: bool = True,
            k_decay: float = 1.0,
            **kwargs,
    ):
        super().__init__(base_lr, **kwargs)
        if t_initial <= 0:
            raise ValueError(f't_initial must be positive; got {t_initial}')
        self.t_initial = t_initial
        self.power = power
        self.lr_min = lr_min
        self.cycle_mul = cycle_mul
        self.cycle_decay = cycle_decay
        self.cycle_limit = cycle_limit
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.warmup_prefix = warmup_prefix
        self.t_in_epochs = t_in_epochs
        self.k_decay = k_decay
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
            k = self.k_decay
            return [
                self.lr_min + (lr_max - self.lr_min) * (1 - t_curr ** k / t_i ** k) ** self.power
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


class PlateauLRScheduler(Scheduler):
    """Decay on a plateau of the evaluation metric. Metric-driven, so it
    only steps per-epoch via `step(epoch, metric)`."""

    def __init__(
            self,
            base_lr,
            decay_rate: float = 0.1,
            patience_t: int = 10,
            verbose: bool = True,
            threshold: float = 1e-4,
            cooldown_t: int = 0,
            warmup_t: int = 0,
            warmup_lr_init: float = 0.0,
            lr_min: float = 0.0,
            mode: str = 'max',
            **kwargs,
    ):
        super().__init__(base_lr, **kwargs)
        self.decay_rate = decay_rate
        self.patience_t = patience_t
        self.threshold = threshold
        self.cooldown_t = cooldown_t
        self.cooldown_counter = 0
        self.mode = mode
        self.lr_min = lr_min
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.t_in_epochs = True
        self.best = None
        self.num_bad_epochs = 0
        self.restore_lr = None
        self._current = list(self.base_values)
        if self.warmup_t:
            self.warmup_steps = [(v - warmup_lr_init) / self.warmup_t for v in self.base_values]
        else:
            self.warmup_steps = [1 for _ in self.base_values]

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == 'max':
            return metric > self.best + self.threshold
        return metric < self.best - self.threshold

    def _get_lr(self, t: int) -> List[float]:
        # warmup only; plateau logic lives in step()
        return [self.warmup_lr_init + t * s for s in self.warmup_steps]

    def step(self, epoch: int, metric: Optional[float] = None) -> List[float]:
        if epoch < self.warmup_t:
            self._last_values = self._get_lr(epoch)
            return self._last_values
        if metric is not None:
            if self._is_better(metric):
                self.best = metric
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
            if self.cooldown_counter > 0:
                self.cooldown_counter -= 1
                self.num_bad_epochs = 0
            if self.num_bad_epochs > self.patience_t:
                self._current = [max(v * self.decay_rate, self.lr_min) for v in self._current]
                self.cooldown_counter = self.cooldown_t
                self.num_bad_epochs = 0
        self._last_values = self._add_noise(list(self._current), epoch)
        return self._last_values

    def step_update(self, num_updates: int, metric: Optional[float] = None) -> List[float]:
        return self._last_values
