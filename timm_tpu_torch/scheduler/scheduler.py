"""Scheduler base (counterpart of timm_tpu/scheduler/scheduler.py).

A scheduler is a host-side object that gives the learning rate of each
epoch (``step``) or update (``step_update``) as a Python number; the train
step writes it into the optimizer's device scalar. Pure Python, so it is
the same on every device. Noise draws from ``random.Random(noise_seed +
t)``, the JAX package's stream: a truncated normal (redrawn until below
``noise_pct``) or a uniform in [-noise_pct, noise_pct).
"""
from __future__ import annotations

import abc
import random
from typing import Any, Dict, List, Optional, Union

__all__ = ['Scheduler']


class Scheduler(abc.ABC):
    def __init__(
            self,
            base_lr: Union[float, List[float]],
            noise_range_t=None,
            noise_type: str = 'normal',
            noise_pct: float = 0.67,
            noise_std: float = 1.0,
            noise_seed: Optional[int] = None,
            initialize: bool = True,
    ):
        self.base_values = [base_lr] if not isinstance(base_lr, (list, tuple)) else list(base_lr)
        self.noise_range_t = noise_range_t
        self.noise_pct = noise_pct
        self.noise_type = noise_type
        self.noise_std = noise_std
        self.noise_seed = noise_seed if noise_seed is not None else 42
        self.metric = None
        self._last_values = list(self.base_values)

    @abc.abstractmethod
    def _get_lr(self, t: int) -> List[float]:
        ...

    def _get_values(self, t: int, on_epoch: bool = True) -> Optional[List[float]]:
        proceed = (on_epoch and self.t_in_epochs) or (not on_epoch and not self.t_in_epochs)
        if not proceed:
            return None
        return self._get_lr(t)

    def step(self, epoch: int, metric: Optional[float] = None) -> List[float]:
        self.metric = metric
        values = self._get_values(epoch, on_epoch=True)
        if values is not None:
            values = self._add_noise(values, epoch)
            self._last_values = values
        return self._last_values

    def step_update(self, num_updates: int, metric: Optional[float] = None) -> List[float]:
        self.metric = metric
        values = self._get_values(num_updates, on_epoch=False)
        if values is not None:
            values = self._add_noise(values, num_updates)
            self._last_values = values
        return self._last_values

    def get_last_lr(self) -> List[float]:
        return self._last_values

    @property
    def last_lr(self) -> float:
        return self._last_values[0]

    def state_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()}

    def load_state_dict(self, state_dict: Dict[str, Any]):
        self.__dict__.update(state_dict)

    def _is_apply_noise(self, t: int) -> bool:
        if self.noise_range_t is None:
            return False
        if isinstance(self.noise_range_t, (list, tuple)):
            return self.noise_range_t[0] <= t < self.noise_range_t[1]
        return t >= self.noise_range_t

    def _calculate_noise(self, t: int) -> float:
        g = random.Random(self.noise_seed + t)
        if self.noise_type == 'normal':
            while True:
                noise = g.gauss(0, self.noise_std)
                if abs(noise) < self.noise_pct:
                    return noise
        return 2 * (g.random() - 0.5) * self.noise_pct

    def _add_noise(self, lrs: List[float], t: int) -> List[float]:
        if self._is_apply_noise(t):
            noise = self._calculate_noise(t)
            lrs = [v + v * noise for v in lrs]
        return lrs
