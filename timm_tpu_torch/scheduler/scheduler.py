"""Scheduler base (counterpart of timm_tpu/scheduler/scheduler.py, without
noise).

A scheduler is a host-side object that gives the learning rate of each
epoch (``step``) or update (``step_update``) as a Python number; the train
step takes it as an argument. Pure Python, so it is the same on every
device.
"""
from __future__ import annotations

import abc
from typing import List, Optional, Union

__all__ = ['Scheduler']


class Scheduler(abc.ABC):
    def __init__(self, base_lr: Union[float, List[float]]):
        self.base_values = [base_lr] if not isinstance(base_lr, (list, tuple)) else list(base_lr)
        self.t_in_epochs = True
        self._last_values = list(self.base_values)

    @abc.abstractmethod
    def _get_lr(self, t: int) -> List[float]:
        ...

    def step(self, epoch: int) -> List[float]:
        return self._step(epoch, on_epoch=True)

    def step_update(self, num_updates: int) -> List[float]:
        return self._step(num_updates, on_epoch=False)

    def _step(self, t: int, on_epoch: bool) -> List[float]:
        if on_epoch == self.t_in_epochs:
            self._last_values = self._get_lr(t)
        return self._last_values

    def get_last_lr(self) -> List[float]:
        return self._last_values
