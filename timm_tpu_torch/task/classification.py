"""Classification task (counterpart of timm_tpu/task/classification.py).
The NaFlex variant is not ported yet (ROADMAP §A.5)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from torch import nn

from ..loss import LabelSmoothingCrossEntropy
from .task import TrainingTask

__all__ = ['ClassificationTask']


class ClassificationTask(TrainingTask):
    def __init__(
            self,
            model: nn.Module,
            optimizer=None,
            train_loss_fn: Optional[Callable] = None,
            eval_loss_fn: Optional[Callable] = None,
            **kwargs,
    ):
        super().__init__(model, optimizer=optimizer, **kwargs)
        self.train_loss_fn = train_loss_fn or LabelSmoothingCrossEntropy(0.0)
        self.eval_loss_fn = eval_loss_fn or self.train_loss_fn

    def loss_forward(self, model: nn.Module, batch: Dict[str, Any]):
        output = model(batch['input'])
        return self.train_loss_fn(output, batch['target']), output
