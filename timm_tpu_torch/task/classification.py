"""Classification tasks (counterpart of timm_tpu/task/classification.py):
the dense-image task and the NaFlex task over dict batches of packed
patches."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..loss import LabelSmoothingCrossEntropy
from .task import TrainingTask

__all__ = ['ClassificationTask', 'NaFlexClassificationTask']


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


class NaFlexClassificationTask(ClassificationTask):
    """Classification over NaFlex dict batches ({patches, patch_coord,
    patch_valid, target[, target_b, lam]}); each (seq_len, batch, patch
    dim) is its own step graph. After the loader's variable-size mixup the
    per-sample lam-mixed (and optionally smoothed) soft targets are built
    here and fed to the configured train loss, as Mixup's soft labels are
    for dense batches."""

    def __init__(self, *args, mixup_label_smoothing: Optional[float] = None, **kwargs):
        super().__init__(*args, **kwargs)
        # not None: the train loss takes dense targets (mixup configured),
        # and batches that were not mixed get smoothed one-hot targets too
        self.mixup_label_smoothing = mixup_label_smoothing

    def _soft_targets(self, batch, nc: int) -> torch.Tensor:
        s = self.mixup_label_smoothing or 0.0
        off, on = s / nc, 1.0 - s + s / nc
        classes = torch.arange(nc, device=batch['target'].device)

        def one_hot(t):
            # a comparison, not F.one_hot, which reads the labels back on the CPU
            return torch.where(t.long()[:, None] == classes, on, off).float()

        oh_a = one_hot(batch['target'])
        if 'lam' not in batch:
            return oh_a
        lam = batch['lam'].float()[:, None]
        return lam * oh_a + (1.0 - lam) * one_hot(batch['target_b'])

    @staticmethod
    def _model_inputs(batch: Dict[str, Any]) -> Dict[str, Any]:
        return {'patches': batch['patches'], 'patch_coord': batch['patch_coord'],
                'patch_valid': batch['patch_valid']}

    def loss_forward(self, model: nn.Module, batch: Dict[str, Any]):
        output = model(self._model_inputs(batch))
        if self.mixup_label_smoothing is not None or 'lam' in batch:
            loss = self.train_loss_fn(output, self._soft_targets(batch, output.shape[-1]))
        else:
            loss = self.train_loss_fn(output, batch['target'])
        return loss, output

    def eval_forward(self, model: nn.Module, batch: Dict[str, Any]):
        return model(self._model_inputs(batch))
