"""Metrics (counterpart of timm_tpu/utils/metrics.py), ``accuracy`` on
tensors, and ``eval_metrics``, the one eval loss/top-1/top-5 of the train,
validate and inference drivers."""
from __future__ import annotations

import torch

__all__ = ['AverageMeter', 'accuracy', 'eval_metrics']


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def accuracy(output: torch.Tensor, target: torch.Tensor, topk=(1,)):
    """Top-k accuracy in percent. Ties rank the higher class index first,
    as the JAX package's reversed ``argsort`` does."""
    maxk = min(max(topk), output.shape[-1])
    batch_size = target.shape[0]
    # stable ascending sort, reversed: equal logits keep JAX's order
    pred = torch.argsort(output.float(), dim=-1, stable=True).flip(-1)[:, :maxk]
    correct = pred == target.reshape(-1, 1).to(pred.device)
    return [float(correct[:, :min(k, maxk)].any(dim=-1).sum()) * 100.0 / batch_size for k in topk]


def eval_metrics(logits: torch.Tensor, target: torch.Tensor, valid=None):
    """Loss, top-1 and top-5 (percent) of one eval batch, computed on the
    logits' device, and each row's five best classes, best last. The stable
    ascending argsort ranks tied logits (common in bf16) as the JAX scripts'
    ``jnp.argsort`` does, the higher class index first. ``valid`` weights the
    rows (0 for the padding of a bucketed batch)."""
    logits = logits.float()
    target = torch.as_tensor(target).to(logits.device).long()
    w = (torch.ones_like(target, dtype=torch.float32) if valid is None
         else torch.as_tensor(valid).to(logits.device).float())
    denom = w.sum().clamp_min(1.0)
    logprobs = torch.log_softmax(logits, dim=-1)
    loss = -(torch.gather(logprobs, 1, target[:, None])[:, 0] * w).sum() / denom
    top = torch.argsort(logits, dim=-1, stable=True)[:, -5:]
    acc1 = ((top[:, -1] == target) * w).sum() / denom * 100.0
    acc5 = ((top == target[:, None]).any(dim=-1) * w).sum() / denom * 100.0
    return loss, acc1, acc5, top
