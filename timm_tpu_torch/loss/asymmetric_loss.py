"""Asymmetric focal-style losses (counterpart of
timm_tpu/loss/asymmetric_loss.py), in fp32."""
from __future__ import annotations

import torch

from .binary_cross_entropy import one_hot

__all__ = ['AsymmetricLossMultiLabel', 'AsymmetricLossSingleLabel']


class AsymmetricLossMultiLabel:
    """Sigmoid loss with separate focusing exponents for positives and
    negatives, the negatives' probability shifted by ``clip``; the focusing
    weight carries no gradient. Returns the sum."""

    def __init__(self, gamma_neg: float = 4, gamma_pos: float = 1, clip: float = 0.05,
                 eps: float = 1e-8):
        self.gamma_neg = gamma_neg
        self.gamma_pos = gamma_pos
        self.clip = clip
        self.eps = eps

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x_sigmoid = torch.sigmoid(x.float())
        xs_pos = x_sigmoid
        xs_neg = 1.0 - x_sigmoid
        if self.clip is not None and self.clip > 0:
            xs_neg = torch.clamp_max(xs_neg + self.clip, 1.0)
        loss = (y * torch.log(torch.clamp_min(xs_pos, self.eps))
                + (1 - y) * torch.log(torch.clamp_min(xs_neg, self.eps)))
        if self.gamma_neg > 0 or self.gamma_pos > 0:
            pt = xs_pos * y + xs_neg * (1 - y)
            one_sided_gamma = self.gamma_pos * y + self.gamma_neg * (1 - y)
            loss = loss * torch.pow(1 - pt, one_sided_gamma).detach()
        return -loss.sum()


class AsymmetricLossSingleLabel:
    """Softmax loss over integer targets with the asymmetric focusing weight
    and label smoothing ``eps``."""

    def __init__(self, gamma_pos: float = 1, gamma_neg: float = 4, eps: float = 0.1,
                 reduction: str = 'mean'):
        self.gamma_pos = gamma_pos
        self.gamma_neg = gamma_neg
        self.eps = eps
        self.reduction = reduction

    def __call__(self, inputs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        num_classes = inputs.shape[-1]
        log_preds = torch.log_softmax(inputs.float(), dim=-1)
        targets = one_hot(target, num_classes)
        anti_targets = 1 - targets
        xs_pos = torch.exp(log_preds)
        xs_neg = 1 - xs_pos
        xs_pos = xs_pos * targets
        xs_neg = xs_neg * anti_targets
        asymmetric_w = torch.pow(1 - xs_pos - xs_neg,
                                 self.gamma_pos * targets + self.gamma_neg * anti_targets)
        log_preds = log_preds * asymmetric_w
        if self.eps > 0:
            targets = targets * (1 - self.eps) + self.eps / num_classes
        loss = -(targets * log_preds).sum(dim=-1)
        if self.reduction == 'mean':
            return loss.mean()
        if self.reduction == 'sum':
            return loss.sum()
        return loss
