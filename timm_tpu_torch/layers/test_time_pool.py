"""Test-time average-max pooling head (counterpart of
timm_tpu/layers/test_time_pool.py).

When the eval input is larger than the size the model was trained at, the
larger NHWC feature map is average-pooled with the training-size window
(``pool_size``) at stride 1, the classifier runs on every window, and the
logits are the mean of the windows' mean and max. Traps: the window sum is
divided by the window's area ('VALID', no padding), the classifier is the
base model's own ``Linear`` applied to NHWC windows (no 1x1 conv copy), and
a token model's (B, N, C) features take the mean and max over tokens.
"""
from __future__ import annotations

import logging

import torch
import torch.nn.functional as F
from torch import nn

_logger = logging.getLogger(__name__)

__all__ = ['TestTimePoolHead', 'apply_test_time_pool']


class TestTimePoolHead(nn.Module):
    """Wraps ``base``; ``original_pool`` is the training-size pool window."""
    __test__ = False  # not a pytest class

    def __init__(self, base: nn.Module, original_pool=7):
        super().__init__()
        self.base = base
        self.original_pool = ((original_pool, original_pool) if isinstance(original_pool, int)
                              else tuple(original_pool))
        self.num_classes = base.num_classes
        self.pretrained_cfg = getattr(base, 'pretrained_cfg', None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.base.forward_features(x)
        fc = self.base.get_classifier()  # the base's own head weights, registered once
        if x.ndim == 3:
            logits = fc(x)
            return 0.5 * (logits.mean(dim=1) + logits.amax(dim=1))
        ph, pw = self.original_pool
        x = F.avg_pool2d(x.permute(0, 3, 1, 2), (ph, pw), 1, divisor_override=1) / (ph * pw)
        logits = fc(x.permute(0, 2, 3, 1))  # (B, h', w', num_classes)
        return 0.5 * (logits.mean(dim=(1, 2)) + logits.amax(dim=(1, 2)))

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.forward_features(x)


def apply_test_time_pool(model: nn.Module, config, use_test_size: bool = False):
    """(model wrapped in ``TestTimePoolHead``, True) when the eval input size
    exceeds the model's default (its test size under ``use_test_size``) in
    both dims, else (model, False)."""
    cfg = getattr(model, 'pretrained_cfg', None)
    if not cfg:
        return model, False
    get = ((lambda k: cfg.get(k)) if isinstance(cfg, dict) else (lambda k: getattr(cfg, k, None)))
    df_input_size = (get('test_input_size') if use_test_size else None) or get('input_size')
    pool_size = get('pool_size')
    if df_input_size is None or pool_size is None:
        return model, False
    if config['input_size'][-1] > df_input_size[-1] and config['input_size'][-2] > df_input_size[-2]:
        _logger.info(f'Target input size {tuple(config["input_size"][-2:])} > pretrained default '
                     f'{tuple(df_input_size[-2:])}, using test time pooling')
        return TestTimePoolHead(model, original_pool=pool_size), True
    return model, False
