"""Model EMA (counterpart of timm_tpu/utils/model_ema.py).

The EMA weights are a second set of tensors beside the parameters; the
update is an fp32 lerp cast back to each tensor's dtype. On the port's
training path the AdamW kernel applies it in the same pass as the update
(kernels/fused_adamw.py); ``ema_update`` is the plain form. The decay
schedule is a host-side number per step.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import torch

__all__ = ['ModelEmaV3', 'ema_update']


def ema_update(ema_params: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: Union[float, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """ema = decay * ema + (1 - decay) * params, per name."""
    d = torch.as_tensor(decay, dtype=torch.float32)
    out = {}
    for k, e in ema_params.items():
        dk = d.to(e.device)
        out[k] = (e.float() * dk + params[k].float() * (1.0 - dk)).to(e.dtype)
    return out


class ModelEmaV3:
    """Host-side EMA controller: owns the decay schedule."""

    def __init__(
            self,
            decay: float = 0.9999,
            min_decay: float = 0.0,
            update_after_step: int = 0,
            use_warmup: bool = False,
            warmup_gamma: float = 1.0,
            warmup_power: float = 2.0 / 3.0,
    ):
        self.decay = decay
        self.min_decay = min_decay
        self.update_after_step = update_after_step
        self.use_warmup = use_warmup
        self.warmup_gamma = warmup_gamma
        self.warmup_power = warmup_power

    def get_decay(self, step: int) -> float:
        """0.0 up to step ``update_after_step + 1``, so the EMA starts as a
        copy of the parameters."""
        step = max(0, step - self.update_after_step - 1)
        if step <= 0:
            return 0.0
        if self.use_warmup:
            decay = 1 - (1 + step / self.warmup_gamma) ** -self.warmup_power
            return max(min(decay, self.decay), self.min_decay)
        return self.decay
