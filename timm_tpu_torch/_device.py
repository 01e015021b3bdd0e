"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ['resolve_device', 'use_full_fp32']


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no card present a CUDA request raises; the port never
    carries on on the CPU unless asked to with ``device='cpu'``."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'timm_tpu_torch runs on a CUDA device by default and none is available; '
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def use_full_fp32(device: torch.device) -> None:
    """On a CUDA device, compute fp32 convolutions and matmuls in fp32: turn
    off TF32, which cuDNN allows by default (10-bit mantissa inputs), so an
    fp32 model on the card computes what the JAX package computes in fp32.
    bf16 compute (``--amp``) is not affected."""
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
