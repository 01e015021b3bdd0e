"""Seeding (counterpart of timm_tpu/utils/random.py): Python's, numpy's and
torch's global streams."""
from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ['random_seed']


def random_seed(seed: int = 42, rank: int = 0):
    random.seed(seed + rank)
    np.random.seed(seed + rank)
    torch.manual_seed(seed + rank)
