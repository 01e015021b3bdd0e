"""timm_tpu_torch: the PyTorch / CUDA port of timm_tpu for NVIDIA Hopper.

The JAX package ``timm_tpu`` stays the reference; this package imports
nothing of it. Entry points run on ``cuda`` unless given ``device='cpu'``.
Every TPU kernel on a ported path is a CUDA kernel written by hand
(``timm_tpu_torch/kernels``), beside its plain PyTorch version.
"""
from .models import create_model, is_model, list_models
from .optim import create_optimizer_v2
from .scheduler import create_scheduler_v2
from .serve import InferenceEngine
from .task import ClassificationTask, TrainingTask
