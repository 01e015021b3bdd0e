"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: flash_attention.py and fused_adamw.py. Sources live in csrc/,
builds in build/."""
from .flash_attention import (
    KERNEL_HEAD_DIMS, flash_attention, flash_attention_backward, flash_attention_reference,
    kernel_smem_bytes,
)
from .fused_adamw import fused_adamw, fused_adamw_reference
