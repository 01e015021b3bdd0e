"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. See flash_attention.py; sources live in csrc/, builds in build/."""
from .flash_attention import (
    KERNEL_HEAD_DIMS, flash_attention, flash_attention_reference, kernel_smem_bytes,
)
