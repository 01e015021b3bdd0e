"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: flash_attention.py, fused_adamw.py and augment_epilogue.py.
Sources live in csrc/, builds in build/."""
from .augment_epilogue import augment_epilogue, augment_epilogue_reference
from .flash_attention import (
    KERNEL_HEAD_DIMS, flash_attention, flash_attention_backward, flash_attention_reference,
    kernel_smem_bytes,
)
from .fused_adamw import fused_adamw, fused_adamw_reference
