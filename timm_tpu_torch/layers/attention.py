"""Multi-head attention (counterpart of timm_tpu/layers/attention.py).

Tokens are (B, N, C); q, k, v are (B, H, N, D). On a CUDA device every
attention call goes to the hand-written flash-attention kernel
(timm_tpu_torch/kernels/flash_attention.py); a call outside the kernel's
contract (dropout, an additive or per-query mask) raises rather than taking
a plain path on the card. On the CPU the plain ``_sdpa`` runs, which mirrors
the JAX package's ``_sdpa``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from .config import softmax_with_policy
from .drop import Dropout, dropout
from .linear import Linear

__all__ = ['Attention', 'maybe_add_mask', 'scaled_dot_product_attention']


def maybe_add_mask(scores: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A bool mask (True = keep) sets the other scores to the dtype's min; a
    float mask is added."""
    if attn_mask is None:
        return scores
    if attn_mask.dtype == torch.bool:
        return torch.where(attn_mask, scores, torch.finfo(scores.dtype).min)
    return scores + attn_mask


def _sdpa(q, k, v, attn_mask=None, dropout_p: float = 0.0, scale: Optional[float] = None,
          generator: Optional[torch.Generator] = None):
    """Plain scaled dot-product attention on (B, H, N, D) tensors; dropout on
    the probabilities draws from ``generator``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    # JAX rounds a Python scalar to q's dtype before the product; so does a
    # 0-dim tensor of that dtype here
    q = q * torch.tensor(scale, dtype=q.dtype)
    attn = q @ k.transpose(-2, -1)
    attn = maybe_add_mask(attn, attn_mask)
    attn = softmax_with_policy(attn, dim=-1).to(q.dtype)
    attn = dropout(attn, dropout_p, training=True, generator=generator)
    return attn @ v


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p: float = 0.0,
                                 scale: Optional[float] = None,
                                 generator: Optional[torch.Generator] = None):
    """Dispatcher over (B, H, N, D) q/k/v: the flash kernel on a CUDA device,
    the plain path on the CPU."""
    if q.device.type != 'cuda':
        return _sdpa(q, k, v, attn_mask, dropout_p, scale, generator)
    if dropout_p > 0.0:
        raise NotImplementedError(
            'attention dropout on CUDA: the flash-attention kernel has no dropout yet')
    if attn_mask is not None:
        B, Nk = q.shape[0], k.shape[2]
        if attn_mask.dtype != torch.bool:
            raise NotImplementedError(
                'additive float attention masks on CUDA: the flash-attention kernel '
                'takes bool key-padding masks only')
        if tuple(attn_mask.shape) not in ((B, Nk), (B, 1, 1, Nk)):
            raise NotImplementedError(
                f'attention mask of shape {tuple(attn_mask.shape)} on CUDA: the '
                f'flash-attention kernel takes key-padding masks {(B, Nk)} or {(B, 1, 1, Nk)}')
    return flash_attention(q, k, v, mask=attn_mask, scale=scale)


class Attention(nn.Module):
    """Standard multi-head self-attention with a fused qkv projection."""

    def __init__(
            self,
            dim: int,
            num_heads: int = 8,
            qkv_bias: bool = False,
            proj_bias: bool = True,
            attn_drop: float = 0.0,
            proj_drop: float = 0.0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f'dim {dim} is not divisible by num_heads {num_heads}')
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype, generator=generator)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim, bias=proj_bias, dtype=dtype, generator=generator)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # strided (B, H, N, D) views of the projection
        dropout_p = self.attn_drop.rate if self.training else 0.0
        x = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
                                         scale=self.scale, generator=self.attn_drop.generator)
        x = x.transpose(1, 2).reshape(B, N, C)
        return self.proj_drop(self.proj(x))
