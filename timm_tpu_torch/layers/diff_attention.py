"""Differential attention (counterpart of timm_tpu/layers/diff_attention.py).

Attn = softmax(Q1 K1^T) - lambda softmax(Q2 K2^T), with lambda
reparameterized as exp(lambda_q1 . lambda_k1) - exp(lambda_q2 . lambda_k2)
+ lambda_init (or exp(lambda_a) - exp(lambda_b) + lambda_init with
``dual_lambda``), lambda_init = 0.8 - 0.6 exp(-0.3 depth); a per-head RMS
sub-norm over 2 head_dim channels, scaled by (1 - lambda_init).

The JAX package runs it in plain XLA with no Pallas kernel, and so does the
port: plain PyTorch on the card and on the CPU, with JAX's rounding points
(the scores taken in q's dtype and cast to fp32, the softmax over the 2H
heads in fp32, lambda in fp32, the combined attention cast to v's dtype).
A bool mask sets masked scores to fp32's min; a ``SeqPadMask`` is taken as
its dense mask. Attention dropout draws its keep mask from the module's
generator: the same rate and formula as JAX, not JAX's threefry numbers.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from .attention import maybe_add_mask
from .drop import Dropout, dropout
from .linear import Linear
from .norm import RmsNorm

__all__ = ['DiffAttention']


class DiffAttention(nn.Module):
    def __init__(
            self,
            dim: int,
            num_heads: int = 8,
            qkv_bias: bool = False,
            qk_norm: bool = False,
            scale_norm: bool = False,
            proj_bias: bool = True,
            attn_drop: float = 0.0,
            proj_drop: float = 0.0,
            norm_layer: Optional[Callable] = None,
            depth: int = 0,
            dual_lambda: bool = False,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f'dim {dim} is not divisible by num_heads {num_heads}')
        norm_layer = norm_layer or RmsNorm
        self.num_heads = num_heads
        self.head_dim = dim // num_heads // 2
        self.scale = self.head_dim ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype, generator=generator)
        self.q_norm = norm_layer(self.head_dim) if qk_norm else None
        self.k_norm = norm_layer(self.head_dim) if qk_norm else None
        self.attn_drop = Dropout(attn_drop)
        self.norm = norm_layer(dim) if scale_norm else None
        self.proj = Linear(dim, dim, bias=proj_bias, dtype=dtype, generator=generator)
        self.proj_drop = Dropout(proj_drop)

        self.dual_lambda = dual_lambda
        if dual_lambda:
            self.lambda_a = nn.Parameter(torch.zeros(()))
            self.lambda_b = nn.Parameter(torch.zeros(()))
            self.lambda_q1 = self.lambda_k1 = self.lambda_q2 = self.lambda_k2 = None
        else:
            self.lambda_a = self.lambda_b = None
            for name in ('lambda_q1', 'lambda_k1', 'lambda_q2', 'lambda_k2'):
                setattr(self, name, nn.Parameter(
                    0.1 * torch.randn(self.head_dim, generator=generator)))
        self.sub_norm = RmsNorm(2 * self.head_dim, eps=1e-5)
        self.lambda_init = 0.8 - 0.6 * math.exp(-0.3 * depth)

    def _compute_lambda(self) -> torch.Tensor:
        if self.lambda_a is not None:
            l1, l2 = torch.exp(self.lambda_a), torch.exp(self.lambda_b)
        else:
            l1 = torch.exp(torch.sum(self.lambda_q1 * self.lambda_k1))
            l2 = torch.exp(torch.sum(self.lambda_q2 * self.lambda_k2))
        return (l1 - l2 + self.lambda_init).float()

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        B, N, C = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = q.reshape(B, N, 2 * self.num_heads, self.head_dim).transpose(1, 2)
        k = k.reshape(B, N, 2 * self.num_heads, self.head_dim).transpose(1, 2)
        v = v.reshape(B, N, self.num_heads, 2 * self.head_dim).transpose(1, 2)
        if self.q_norm is not None:
            q = self.q_norm(q)
        if self.k_norm is not None:
            k = self.k_norm(k)
        lam = self._compute_lambda()

        # JAX rounds the Python scale to q's dtype before the product
        q = q * torch.tensor(self.scale, dtype=q.dtype)
        attn = (q @ k.transpose(-2, -1)).float()
        attn = maybe_add_mask(attn, attn_mask)
        attn = torch.softmax(attn, dim=-1)
        attn = dropout(attn, self.attn_drop.rate, self.training, self.attn_drop.generator)
        attn = attn.reshape(B, self.num_heads, 2, N, N)
        attn = attn[:, :, 0] - lam * attn[:, :, 1]
        x = attn.to(v.dtype) @ v

        x = self.sub_norm(x)
        x = x * (1.0 - self.lambda_init)
        x = x.transpose(1, 2).reshape(B, N, C)
        if self.norm is not None:
            x = self.norm(x)
        return self.proj_drop(self.proj(x))
