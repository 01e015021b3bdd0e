"""Latent attention pooling, the ViT's 'map' pool (counterpart of
timm_tpu/layers/attention_pool.py ``AttentionPoolLatent``).

``latent_len`` learned queries attend to the N tokens, then a residual MLP
runs over them. The attention is Nq = latent_len queries over Nk = N keys:
on the card it is the flash kernel's (``kernels/flash_attention.py`` takes
Nq != Nk). A key-padding mask over the tokens ((B, N), (B, 1, 1, N), or a
``SeqPadMask``, whose keys alone count here) keeps padded tokens out of it.
``AttentionPool2d`` and ``RotAttentionPool2d`` wait for their models
(ROADMAP A.5.9).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from .attention import SeqPadMask, scaled_dot_product_attention
from .drop import Dropout
from .linear import Linear
from .mlp import Mlp
from .norm import LayerNorm
from .weight_init import trunc_normal_

__all__ = ['AttentionPoolLatent']


class AttentionPoolLatent(nn.Module):
    def __init__(
            self,
            in_features: int,
            out_features: Optional[int] = None,
            embed_dim: Optional[int] = None,
            num_heads: int = 8,
            feat_size: Optional[int] = None,
            mlp_ratio: float = 4.0,
            qkv_bias: bool = True,
            qk_norm: bool = False,
            latent_len: int = 1,
            latent_dim: Optional[int] = None,
            pos_embed: str = '',
            pool_type: str = 'token',
            norm_layer: Optional[Callable] = None,
            act_layer: Union[str, Callable] = 'gelu',
            drop: float = 0.0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        embed_dim = embed_dim or in_features
        out_features = out_features or in_features
        if embed_dim % num_heads:
            raise ValueError(f'embed_dim {embed_dim} is not divisible by num_heads {num_heads}')
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.pool = pool_type
        self.latent_len = latent_len
        norm_layer = norm_layer or LayerNorm

        if pos_embed == 'abs':
            if feat_size is None:
                raise ValueError("pos_embed='abs' needs feat_size")
            self.pos_embed = nn.Parameter(torch.zeros(feat_size, in_features))
        else:
            self.pos_embed = None
        self.latent_dim = latent_dim or embed_dim
        self.latent = nn.Parameter(trunc_normal_(
            torch.empty(1, latent_len, embed_dim), std=in_features ** -0.5, generator=generator))
        self.q = Linear(embed_dim, embed_dim, bias=qkv_bias, dtype=dtype, generator=generator)
        self.kv = Linear(in_features, embed_dim * 2, bias=qkv_bias, dtype=dtype, generator=generator)
        self.q_norm = norm_layer(self.head_dim) if qk_norm else None
        self.k_norm = norm_layer(self.head_dim) if qk_norm else None
        self.proj = Linear(embed_dim, out_features, dtype=dtype, generator=generator)
        self.proj_drop = Dropout(drop)
        self.norm = norm_layer(out_features)
        self.mlp = Mlp(out_features, int(out_features * mlp_ratio), act_layer=act_layer,
                       dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        B, N, C = x.shape
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(x.dtype)[None]
        q_latent = self.latent.to(x.dtype).expand(B, -1, -1)
        q = self.q(q_latent).reshape(B, self.latent_len, self.num_heads, self.head_dim).transpose(1, 2)
        kv = self.kv(x).reshape(B, N, 2, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        k, v = kv.unbind(0)
        if self.q_norm is not None:
            q = self.q_norm(q)
        if self.k_norm is not None:
            k = self.k_norm(k)
        if isinstance(attn_mask, SeqPadMask):
            attn_mask = attn_mask.key_mask()  # the latent queries are never padding
        elif attn_mask is not None and attn_mask.ndim == 2:
            attn_mask = attn_mask[:, None, None, :]
        x = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=self.scale)
        x = x.transpose(1, 2).reshape(B, self.latent_len, -1)
        x = self.proj_drop(self.proj(x))
        x = x + self.mlp(self.norm(x))
        if self.pool == 'token':
            return x[:, 0]
        if self.pool == 'avg':
            return x.mean(dim=1)
        return x
