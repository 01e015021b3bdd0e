"""Multi-head attention (counterpart of timm_tpu/layers/attention.py).

Tokens are (B, N, C); q, k, v are (B, H, N, D). On a CUDA device every
attention call goes to the hand-written flash-attention kernel
(timm_tpu_torch/kernels/flash_attention.py); a call outside the kernel's
contract (dropout, an additive or per-query mask) raises rather than taking
a plain path on the card. On the CPU the plain ``_sdpa`` runs, which mirrors
the JAX package's ``_sdpa``.

q may have another length than k and v (the 'map' pool's latent queries
over the tokens, ``layers/attention_pool.py``): the flash kernel takes Nq
queries over Nk keys, so that attention runs on the card too.

The softmax policy (``config.softmax_dtype``, or a layer's
``softmax_dtype``) reaches the plain ``_sdpa`` only: the flash kernel keeps
its fp32 online softmax, as the TPU kernel does.

A padded token sequence (NaFlex batches) hands the attention a
``SeqPadMask``: the (B, L) valid vector and its mode, in place of the dense
mask the JAX package builds (``create_attention_mask``). Its keys are a
key-padding mask, which the flash kernel takes. In 'symmetric' mode the
JAX mask is (B, 1, L, L), valid query by valid key, so a padded query row
has every key masked; JAX's ``_sdpa`` then gives that row a uniform
softmax, the mean of v over all L keys. The dispatcher writes that value
into the padded query rows after the key-padding attention, on the card and
on the CPU alike, so the padded rows agree with JAX as the valid ones do.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from .config import softmax_with_policy
from .drop import Dropout, dropout
from .linear import Linear

__all__ = ['Attention', 'SeqPadMask', 'maybe_add_mask', 'scaled_dot_product_attention']


class SeqPadMask(NamedTuple):
    """The valid tokens of a padded sequence, (B, L) bool with True = a real
    token, and whether the mask is 'symmetric' (queries and keys) or
    key-only."""
    valid: torch.Tensor
    symmetric: bool = True

    def key_mask(self) -> torch.Tensor:
        """The (B, 1, 1, L) key-padding mask."""
        return self.valid[:, None, None, :]

    def dense(self) -> torch.Tensor:
        """The JAX package's mask: (B, 1, L, L) when symmetric, else
        (B, 1, 1, L)."""
        if self.symmetric:
            return self.valid[:, None, :, None] & self.valid[:, None, None, :]
        return self.key_mask()


def _fill_padded_queries(out: torch.Tensor, v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Padded query rows take the mean of v over all keys, the value of a
    row whose scores are all masked under JAX's uniform softmax."""
    mean_v = v.float().mean(dim=-2, keepdim=True).to(out.dtype)
    return torch.where(valid[:, None, :, None], out, mean_v)


def maybe_add_mask(scores: torch.Tensor, attn_mask=None) -> torch.Tensor:
    """A bool mask (True = keep) sets the other scores to the dtype's min; a
    float mask is added; a ``SeqPadMask`` is taken as its dense mask."""
    if attn_mask is None:
        return scores
    if isinstance(attn_mask, SeqPadMask):
        attn_mask = attn_mask.dense()
    if attn_mask.dtype == torch.bool:
        return torch.where(attn_mask, scores, torch.finfo(scores.dtype).min)
    return scores + attn_mask


def _sdpa(q, k, v, attn_mask=None, dropout_p: float = 0.0, scale: Optional[float] = None,
          generator: Optional[torch.Generator] = None, softmax_dtype=None):
    """Plain scaled dot-product attention on (B, H, Nq, D) queries over
    (B, H, Nk, D) keys and values; dropout on the probabilities draws from
    ``generator``; the softmax follows the policy (``softmax_dtype`` per
    call)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    # JAX rounds a Python scalar to q's dtype before the product; so does a
    # 0-dim tensor of that dtype here
    q = q * torch.tensor(scale, dtype=q.dtype)
    attn = q @ k.transpose(-2, -1)
    attn = maybe_add_mask(attn, attn_mask)
    attn = softmax_with_policy(attn, dim=-1, dtype=softmax_dtype).to(q.dtype)
    attn = dropout(attn, dropout_p, training=True, generator=generator)
    return attn @ v


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p: float = 0.0,
                                 scale: Optional[float] = None,
                                 generator: Optional[torch.Generator] = None,
                                 softmax_dtype=None):
    """Dispatcher over (B, H, Nq, D) q and (B, H, Nk, D) k, v: the flash
    kernel on a CUDA device, the plain path on the CPU. A ``SeqPadMask``
    goes to the flash kernel (its plain version on the CPU) as a
    key-padding mask, then in 'symmetric' mode its padded query rows take
    the mean of v."""
    if isinstance(attn_mask, SeqPadMask):
        if dropout_p == 0.0:
            out = flash_attention(q, k, v, mask=attn_mask.key_mask(), scale=scale)
            return _fill_padded_queries(out, v, attn_mask.valid) if attn_mask.symmetric else out
        attn_mask = attn_mask.dense()  # dropout: the plain path, as JAX's
    if q.device.type != 'cuda':
        return _sdpa(q, k, v, attn_mask, dropout_p, scale, generator, softmax_dtype)
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
    """Standard multi-head self-attention with a fused qkv projection,
    optional qk-norm (``norm_layer`` over the head dim) and optional
    ``scale_norm`` (``norm_layer`` over the merged heads before ``proj``),
    both without a dtype, as in JAX."""

    def __init__(
            self,
            dim: int,
            num_heads: int = 8,
            qkv_bias: bool = False,
            qk_norm: bool = False,
            proj_bias: bool = True,
            attn_drop: float = 0.0,
            proj_drop: float = 0.0,
            norm_layer: Optional[Callable] = None,
            scale_norm: bool = False,
            softmax_dtype=None,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f'dim {dim} is not divisible by num_heads {num_heads}')
        if (qk_norm or scale_norm) and norm_layer is None:
            raise ValueError('norm_layer must be provided if qk_norm or scale_norm is True')
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.softmax_dtype = softmax_dtype  # this layer's policy override
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype, generator=generator)
        self.q_norm = norm_layer(self.head_dim) if qk_norm else None
        self.k_norm = norm_layer(self.head_dim) if qk_norm else None
        self.attn_drop = Dropout(attn_drop)
        self.norm = norm_layer(dim) if scale_norm else None
        self.proj = Linear(dim, dim, bias=proj_bias, dtype=dtype, generator=generator)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # strided (B, H, N, D) views of the projection
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        dropout_p = self.attn_drop.rate if self.training else 0.0
        x = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
                                         scale=self.scale, generator=self.attn_drop.generator,
                                         softmax_dtype=self.softmax_dtype)
        x = x.transpose(1, 2).reshape(B, N, C)
        if self.norm is not None:
            x = self.norm(x)
        return self.proj_drop(self.proj(x))
