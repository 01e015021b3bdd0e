"""Vision Transformer (counterpart of timm_tpu/models/vision_transformer.py).

The JAX module as a whole: the blocks (``Block``, ``ResPostBlock``,
``ParallelScalingBlock``, ``DiffParallelScalingBlock``,
``ParallelThingsBlock``), ``VisionTransformer`` with every constructor
argument of the JAX class (pre / final / fc norm, qk-norm, the scale
norms, learned or no position embedding, ``no_embed_class``, register
tokens, the embed / block / MLP / attention / norm / act layers, patch
dropout, ``fix_init``, dynamic image size and padding, the token pad
``pad_tokens_to`` and the pools '', 'token', 'avg', 'avgmax', 'max' and
'map'), the model contract (forward_features / forward_head / forward,
``forward_intermediates``, ``prune_intermediate_layers``,
``set_input_size``, get / reset_classifier, ``set_grad_checkpointing``,
``set_block_scan``, no_weight_decay, group_matcher) and all 157
entrypoints with their cfgs, copied from the JAX module.

Input is NHWC, as in the JAX package. With ``dtype=torch.bfloat16`` the
casts follow the JAX model: the patch embedding, blocks, pool and head
compute in bf16; the class, register and position embeddings are cast to
the token dtype; the norms built without a dtype in JAX (``norm_pre``, the
final ``norm`` / ``fc_norm``, the qk-norms, the scale norms, the parallel
blocks' branch norms) get none here either, so on a bf16 input they return
fp32 (flax's promotion with fp32 parameters) and the next layer casts back.

Gradient checkpointing (``set_grad_checkpointing``) recomputes each block
in the backward pass through ``checkpoint_seq`` when no attention mask is
given, as JAX runs it (an external or token-pad mask runs the plain loop).
Block scan (``set_block_scan``, ``block_scan=``) is accepted and runs the
same loop: a CUDA graph captures the step once, so there is no per-step
trace to save.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..layers import (
    Attention, AttentionPoolLatent, DiffAttention, DropPath, Dropout, LayerNorm, LayerScale,
    Linear, Mlp, PatchDropout, PatchEmbed, RmsNorm, SwiGLU, SwiGLUPacked,
    calculate_drop_path_rates, get_act_fn, get_norm_layer, global_pool_nlc, maybe_add_mask,
    resample_abs_pos_embed, scaled_dot_product_attention, trunc_normal_,
)
from ._builder import build_model_with_cfg
from ._features import feature_take_indices
from ._manipulate import checkpoint_seq
from ._registry import generate_default_cfgs, register_model

__all__ = ['VisionTransformer', 'Block', 'ResPostBlock', 'ParallelScalingBlock',
           'DiffParallelScalingBlock', 'ParallelThingsBlock']


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(
            self,
            dim: int,
            num_heads: int,
            mlp_ratio: float = 4.0,
            qkv_bias: bool = False,
            qk_norm: bool = False,
            scale_attn_norm: bool = False,
            scale_mlp_norm: bool = False,
            proj_bias: bool = True,
            proj_drop: float = 0.0,
            attn_drop: float = 0.0,
            init_values: Optional[float] = None,
            drop_path: float = 0.0,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Callable = LayerNorm,
            mlp_layer: Callable = Mlp,
            attn_layer: Optional[Callable] = None,
            depth: int = 0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        attn_layer = attn_layer or Attention
        self.norm1 = norm_layer(dim, dtype=dtype)
        self.attn = attn_layer(dim, num_heads=num_heads, qkv_bias=qkv_bias, qk_norm=qk_norm,
                               scale_norm=scale_attn_norm, proj_bias=proj_bias,
                               attn_drop=attn_drop, proj_drop=proj_drop, norm_layer=norm_layer,
                               dtype=dtype, generator=generator)
        self.ls1 = LayerScale(dim, init_values=init_values) if init_values else None
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = norm_layer(dim, dtype=dtype)
        self.mlp = mlp_layer(dim, hidden_features=int(dim * mlp_ratio), act_layer=act_layer,
                             norm_layer=norm_layer if scale_mlp_norm else None, drop=proj_drop,
                             bias=proj_bias, dtype=dtype, generator=generator)
        self.ls2 = LayerScale(dim, init_values=init_values) if init_values else None
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        y = self.attn(self.norm1(x), attn_mask=attn_mask)
        if self.ls1 is not None:
            y = self.ls1(y)
        x = x + self.drop_path1(y)
        y = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            y = self.ls2(y)
        return x + self.drop_path2(y)


class ResPostBlock(nn.Module):
    """Post-norm residual block: x + drop_path(norm(attn(x))), then the same
    for the MLP; with ``init_values`` the norm scales start at that value."""

    def __init__(
            self,
            dim: int,
            num_heads: int,
            mlp_ratio: float = 4.0,
            qkv_bias: bool = False,
            qk_norm: bool = False,
            scale_attn_norm: bool = False,
            scale_mlp_norm: bool = False,
            proj_bias: bool = True,
            proj_drop: float = 0.0,
            attn_drop: float = 0.0,
            init_values: Optional[float] = None,
            drop_path: float = 0.0,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Callable = LayerNorm,
            mlp_layer: Callable = Mlp,
            attn_layer: Optional[Callable] = None,
            depth: int = 0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.init_values = init_values
        attn_layer = attn_layer or Attention
        self.attn = attn_layer(dim, num_heads=num_heads, qkv_bias=qkv_bias, qk_norm=qk_norm,
                               scale_norm=scale_attn_norm, proj_bias=proj_bias,
                               attn_drop=attn_drop, proj_drop=proj_drop, norm_layer=norm_layer,
                               dtype=dtype, generator=generator)
        self.norm1 = norm_layer(dim, dtype=dtype)
        self.drop_path1 = DropPath(drop_path)
        self.mlp = mlp_layer(dim, hidden_features=int(dim * mlp_ratio), act_layer=act_layer,
                             norm_layer=norm_layer if scale_mlp_norm else None, drop=proj_drop,
                             bias=proj_bias, dtype=dtype, generator=generator)
        self.norm2 = norm_layer(dim, dtype=dtype)
        self.drop_path2 = DropPath(drop_path)
        if init_values is not None:
            with torch.no_grad():
                for norm in (self.norm1, self.norm2):
                    norm.weight.mul_(init_values)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        x = x + self.drop_path1(self.norm1(self.attn(x, attn_mask=attn_mask)))
        return x + self.drop_path2(self.norm2(self.mlp(x)))


class ParallelScalingBlock(nn.Module):
    """ViT-22B's parallel block: one projection from one norm computes the
    qkv and the MLP's hidden activations, and the attention and MLP outputs
    are summed into the residual (one fused ``out_proj`` with
    ``fuse_out_proj``)."""

    def __init__(
            self,
            dim: int,
            num_heads: int,
            mlp_ratio: float = 4.0,
            qkv_bias: bool = False,
            qk_norm: bool = False,
            scale_attn_norm: bool = False,
            scale_mlp_norm: bool = False,
            proj_bias: bool = True,
            proj_drop: float = 0.0,
            attn_drop: float = 0.0,
            init_values: Optional[float] = None,
            drop_path: float = 0.0,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Callable = LayerNorm,
            mlp_layer: Optional[Callable] = None,  # the fused design has none
            attn_layer: Optional[Callable] = None,  # the fused design has none
            depth: int = 0,
            fuse_out_proj: bool = False,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f'dim {dim} is not divisible by num_heads {num_heads}')
        if scale_attn_norm or scale_mlp_norm:
            raise ValueError('ParallelScalingBlock has no scale norms')
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.mlp_hidden_dim = mlp_hidden_dim = int(mlp_ratio * dim)
        linear = partial(Linear, dtype=dtype, generator=generator)
        self.in_norm = norm_layer(dim, dtype=dtype)
        self.in_proj = linear(dim, mlp_hidden_dim + 3 * dim, bias=qkv_bias)
        # without an in_proj bias the MLP branch still has its own
        self.mlp_bias = None if qkv_bias else nn.Parameter(torch.zeros(mlp_hidden_dim))
        self.q_norm = norm_layer(self.head_dim) if qk_norm else None
        self.k_norm = norm_layer(self.head_dim) if qk_norm else None
        self.attn_drop = Dropout(attn_drop)
        self.mlp_drop = Dropout(proj_drop)
        self.mlp_act = get_act_fn(act_layer)
        if fuse_out_proj:
            self.out_proj = linear(dim + mlp_hidden_dim, dim, bias=proj_bias)
            self.attn_out_proj = self.mlp_out_proj = None
        else:
            self.out_proj = None
            self.attn_out_proj = linear(dim, dim, bias=proj_bias)
            self.mlp_out_proj = linear(mlp_hidden_dim, dim, bias=proj_bias)
        self.ls = LayerScale(dim, init_values=init_values) if init_values is not None else None
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        B, N, C = x.shape
        y = self.in_proj(self.in_norm(x))
        x_mlp, qkv = y.split([self.mlp_hidden_dim, 3 * C], dim=-1)
        if self.mlp_bias is not None:
            x_mlp = x_mlp + self.mlp_bias.to(x_mlp.dtype)
        q, k, v = qkv.reshape(B, N, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4).unbind(0)
        if self.q_norm is not None:
            q = self.q_norm(q)
        if self.k_norm is not None:
            k = self.k_norm(k)
        dropout_p = self.attn_drop.rate if self.training else 0.0
        x_attn = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
                                              scale=self.scale, generator=self.attn_drop.generator)
        x_attn = x_attn.transpose(1, 2).reshape(B, N, C)
        x_mlp = self.mlp_drop(self.mlp_act(x_mlp))
        if self.out_proj is not None:
            y = self.out_proj(torch.cat([x_attn, x_mlp], dim=-1))
        else:
            y = self.attn_out_proj(x_attn) + self.mlp_out_proj(x_mlp)
        if self.ls is not None:
            y = self.ls(y)
        return x + self.drop_path(y)


class DiffParallelScalingBlock(nn.Module):
    """The parallel fused block with differential attention: two softmax
    maps of half-width heads, the second scaled by a learned lambda and
    subtracted, each head RMS-normed, then one fused output projection. Its
    attention is plain PyTorch, as JAX's is plain XLA."""

    def __init__(
            self,
            dim: int,
            num_heads: int,
            mlp_ratio: float = 4.0,
            qkv_bias: bool = False,
            qk_norm: bool = False,
            scale_attn_norm: bool = False,
            scale_mlp_norm: bool = False,
            proj_bias: bool = True,
            proj_drop: float = 0.0,
            attn_drop: float = 0.0,
            init_values: Optional[float] = None,
            drop_path: float = 0.0,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Callable = LayerNorm,
            mlp_layer: Optional[Callable] = None,
            attn_layer: Optional[Callable] = None,
            depth: int = 0,
            dual_lambda: bool = False,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f'dim {dim} is not divisible by num_heads {num_heads}')
        if scale_attn_norm or scale_mlp_norm:
            raise ValueError('DiffParallelScalingBlock has no scale norms')
        self.num_heads = num_heads
        self.head_dim = dim // num_heads // 2  # half-width q / k heads
        self.scale = self.head_dim ** -0.5
        self.mlp_hidden_dim = mlp_hidden_dim = int(mlp_ratio * dim)
        linear = partial(Linear, dtype=dtype, generator=generator)
        self.in_norm = norm_layer(dim, dtype=dtype)
        self.in_proj = linear(dim, mlp_hidden_dim + 3 * dim, bias=qkv_bias)
        self.mlp_bias = None if qkv_bias else nn.Parameter(torch.zeros(mlp_hidden_dim))
        self.q_norm = norm_layer(self.head_dim) if qk_norm else None
        self.k_norm = norm_layer(self.head_dim) if qk_norm else None
        self.attn_drop = Dropout(attn_drop)
        self.sub_norm = RmsNorm(2 * self.head_dim, eps=1e-5)
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
        self.mlp_drop = Dropout(proj_drop)
        self.mlp_act = get_act_fn(act_layer)
        self.out_proj = linear(dim + mlp_hidden_dim, dim, bias=proj_bias)
        self.ls = LayerScale(dim, init_values=init_values) if init_values is not None else None
        self.drop_path = DropPath(drop_path)
        self.lambda_init = 0.8 - 0.6 * math.exp(-0.3 * depth)

    def _compute_lambda(self) -> torch.Tensor:
        if self.lambda_a is not None:
            l1, l2 = torch.exp(self.lambda_a), torch.exp(self.lambda_b)
        else:
            l1 = torch.exp(torch.sum(self.lambda_q1 * self.lambda_k1))
            l2 = torch.exp(torch.sum(self.lambda_q2 * self.lambda_k2))
        return l1 - l2 + self.lambda_init

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        B, N, C = x.shape
        y = self.in_proj(self.in_norm(x))
        x_mlp, qkv = y.split([self.mlp_hidden_dim, 3 * C], dim=-1)
        if self.mlp_bias is not None:
            x_mlp = x_mlp + self.mlp_bias.to(x_mlp.dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        q = q.reshape(B, N, 2 * self.num_heads, self.head_dim).transpose(1, 2)
        k = k.reshape(B, N, 2 * self.num_heads, self.head_dim).transpose(1, 2)
        v = v.reshape(B, N, self.num_heads, 2 * self.head_dim).transpose(1, 2)
        if self.q_norm is not None:
            q = self.q_norm(q)
        if self.k_norm is not None:
            k = self.k_norm(k)
        lam = self._compute_lambda().to(q.dtype)
        # the scale rounded to q's dtype first, as JAX rounds a Python scalar
        attn = (q * torch.tensor(self.scale, dtype=q.dtype)) @ k.transpose(-2, -1)
        attn = maybe_add_mask(attn, attn_mask)
        attn = torch.softmax(attn, dim=-1)  # in q's dtype, as jax.nn.softmax
        attn = self.attn_drop(attn)
        attn = attn.reshape(B, self.num_heads, 2, N, N)
        attn = attn[:, :, 0] - lam * attn[:, :, 1]
        x_attn = self.sub_norm(attn @ v) * (1 - self.lambda_init)
        x_attn = x_attn.transpose(1, 2).reshape(B, N, C)
        x_mlp = self.mlp_drop(self.mlp_act(x_mlp))
        y = self.out_proj(torch.cat([x_attn, x_mlp.to(x_attn.dtype)], dim=-1))
        if self.ls is not None:
            y = self.ls(y)
        return x + self.drop_path(y)


class _AttnBranch(nn.Module):
    """norm -> attn -> layer scale -> drop path, a branch of
    ParallelThingsBlock (the JAX names ``attns.N.{norm,attn,ls}``)."""

    def __init__(self, dim: int, attn_cls: Callable, norm_cls: Callable,
                 init_values: Optional[float], drop_path: float, **attn_kwargs):
        super().__init__()
        self.norm = norm_cls(dim)
        self.attn = attn_cls(dim, **attn_kwargs)
        self.ls = LayerScale(dim, init_values=init_values) if init_values else None
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        y = self.attn(self.norm(x), attn_mask=attn_mask)
        if self.ls is not None:
            y = self.ls(y)
        return self.drop_path(y)


class _FfnBranch(nn.Module):
    """norm -> mlp -> layer scale -> drop path, a branch of
    ParallelThingsBlock."""

    def __init__(self, dim: int, mlp_layer: Callable, norm_cls: Callable,
                 init_values: Optional[float], drop_path: float, **mlp_kwargs):
        super().__init__()
        self.norm = norm_cls(dim)
        self.mlp = mlp_layer(dim, **mlp_kwargs)
        self.ls = LayerScale(dim, init_values=init_values) if init_values else None
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp(self.norm(x))
        if self.ls is not None:
            y = self.ls(y)
        return self.drop_path(y)


class ParallelThingsBlock(nn.Module):
    """'Three things' block: ``num_parallel`` attentions summed into the
    residual, then ``num_parallel`` MLPs."""

    def __init__(
            self,
            dim: int,
            num_heads: int,
            num_parallel: int = 2,
            mlp_ratio: float = 4.0,
            qkv_bias: bool = False,
            qk_norm: bool = False,
            scale_attn_norm: bool = False,
            scale_mlp_norm: bool = False,
            proj_bias: bool = True,
            init_values: Optional[float] = None,
            proj_drop: float = 0.0,
            attn_drop: float = 0.0,
            drop_path: float = 0.0,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Callable = LayerNorm,
            mlp_layer: Callable = Mlp,
            attn_layer: Optional[Callable] = None,
            depth: int = 0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        attn_cls = attn_layer or Attention
        self.num_parallel = num_parallel
        self.attns = nn.ModuleList([
            _AttnBranch(dim, attn_cls, norm_layer, init_values, drop_path, num_heads=num_heads,
                        qkv_bias=qkv_bias, qk_norm=qk_norm, scale_norm=scale_attn_norm,
                        proj_bias=proj_bias, attn_drop=attn_drop, proj_drop=proj_drop,
                        norm_layer=norm_layer, dtype=dtype, generator=generator)
            for _ in range(num_parallel)])
        self.ffns = nn.ModuleList([
            _FfnBranch(dim, mlp_layer, norm_layer, init_values, drop_path,
                       hidden_features=int(dim * mlp_ratio), act_layer=act_layer,
                       norm_layer=norm_layer if scale_mlp_norm else None, bias=proj_bias,
                       drop=proj_drop, dtype=dtype, generator=generator)
            for _ in range(num_parallel)])

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        x = x + sum(attn(x, attn_mask=attn_mask) for attn in self.attns)
        return x + sum(ffn(x) for ffn in self.ffns)


_POOL_TYPES = ('', 'avg', 'avgmax', 'max', 'token', 'map')


class VisionTransformer(nn.Module):
    """ViT with the JAX package's model contract."""

    def __init__(
            self,
            img_size: Union[int, Tuple[int, int]] = 224,
            patch_size: Union[int, Tuple[int, int]] = 16,
            in_chans: int = 3,
            num_classes: int = 1000,
            global_pool: str = 'token',
            embed_dim: int = 768,
            depth: int = 12,
            num_heads: int = 12,
            mlp_ratio: float = 4.0,
            qkv_bias: bool = True,
            qk_norm: bool = False,
            scale_attn_norm: bool = False,
            scale_mlp_norm: bool = False,
            proj_bias: bool = True,
            init_values: Optional[float] = None,
            class_token: bool = True,
            pos_embed: str = 'learn',
            no_embed_class: bool = False,
            reg_tokens: int = 0,
            pre_norm: bool = False,
            final_norm: bool = True,
            fc_norm: Optional[bool] = None,
            dynamic_img_size: bool = False,
            dynamic_img_pad: bool = False,
            drop_rate: float = 0.0,
            pos_drop_rate: float = 0.0,
            patch_drop_rate: float = 0.0,
            proj_drop_rate: float = 0.0,
            attn_drop_rate: float = 0.0,
            drop_path_rate: float = 0.0,
            weight_init: str = '',
            fix_init: bool = False,
            embed_layer: Callable = PatchEmbed,
            embed_norm_layer: Optional[Union[str, Callable]] = None,
            norm_layer: Optional[Union[str, Callable]] = None,
            act_layer: Optional[Union[str, Callable]] = None,
            block_fn: Callable = Block,
            mlp_layer: Callable = Mlp,
            attn_layer: Optional[Union[str, Callable]] = None,
            pad_tokens_to: Optional[Union[int, str]] = None,
            block_scan: Optional[bool] = None,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if global_pool not in _POOL_TYPES:
            raise ValueError(f'global_pool {global_pool!r} is not one of {_POOL_TYPES}')
        if not class_token and global_pool == 'token':
            raise ValueError("global_pool='token' needs a class token")
        if pos_embed not in ('', 'none', 'learn'):
            raise ValueError(f'pos_embed {pos_embed!r} is not one of "", "none", "learn"')
        norm_layer = get_norm_layer(norm_layer) or LayerNorm
        act_layer = act_layer or 'gelu'

        # token pad: 'auto' rounds N up to a multiple of 8, an int pads to
        # exactly that length; pad keys are masked out of every attention and
        # stripped again before the head
        if pad_tokens_to is not None and pad_tokens_to != 'auto':
            pad_tokens_to = int(pad_tokens_to) or None
        if pad_tokens_to is not None and patch_drop_rate > 0:
            raise ValueError('pad_tokens_to is incompatible with patch_drop_rate > 0: patch '
                             'dropout re-indexes the token sequence, invalidating the pad mask')
        self.pad_tokens_to = pad_tokens_to

        self.num_classes = num_classes
        self.global_pool = global_pool
        self.num_features = self.head_hidden_size = self.embed_dim = embed_dim
        self.num_prefix_tokens = (1 if class_token else 0) + reg_tokens
        self.num_reg_tokens = reg_tokens
        self.has_class_token = class_token
        self.no_embed_class = no_embed_class
        self.dynamic_img_size = dynamic_img_size
        self.grad_checkpointing = False
        self.block_scan = bool(block_scan)
        self.depth = depth
        self._dtype = dtype

        embed_args = {}
        if dynamic_img_size:
            embed_args['strict_img_size'] = False
        if embed_norm_layer is not None:
            embed_args['norm_layer'] = get_norm_layer(embed_norm_layer)
        self.patch_embed = embed_layer(
            img_size=img_size, patch_size=patch_size, in_chans=in_chans, embed_dim=embed_dim,
            bias=not pre_norm,  # pre-norm (CLIP) ViTs have no patch-projection bias
            dynamic_img_pad=dynamic_img_pad, dtype=dtype, generator=generator, **embed_args)
        num_patches = self.patch_embed.num_patches
        reduction = self.patch_embed.patch_size[0]

        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if class_token else None
        self.reg_token = nn.Parameter(
            trunc_normal_(torch.empty(1, reg_tokens, embed_dim), std=0.02, generator=generator)
        ) if reg_tokens else None
        embed_len = num_patches if no_embed_class else num_patches + self.num_prefix_tokens
        self.pos_embed = None if not pos_embed or pos_embed == 'none' else nn.Parameter(
            trunc_normal_(torch.empty(1, embed_len, embed_dim), std=0.02, generator=generator))
        self.pos_drop = Dropout(pos_drop_rate)
        self.patch_drop = PatchDropout(patch_drop_rate, num_prefix_tokens=self.num_prefix_tokens) \
            if patch_drop_rate > 0 else None
        self.norm_pre = norm_layer(embed_dim) if pre_norm else None

        def _resolve_attn_layer(i: int):
            if attn_layer == 'diff':
                return partial(DiffAttention, depth=i)  # depth-dependent lambda_init
            return attn_layer

        dpr = calculate_drop_path_rates(drop_path_rate, depth)
        self.blocks = nn.ModuleList([
            block_fn(
                dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                qk_norm=qk_norm, scale_attn_norm=scale_attn_norm, scale_mlp_norm=scale_mlp_norm,
                proj_bias=proj_bias, init_values=init_values, proj_drop=proj_drop_rate,
                attn_drop=attn_drop_rate, drop_path=dpr[i], norm_layer=norm_layer,
                act_layer=act_layer, mlp_layer=mlp_layer, attn_layer=_resolve_attn_layer(i),
                depth=i, dtype=dtype, generator=generator)
            for i in range(depth)])
        self.feature_info = [dict(module=f'blocks.{i}', num_chs=embed_dim, reduction=reduction)
                             for i in range(depth)]

        # feature norm (pre-pool), or fc norm (post-pool) for average pooling;
        # neither gets a dtype, as in JAX
        if fc_norm is None:
            fc_norm = global_pool == 'avg'
        self.norm = norm_layer(embed_dim) if final_norm and not fc_norm else None
        self.attn_pool = AttentionPoolLatent(
            embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio, norm_layer=norm_layer,
            dtype=dtype, generator=generator) if global_pool == 'map' else None
        self.fc_norm = norm_layer(embed_dim) if final_norm and fc_norm else None
        self.head_drop = Dropout(drop_rate)
        self.head = Linear(embed_dim, num_classes, dtype=dtype, generator=generator) \
            if num_classes > 0 else None
        if fix_init:
            self.fix_init_weight()

    def fix_init_weight(self) -> None:
        """Divide each block's attention and MLP output projections by
        sqrt(2 (layer + 1))."""
        with torch.no_grad():
            for layer_id, block in enumerate(self.blocks):
                scale = math.sqrt(2.0 * (layer_id + 1))
                block.attn.proj.weight.div_(scale)
                block.mlp.fc2.weight.div_(scale)

    # ---- contract methods -------------------------------------------------
    def no_weight_decay(self) -> set:
        return {'pos_embed', 'cls_token', 'reg_token', 'dist_token'}

    def group_matcher(self, coarse: bool = False) -> Dict:
        return dict(
            stem=r'^cls_token|pos_embed|patch_embed|reg_token',
            blocks=[(r'^blocks\.(\d+)', None), (r'^norm', (99999,))],
        )

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.grad_checkpointing = enable

    def set_block_scan(self, enable: bool = True) -> None:
        """Accepted for the JAX contract; the block loop runs either way
        (see the module docstring)."""
        self.block_scan = enable

    def get_classifier(self) -> Optional[nn.Module]:
        return self.head

    def _device(self) -> torch.device:
        return self.patch_embed.proj.weight.device

    def reset_classifier(self, num_classes: int, global_pool: Optional[str] = None,
                         generator: Optional[torch.Generator] = None):
        self.num_classes = num_classes
        if global_pool is not None:
            if global_pool not in _POOL_TYPES:
                raise ValueError(f'global_pool {global_pool!r} is not one of {_POOL_TYPES}')
            if global_pool == 'map' and self.attn_pool is None:
                raise ValueError('cannot add attention pooling in reset_classifier()')
            if global_pool != 'map':
                self.attn_pool = None
            self.global_pool = global_pool
        self.head = Linear(self.embed_dim, num_classes, dtype=self._dtype,
                           generator=generator).to(self._device()) if num_classes > 0 else None

    def set_input_size(self, img_size=None, patch_size=None) -> None:
        """A new static input size: the learned position embedding is
        resampled to the new grid (``resample_abs_pos_embed``)."""
        if img_size is None:
            return
        prev_grid = self.patch_embed.grid_size
        self.patch_embed.set_input_size(img_size=img_size, patch_size=patch_size)
        new_grid = self.patch_embed.grid_size
        if self.pos_embed is not None and new_grid != prev_grid:
            with torch.no_grad():
                self.pos_embed = nn.Parameter(resample_abs_pos_embed(
                    self.pos_embed, new_size=new_grid, old_size=prev_grid,
                    num_prefix_tokens=0 if self.no_embed_class else self.num_prefix_tokens))

    # ---- forward ----------------------------------------------------------
    def _resolve_pad_len(self, n: int, pad_tokens_to=None) -> int:
        """Padded sequence length for an n-token sequence (n when no pad)."""
        pad = pad_tokens_to if pad_tokens_to is not None else self.pad_tokens_to
        if not pad:
            return n
        if pad == 'auto':
            return -(-n // 8) * 8
        target = int(pad)
        if target < n:
            raise ValueError(f'pad_tokens_to={target} is smaller than the token count {n}')
        return target

    def _prefix_tokens(self, x: torch.Tensor) -> List[torch.Tensor]:
        B = x.shape[0]
        prefix = []
        if self.cls_token is not None:
            prefix.append(self.cls_token.to(x.dtype).expand(B, -1, -1))
        if self.reg_token is not None:
            prefix.append(self.reg_token.to(x.dtype).expand(B, -1, -1))
        return prefix

    def _pos_embed(self, x: torch.Tensor, grid_size: Optional[Tuple[int, int]] = None,
                   pad_tokens_to=None):
        """Prefix tokens + position embedding (resampled to ``grid_size``
        under ``dynamic_img_size``), then the optional token pad. Returns
        (tokens, key-padding mask or None, unpadded length)."""
        pos_embed = None
        if self.pos_embed is not None:
            pos_embed = self.pos_embed.to(x.dtype)
            if self.dynamic_img_size and grid_size is not None \
                    and tuple(grid_size) != tuple(self.patch_embed.grid_size):
                pos_embed = resample_abs_pos_embed(
                    pos_embed, new_size=grid_size, old_size=self.patch_embed.grid_size,
                    num_prefix_tokens=0 if self.no_embed_class else self.num_prefix_tokens)
        prefix = self._prefix_tokens(x)
        if self.no_embed_class:
            if pos_embed is not None:
                x = x + pos_embed
            x = torch.cat(prefix + [x], dim=1) if prefix else x
        else:
            x = torch.cat(prefix + [x], dim=1) if prefix else x
            if pos_embed is not None:
                x = x + pos_embed
        return self._pad_token_seq(self.pos_drop(x), pad_tokens_to)

    def _pad_token_seq(self, x: torch.Tensor, pad_tokens_to=None):
        B, n = x.shape[0], x.shape[1]
        n_pad = self._resolve_pad_len(n, pad_tokens_to)
        if n_pad == n:
            return x, None, n
        x = torch.cat([x, x.new_zeros(B, n_pad - n, x.shape[2])], dim=1)
        # key-padding mask, True = real token, broadcast over heads and queries
        mask = (torch.arange(n_pad, device=x.device) < n).expand(B, 1, 1, n_pad)
        return x, mask, n

    def _embed(self, x: torch.Tensor, pad_tokens_to=None):
        """Patch embedding through ``norm_pre``: (tokens, pad mask, unpadded
        length, token grid)."""
        grid_size = self.patch_embed.dynamic_feat_size(x.shape[1:3]) if self.dynamic_img_size \
            else self.patch_embed.grid_size
        x = self.patch_embed(x)
        x, pad_mask, orig_len = self._pos_embed(
            x, grid_size=grid_size if self.dynamic_img_size else None,
            pad_tokens_to=pad_tokens_to)
        if self.patch_drop is not None:
            x = self.patch_drop(x)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        return x, pad_mask, orig_len, grid_size

    def forward_features(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # an external attn_mask is sized for the unpadded sequence, so the
        # token pad is skipped for that call
        x, pad_mask, orig_len, _ = self._embed(x, pad_tokens_to=0 if attn_mask is not None else None)
        if pad_mask is not None:
            attn_mask = pad_mask
        if self.grad_checkpointing and attn_mask is None:
            x = checkpoint_seq(self.blocks, x)
        else:
            for blk in self.blocks:
                x = blk(x, attn_mask=attn_mask)
        if self.norm is not None:
            x = self.norm(x)
        if x.shape[1] != orig_len:
            x = x[:, :orig_len]  # strip the token pad before the head
        return x

    def pool(self, x: torch.Tensor, pool_type: Optional[str] = None, mask=None) -> torch.Tensor:
        """``mask`` (an optional key-padding mask, True = valid) pools a
        still-padded sequence; the forward strips the pad first and passes
        None."""
        if self.attn_pool is not None:
            return self.attn_pool(x, attn_mask=mask)
        pool_type = self.global_pool if pool_type is None else pool_type
        return global_pool_nlc(x, pool_type=pool_type, num_prefix_tokens=self.num_prefix_tokens, mask=mask)

    def forward_head(self, x: torch.Tensor, pre_logits: bool = False) -> torch.Tensor:
        x = self.pool(x)
        if self.fc_norm is not None:
            x = self.fc_norm(x)
        x = self.head_drop(x)
        if pre_logits or self.head is None:
            return x
        return self.head(x)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_head(self.forward_features(x, attn_mask=attn_mask))

    # ---- intermediates ----------------------------------------------------
    def forward_intermediates(
            self,
            x: torch.Tensor,
            indices: Optional[Union[int, List[int]]] = None,
            return_prefix_tokens: bool = False,
            norm: bool = False,
            stop_early: bool = False,
            output_fmt: str = 'NHWC',
            intermediates_only: bool = False,
            attn_mask=None,
    ):
        """The blocks' outputs at ``indices`` (an int n: the last n), with
        the prefix tokens split off (``return_prefix_tokens`` pairs them
        back), each through the final norm with ``norm``, as NHWC grids or
        NLC tokens; and the final features unless ``intermediates_only``.
        No token pad runs here. ``stop_early`` runs no block past the last
        index."""
        if output_fmt not in ('NHWC', 'NLC'):
            raise ValueError('output_fmt must be NHWC or NLC')
        take_indices, max_index = feature_take_indices(len(self.blocks), indices)
        B = x.shape[0]
        x, _, _, grid_size = self._embed(x, pad_tokens_to=0)
        blocks = self.blocks[:max_index + 1] if stop_early else self.blocks
        intermediates = []
        for i, blk in enumerate(blocks):
            x = blk(x, attn_mask=attn_mask)
            if i in take_indices:
                intermediates.append(self.norm(x) if norm and self.norm is not None else x)
        prefix_tokens = None
        if self.num_prefix_tokens:
            prefix_tokens = [y[:, :self.num_prefix_tokens] for y in intermediates]
            intermediates = [y[:, self.num_prefix_tokens:] for y in intermediates]
        if output_fmt == 'NHWC':
            intermediates = [y.reshape(B, grid_size[0], grid_size[1], -1) for y in intermediates]
        if return_prefix_tokens and prefix_tokens is not None:
            intermediates = list(zip(intermediates, prefix_tokens))
        if intermediates_only:
            return intermediates
        if self.norm is not None:
            x = self.norm(x)
        return x, intermediates

    def prune_intermediate_layers(self, indices: Union[int, List[int]] = 1,
                                  prune_norm: bool = False, prune_head: bool = True):
        """Keep the blocks up to the last of ``indices``; drop the final
        norm (``prune_norm``) and the pool and head (``prune_head``).
        Returns the absolute indices."""
        take_indices, max_index = feature_take_indices(len(self.blocks), indices)
        self.blocks = self.blocks[:max_index + 1]
        if prune_norm:
            self.norm = None
        if prune_head:
            self.fc_norm = None
            self.attn_pool = None
            self.reset_classifier(0, '')
        return take_indices


def _cfg(url: str = '', **kwargs) -> Dict[str, Any]:
    return {
        'url': url,
        'num_classes': 1000,
        'input_size': (3, 224, 224),
        'pool_size': None,
        'crop_pct': 0.9,
        'interpolation': 'bicubic',
        'fixed_input_size': True,
        'mean': (0.5, 0.5, 0.5),
        'std': (0.5, 0.5, 0.5),
        'first_conv': 'patch_embed.proj',
        'classifier': 'head',
        **kwargs,
    }


default_cfgs = generate_default_cfgs({
    'vit_tiny_patch16_224.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/'),
    'vit_tiny_patch16_384.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_small_patch32_224.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/'),
    'vit_small_patch16_224.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/'),
    'vit_small_patch16_384.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_base_patch32_224.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/'),
    'vit_base_patch16_224.augreg2_in21k_ft_in1k': _cfg(hf_hub_id='timm/'),
    'vit_base_patch16_224.augreg_in1k': _cfg(hf_hub_id='timm/'),
    'vit_base_patch16_384.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_base_patch8_224.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/'),
    'vit_large_patch16_224.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/'),
    'vit_dlittle_patch16_reg1_gap_256.sbb_nadamuon_in1k': _cfg(
        hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_little_patch16_reg4_gap_256.sbb_in1k': _cfg(
        hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_medium_patch16_reg4_gap_256.sbb_in12k_ft_in1k': _cfg(
        hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_large_patch14_224.untrained': _cfg(url=''),
    'vit_huge_patch14_224.untrained': _cfg(url=''),
    'vit_so400m_patch14_siglip_224.untrained': _cfg(url=''),
    'vit_tiny_patch16_224.untrained': _cfg(url=''),
    # tiny test fixtures (reference vision_transformer.py:4802-4833)
    'vit_small_patch32_384.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_small_patch8_224.dino': _cfg(hf_hub_id='timm/', num_classes=0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_base_patch32_384.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_base_patch32_384.augreg_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_large_patch32_224.orig_in21k': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_large_patch32_384.orig_in21k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_large_patch16_384.augreg_in21k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_giant_patch14_224.untrained': _cfg(),
    'vit_gigantic_patch14_224.untrained': _cfg(),
    'vit_base_patch16_224_miil.in21k': _cfg(hf_hub_id='timm/', num_classes=11221, crop_pct=0.875, interpolation='bilinear', mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    'vit_base_patch16_224_miil.in21k_ft_in1k': _cfg(hf_hub_id='timm/', crop_pct=0.875, interpolation='bilinear', mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    'vit_medium_patch16_gap_240.sw_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 240, 240), crop_pct=0.95),
    'vit_medium_patch16_gap_256.sw_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_medium_patch16_gap_384.sw_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=0.95, crop_mode='squash'),
    'vit_betwixt_patch16_gap_256.untrained': _cfg(input_size=(3, 256, 256), crop_pct=0.95),
    'vit_base_patch16_gap_224.untrained': _cfg(),
    'vit_huge_patch14_gap_224.in1k_ijepa': _cfg(num_classes=0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_huge_patch14_gap_224.in22k_ijepa': _cfg(num_classes=0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_huge_patch16_gap_448.in1k_ijepa': _cfg(num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_giant_patch16_gap_224.in22k_ijepa': _cfg(num_classes=0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_xsmall_patch16_clip_224.tinyclip_yfcc15m': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_medium_patch32_clip_224.tinyclip_laion400m': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_medium_patch16_clip_224.tinyclip_yfcc15m': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_betwixt_patch32_clip_224.tinyclip_laion400m': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.laion2b_ft_in12k_in1k': _cfg(hf_hub_id='timm/', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.openai_ft_in12k_in1k': _cfg(mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.laion2b_ft_in1k': _cfg(hf_hub_id='timm/', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.openai_ft_in1k': _cfg(hf_hub_id='timm/', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.laion2b': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.laion400m_e32': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.datacompxl': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.metaclip_400m': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_224.openai': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_256.datacompxl': _cfg(hf_hub_id='timm/', num_classes=512, input_size=(3, 256, 256), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_384.laion2b_ft_in12k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_384.openai_ft_in12k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=0.95, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_448.laion2b_ft_in12k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 448, 448), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.laion2b_ft_in12k_in1k': _cfg(hf_hub_id='timm/', crop_pct=0.95, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.openai_ft_in12k_in1k': _cfg(hf_hub_id='timm/', crop_pct=0.95, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.laion2b_ft_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.openai_ft_in1k': _cfg(hf_hub_id='timm/', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.laion2b_ft_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.openai_ft_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.laion2b': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.laion400m_e32': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.datacompxl': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.dfn2b': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.metaclip_400m': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_224.openai': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_384.laion2b_ft_in12k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_384.openai_ft_in12k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=0.95, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_384.laion2b_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_384.openai_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_plus_clip_240.laion400m_e32': _cfg(hf_hub_id='timm/', num_classes=640, input_size=(3, 240, 240), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.laion2b_ft_in12k_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0),
    'vit_large_patch14_clip_224.openai_ft_in12k_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.laion2b_ft_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0),
    'vit_large_patch14_clip_224.openai_ft_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.laion2b_ft_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, crop_pct=1.0),
    'vit_large_patch14_clip_224.openai_ft_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.laion2b': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0),
    'vit_large_patch14_clip_224.laion400m_e32': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.datacompxl': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.dfn2b_s39b': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.dfn2b': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.metaclip_400m': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.openai': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_224.apple_mclip2_dfndr2b': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_336.laion2b_ft_in12k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 336, 336), crop_pct=1.0, crop_mode='squash'),
    'vit_large_patch14_clip_336.openai_ft_in12k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 336, 336), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_336.laion2b_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 336, 336), crop_pct=1.0, crop_mode='squash'),
    'vit_large_patch14_clip_336.openai': _cfg(hf_hub_id='timm/', num_classes=768, input_size=(3, 336, 336), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_224.laion2b_ft_in12k_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_224.laion2b_ft_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_224.laion2b_ft_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_224.laion2b': _cfg(hf_hub_id='timm/', num_classes=1024, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_224.dfn5b': _cfg(hf_hub_id='timm/', num_classes=1024, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_224.metaclip2_worldwide': _cfg(hf_hub_id='timm/', num_classes=1024, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=1024, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_224.metaclip_altogether': _cfg(hf_hub_id='timm/', num_classes=1024, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_336.laion2b_ft_in12k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 336, 336), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_336.laion2b_ft_in1k': _cfg(input_size=(3, 336, 336), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_378.dfn5b': _cfg(hf_hub_id='timm/', num_classes=1024, input_size=(3, 378, 378), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_378.metaclip2_worldwide': _cfg(hf_hub_id='timm/', num_classes=1024, input_size=(3, 378, 378), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_giant_patch14_clip_224.laion2b': _cfg(hf_hub_id='timm/', num_classes=1024, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_gigantic_patch14_clip_224.laion2b': _cfg(hf_hub_id='timm/', num_classes=1280, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_gigantic_patch14_clip_224.metaclip2_worldwide': _cfg(hf_hub_id='timm/', num_classes=1280, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_gigantic_patch14_clip_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=1280, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_gigantic_patch14_clip_378.metaclip2_worldwide': _cfg(hf_hub_id='timm/', num_classes=1280, input_size=(3, 378, 378), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_quickgelu_224.laion400m_e32': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_quickgelu_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_quickgelu_224.metaclip_400m': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_clip_quickgelu_224.openai': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_quickgelu_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_quickgelu_224.metaclip_400m': _cfg(hf_hub_id='timm/', num_classes=512, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch16_clip_quickgelu_224.openai': _cfg(hf_hub_id='timm/', num_classes=512, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_quickgelu_224.dfn2b': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_quickgelu_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_quickgelu_224.metaclip_400m': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_quickgelu_224.openai': _cfg(hf_hub_id='timm/', num_classes=768, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_large_patch14_clip_quickgelu_336.openai': _cfg(hf_hub_id='timm/', num_classes=768, input_size=(3, 336, 336), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_quickgelu_224.dfn5b': _cfg(hf_hub_id='timm/', num_classes=1024, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_quickgelu_224.metaclip2_worldwide': _cfg(hf_hub_id='timm/', num_classes=1024, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_quickgelu_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=1024, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_huge_patch14_clip_quickgelu_378.dfn5b': _cfg(hf_hub_id='timm/', num_classes=1024, input_size=(3, 378, 378), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_gigantic_patch14_clip_quickgelu_224.metaclip_2pt5b': _cfg(hf_hub_id='timm/', num_classes=1280, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'vit_base_patch32_plus_256.untrained': _cfg(input_size=(3, 256, 256), crop_pct=0.95),
    'vit_base_patch16_plus_240.untrained': _cfg(input_size=(3, 240, 240), crop_pct=0.95),
    'vit_base_patch16_rpn_224.sw_in1k': _cfg(hf_hub_id='timm/'),
    'vit_small_patch16_36x1_224.untrained': _cfg(),
    'vit_small_patch16_18x2_224.untrained': _cfg(),
    'vit_base_patch16_18x2_224.untrained': _cfg(),
    'eva_large_patch14_196.in22k_ft_in22k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 196, 196), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'eva_large_patch14_196.in22k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 196, 196), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'eva_large_patch14_336.in22k_ft_in22k_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 336, 336), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'eva_large_patch14_336.in22k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 336, 336), crop_pct=1.0, crop_mode='squash', mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'flexivit_small.1200ep_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_small.600ep_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_small.300ep_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_base.1200ep_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_base.600ep_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_base.300ep_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_base.1000ep_in21k': _cfg(hf_hub_id='timm/', num_classes=21843, input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_base.300ep_in21k': _cfg(hf_hub_id='timm/', num_classes=21843, input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_base.patch16_in21k': _cfg(hf_hub_id='timm/', num_classes=21843, input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_base.patch30_in21k': _cfg(hf_hub_id='timm/', num_classes=21843, input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_large.1200ep_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_large.600ep_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), crop_pct=0.95),
    'flexivit_large.300ep_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), crop_pct=0.95),
    'vit_base_patch16_xp_224.untrained': _cfg(),
    'vit_large_patch14_xp_224.untrained': _cfg(),
    'vit_huge_patch14_xp_224.untrained': _cfg(),
    'vit_small_patch14_dinov2.lvd142m': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 518, 518), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_base_patch14_dinov2.lvd142m': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 518, 518), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_large_patch14_dinov2.lvd142m': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 518, 518), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_giant_patch14_dinov2.lvd142m': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 518, 518), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_small_patch14_reg4_dinov2.lvd142m': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 518, 518), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_base_patch14_reg4_dinov2.lvd142m': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 518, 518), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_large_patch14_reg4_dinov2.lvd142m': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 518, 518), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_giant_patch14_reg4_dinov2.lvd142m': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 518, 518), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_base_patch14_reg1_tipsv2.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    'vit_large_patch14_reg1_tipsv2.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    'vit_so400m_patch14_reg1_tipsv2.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    'vit_giant_patch14_reg1_tipsv2.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    'vit_base_patch32_siglip_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_base_patch16_siglip_224.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_base_patch16_siglip_224.webli': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_base_patch16_siglip_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_base_patch16_siglip_256.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_base_patch16_siglip_256.webli_i18n': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_base_patch16_siglip_384.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_base_patch16_siglip_384.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_base_patch16_siglip_512.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 512, 512)),
    'vit_base_patch16_siglip_512.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 512, 512)),
    'vit_large_patch16_siglip_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_large_patch16_siglip_256.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_large_patch16_siglip_384.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_large_patch16_siglip_384.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_large_patch16_siglip_512.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 512, 512)),
    'vit_so400m_patch14_siglip_378.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 378, 378)),
    'vit_so400m_patch14_siglip_378.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 378, 378)),
    'vit_so400m_patch14_siglip_378.webli_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 378, 378), crop_pct=1.0, crop_mode='squash'),
    'vit_so400m_patch14_siglip_384.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_so400m_patch16_siglip_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_so400m_patch16_siglip_256.webli_i18n': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_so400m_patch16_siglip_384.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_so400m_patch16_siglip_512.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 512, 512)),
    'vit_giantopt_patch16_siglip_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_giantopt_patch16_siglip_384.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_base_patch32_siglip_gap_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_base_patch16_siglip_gap_224.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_base_patch16_siglip_gap_224.webli': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_base_patch16_siglip_gap_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_base_patch16_siglip_gap_256.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_base_patch16_siglip_gap_256.webli_i18n': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_base_patch16_siglip_gap_384.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_base_patch16_siglip_gap_384.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_base_patch16_siglip_gap_512.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 512, 512)),
    'vit_base_patch16_siglip_gap_512.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 512, 512)),
    'vit_large_patch16_siglip_gap_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_large_patch16_siglip_gap_256.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_large_patch16_siglip_gap_384.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_large_patch16_siglip_gap_384.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_large_patch16_siglip_gap_512.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 512, 512)),
    'vit_so400m_patch14_siglip_gap_224.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_so400m_patch14_siglip_gap_224.webli': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_so400m_patch14_siglip_gap_224.pali_mix': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_so400m_patch14_siglip_gap_224.pali_pt': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_so400m_patch14_siglip_gap_224.pali2_3b_pt': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_so400m_patch14_siglip_gap_224.pali2_10b_pt': _cfg(hf_hub_id='timm/', num_classes=0),
    'vit_so400m_patch14_siglip_gap_378.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 378, 378)),
    'vit_so400m_patch14_siglip_gap_378.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 378, 378), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_378.webli_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 378, 378), crop_pct=1.0, crop_mode='squash'),
    'vit_so400m_patch14_siglip_gap_384.webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_448.pali_mix': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_448.pali_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_448.pali_refcoco_seg': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_448.pali_ocrvqa': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_448.pali2_3b_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_448.pali2_10b_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_448.pali2_3b_docci': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_448.pali2_10b_docci': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_896.pali_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 896, 896), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_896.pali_refcoco_seg': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 896, 896), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_896.pali_ocrvqa': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 896, 896), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_896.pali2_3b_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 896, 896), crop_pct=1.0),
    'vit_so400m_patch14_siglip_gap_896.pali2_10b_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 896, 896), crop_pct=1.0),
    'vit_so400m_patch16_siglip_gap_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_so400m_patch16_siglip_gap_256.webli_i18n': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_so400m_patch16_siglip_gap_384.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_so400m_patch16_siglip_gap_512.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 512, 512)),
    'vit_giantopt_patch16_siglip_gap_256.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 256, 256)),
    'vit_giantopt_patch16_siglip_gap_384.v2_webli': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 384, 384)),
    'vit_wee_patch16_reg1_gap_256.sbb_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_dwee_patch16_reg1_gap_256.sbb_nadamuon_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_dwee_patch16_reg1_gap_256.sbb_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_pwee_patch16_reg1_gap_256.sbb_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_dpwee_patch16_reg1_gap_256.sbb_nadamuon_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_dpwee_patch16_reg1_gap_256.sbb_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_little_patch16_reg1_gap_256.sbb_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_little_patch16_reg1_gap_256.sbb_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 256, 256), crop_pct=0.95),
    'vit_medium_patch16_reg1_gap_256.sbb_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_mediumd_patch16_reg4_gap_256.sbb2_e200_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_mediumd_patch16_reg4_gap_256.sbb_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_mediumd_patch16_reg4_gap_256.sbb2_e200_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 256, 256), crop_pct=0.95),
    'vit_mediumd_patch16_reg4_gap_256.sbb_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 256, 256), crop_pct=0.95),
    'vit_mediumd_patch16_reg4_gap_384.sbb2_e200_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_betwixt_patch16_reg1_gap_256.sbb_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_betwixt_patch16_reg4_gap_256.sbb2_e200_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_betwixt_patch16_reg4_gap_256.sbb_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_betwixt_patch16_reg4_gap_256.sbb_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_betwixt_patch16_reg4_gap_256.sbb2_e200_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 256, 256), crop_pct=0.95),
    'vit_betwixt_patch16_reg4_gap_256.sbb_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 256, 256), crop_pct=0.95),
    'vit_betwixt_patch16_reg4_gap_384.sbb2_e200_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_base_patch16_reg4_gap_256.untrained': _cfg(input_size=(3, 256, 256)),
    'vit_so150m_patch16_reg4_map_256.untrained': _cfg(input_size=(3, 256, 256)),
    'vit_so150m_patch16_reg4_gap_256.sbb_e250_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_so150m_patch16_reg4_gap_256.sbb_e250_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 256, 256), crop_pct=0.95),
    'vit_so150m_patch16_reg4_gap_384.sbb_e250_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_so150m2_patch16_reg1_gap_256.sbb_e200_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=1.0),
    'vit_so150m2_patch16_reg1_gap_256.sbb_e200_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 256, 256), crop_pct=1.0),
    'vit_so150m2_patch16_reg1_gap_384.sbb_e200_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), crop_pct=1.0),
    'vit_so150m2_patch16_reg1_gap_448.sbb_e200_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 448, 448), crop_pct=1.0, crop_mode='squash'),
    'vit_intern300m_patch14_448.ogvl_dist': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'vit_intern300m_patch14_448.ogvl_2pt5': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'aimv2_large_patch14_224.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_large_patch14_224.apple_pt_dist': _cfg(hf_hub_id='timm/', num_classes=0, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_huge_patch14_224.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_1b_patch14_224.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_3b_patch14_224.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_large_patch14_336.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 336, 336), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_large_patch14_336.apple_pt_dist': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 336, 336), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_huge_patch14_336.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 336, 336), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_1b_patch14_336.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 336, 336), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_3b_patch14_336.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 336, 336), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_large_patch14_448.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_huge_patch14_448.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_1b_patch14_448.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'aimv2_3b_patch14_448.apple_pt': _cfg(hf_hub_id='timm/', num_classes=0, input_size=(3, 448, 448), crop_pct=1.0, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711)),
    'beit3_base_patch16_224.in22k_ft_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'beit3_base_patch16_224.indomain_in22k_ft_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'beit3_base_patch16_224.pt': _cfg(hf_hub_id='timm/', num_classes=0, crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'beit3_base_patch16_224.indomain_pt': _cfg(hf_hub_id='timm/', num_classes=0, crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'beit3_large_patch16_224.in22k_ft_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'beit3_large_patch16_224.indomain_in22k_ft_in1k': _cfg(hf_hub_id='timm/', crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'beit3_large_patch16_224.pt': _cfg(hf_hub_id='timm/', num_classes=0, crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'beit3_large_patch16_224.indomain_pt': _cfg(hf_hub_id='timm/', num_classes=0, crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'beit3_giant_patch14_224.untrained': _cfg(crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'beit3_giant_patch14_336.untrained': _cfg(input_size=(3, 336, 336), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'test_vit.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), crop_pct=0.95),
    'test_vit2.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), crop_pct=0.95),
    'test_vit3.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), crop_pct=0.95),
    'test_vit4.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), crop_pct=0.95),
})


def _create_vision_transformer(variant: str, pretrained: bool = False, **kwargs) -> VisionTransformer:
    out_indices = kwargs.pop('out_indices', 3)
    return build_model_with_cfg(VisionTransformer, variant, pretrained,
                                feature_cfg=dict(out_indices=out_indices), **kwargs)


@register_model
def vit_tiny_patch16_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=16, embed_dim=192, depth=12, num_heads=3)
    return _create_vision_transformer('vit_tiny_patch16_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_tiny_patch16_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=16, embed_dim=192, depth=12, num_heads=3)
    return _create_vision_transformer('vit_tiny_patch16_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_small_patch32_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=32, embed_dim=384, depth=12, num_heads=6)
    return _create_vision_transformer('vit_small_patch32_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_small_patch16_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=16, embed_dim=384, depth=12, num_heads=6)
    return _create_vision_transformer('vit_small_patch16_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_small_patch16_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=16, embed_dim=384, depth=12, num_heads=6)
    return _create_vision_transformer('vit_small_patch16_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=32, embed_dim=768, depth=12, num_heads=12)
    return _create_vision_transformer('vit_base_patch32_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12)
    return _create_vision_transformer('vit_base_patch16_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12)
    return _create_vision_transformer('vit_base_patch16_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch8_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=8, embed_dim=768, depth=12, num_heads=12)
    return _create_vision_transformer('vit_base_patch8_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_dlittle_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """Differential-attention 'little' ViT (sbb recipe, reference
    vision_transformer.py:4440)."""
    model_args = dict(
        patch_size=16, embed_dim=320, depth=14, num_heads=5, init_values=1e-5, mlp_ratio=5.6,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg', attn_layer='diff',
        img_size=256,
    )
    return _create_vision_transformer(
        'vit_dlittle_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_little_patch16_reg4_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=320, depth=14, num_heads=5, init_values=1e-5, mlp_ratio=5.6,
        class_token=False, no_embed_class=True, reg_tokens=4, global_pool='avg', img_size=256,
    )
    return _create_vision_transformer(
        'vit_little_patch16_reg4_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_medium_patch16_reg4_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=512, depth=12, num_heads=8, init_values=1e-5,
        class_token=False, no_embed_class=True, reg_tokens=4, global_pool='avg', img_size=256,
    )
    return _create_vision_transformer(
        'vit_medium_patch16_reg4_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch16_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16)
    return _create_vision_transformer('vit_large_patch16_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch14_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16)
    return _create_vision_transformer('vit_large_patch14_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_huge_patch14_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16)
    return _create_vision_transformer('vit_huge_patch14_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch14_siglip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=14, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362,
        class_token=False, global_pool='map',
    )
    return _create_vision_transformer('vit_so400m_patch14_siglip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def test_vit(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """Minimal test ViT (reference vision_transformer.py:4802)."""
    model_args = dict(img_size=160, patch_size=16, embed_dim=64, depth=2, num_heads=2, mlp_ratio=3)
    return _create_vision_transformer('test_vit', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def test_vit2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """Test ViT w/ global avg pool + reg tokens + layer scale."""
    model_args = dict(
        img_size=160, patch_size=16, embed_dim=64, depth=2, num_heads=2, mlp_ratio=3,
        class_token=False, reg_tokens=1, global_pool='avg', init_values=1e-5,
    )
    return _create_vision_transformer('test_vit2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def test_vit3(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """Test ViT w/ qk-norm + map pooling."""
    model_args = dict(
        img_size=160, patch_size=16, embed_dim=96, depth=9, num_heads=3, mlp_ratio=2,
        class_token=False, reg_tokens=1, global_pool='map', qk_norm=True,
    )
    return _create_vision_transformer('test_vit3', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def test_vit4(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """Test ViT w/ dynamic img size + patch dropout."""
    model_args = dict(
        img_size=160, patch_size=16, embed_dim=64, depth=2, num_heads=2, mlp_ratio=3,
        dynamic_img_size=True, patch_drop_rate=0.25,
    )
    return _create_vision_transformer('test_vit4', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_small_patch32_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Small (ViT-S/32) at 384x384."""
    model_args = dict(patch_size=32, embed_dim=384, depth=12, num_heads=6)
    return _create_vision_transformer('vit_small_patch32_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_small_patch8_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Small (ViT-S/8)"""
    model_args = dict(patch_size=8, embed_dim=384, depth=12, num_heads=6)
    return _create_vision_transformer('vit_small_patch8_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Base model (ViT-B/32) from original paper (https://arxiv.org/abs/2010.11929)."""
    model_args = dict(patch_size=32, embed_dim=768, depth=12, num_heads=12)
    return _create_vision_transformer('vit_base_patch32_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch32_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Large model (ViT-L/32) from original paper (https://arxiv.org/abs/2010.11929). No pretrained weights."""
    model_args = dict(patch_size=32, embed_dim=1024, depth=24, num_heads=16)
    return _create_vision_transformer('vit_large_patch32_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch32_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Large model (ViT-L/32) from original paper (https://arxiv.org/abs/2010.11929)."""
    model_args = dict(patch_size=32, embed_dim=1024, depth=24, num_heads=16)
    return _create_vision_transformer('vit_large_patch32_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch16_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Large model (ViT-L/16) from original paper (https://arxiv.org/abs/2010.11929)."""
    model_args = dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16)
    return _create_vision_transformer('vit_large_patch16_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giant_patch14_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Giant (little-g) model (ViT-g/14) from `Scaling Vision Transformers` - https://arxiv.org/abs/2106.04560"""
    model_args = dict(patch_size=14, embed_dim=1408, mlp_ratio=48/11, depth=40, num_heads=16)
    return _create_vision_transformer('vit_giant_patch14_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_gigantic_patch14_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Gigantic (big-G) model (ViT-G/14) from `Scaling Vision Transformers` - https://arxiv.org/abs/2106.04560"""
    model_args = dict(patch_size=14, embed_dim=1664, mlp_ratio=64/13, depth=48, num_heads=16)
    return _create_vision_transformer('vit_gigantic_patch14_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_224_miil(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Base (ViT-B/16) from original paper (https://arxiv.org/abs/2010.11929)."""
    model_args = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, qkv_bias=False)
    return _create_vision_transformer('vit_base_patch16_224_miil', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_medium_patch16_gap_240(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Medium (ViT-M/16) w/o class token, w/ avg-pool @ 240x240"""
    model_args = dict(
        patch_size=16, embed_dim=512, depth=12, num_heads=8, class_token=False,
        global_pool='avg', qkv_bias=False, init_values=1e-6, fc_norm=False)
    return _create_vision_transformer('vit_medium_patch16_gap_240', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_medium_patch16_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Medium (ViT-M/16) w/o class token, w/ avg-pool @ 256x256"""
    model_args = dict(
        patch_size=16, embed_dim=512, depth=12, num_heads=8, class_token=False,
        global_pool='avg', qkv_bias=False, init_values=1e-6, fc_norm=False)
    return _create_vision_transformer('vit_medium_patch16_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_medium_patch16_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Medium (ViT-M/16) w/o class token, w/ avg-pool @ 384x384"""
    model_args = dict(
        patch_size=16, embed_dim=512, depth=12, num_heads=8, class_token=False,
        global_pool='avg', qkv_bias=False, init_values=1e-6, fc_norm=False)
    return _create_vision_transformer('vit_medium_patch16_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_betwixt_patch16_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Betwixt (ViT-b/16) w/o class token, w/ avg-pool @ 256x256"""
    model_args = dict(
        patch_size=16, embed_dim=640, depth=12, num_heads=10, class_token=False,
        global_pool='avg', qkv_bias=False, init_values=1e-6, fc_norm=False)
    return _create_vision_transformer('vit_betwixt_patch16_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_gap_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Base (ViT-B/16) w/o class token, w/ avg-pool @ 224x224"""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=16, class_token=False, global_pool='avg', fc_norm=False)
    return _create_vision_transformer('vit_base_patch16_gap_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_huge_patch14_gap_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Huge model (ViT-H/14) w/ no class token, avg pool"""
    model_args = dict(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16, class_token=False, global_pool='avg', fc_norm=False)
    return _create_vision_transformer('vit_huge_patch14_gap_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_huge_patch16_gap_448(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Huge model (ViT-H/16) w/ no class token, avg pool @ 448x448"""
    model_args = dict(
        patch_size=16, embed_dim=1280, depth=32, num_heads=16, class_token=False, global_pool='avg', fc_norm=False)
    return _create_vision_transformer('vit_huge_patch16_gap_448', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giant_patch16_gap_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Giant (little-gg) model (ViT-g/16) w/ no class token, avg pool"""
    model_args = dict(
        patch_size=16, embed_dim=1408, depth=40, num_heads=16, mlp_ratio=48/11,
        class_token=False, global_pool='avg', fc_norm=False)
    return _create_vision_transformer('vit_giant_patch16_gap_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_xsmall_patch16_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(embed_dim=256, depth=10, num_heads=4, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_xsmall_patch16_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_medium_patch32_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=32, embed_dim=512, depth=12, num_heads=8, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_medium_patch32_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_medium_patch16_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(embed_dim=512, depth=12, num_heads=8, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_medium_patch16_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_betwixt_patch32_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=32, embed_dim=640, depth=12, num_heads=10, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_betwixt_patch32_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/32 CLIP image tower @ 224x224"""
    model_args = dict(
        patch_size=32, embed_dim=768, depth=12, num_heads=12, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_base_patch32_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_clip_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/32 CLIP image tower @ 256x256"""
    model_args = dict(
        patch_size=32, embed_dim=768, depth=12, num_heads=12, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_base_patch32_clip_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_clip_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/32 CLIP image tower @ 384x384"""
    model_args = dict(
        patch_size=32, embed_dim=768, depth=12, num_heads=12, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_base_patch32_clip_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_clip_448(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/32 CLIP image tower @ 448x448"""
    model_args = dict(
        patch_size=32, embed_dim=768, depth=12, num_heads=12, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_base_patch32_clip_448', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/16 CLIP image tower"""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_base_patch16_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_clip_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/16 CLIP image tower @ 384x384"""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_base_patch16_clip_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_plus_clip_240(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Base (ViT-B/16+) CLIP image tower @ 240x240"""
    model_args = dict(
        patch_size=16, embed_dim=896, depth=12, num_heads=14, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_base_patch16_plus_clip_240', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch14_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Large model (ViT-L/14) CLIP image tower"""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_large_patch14_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch14_clip_336(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Large model (ViT-L/14) CLIP image tower @ 336x336"""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_large_patch14_clip_336', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_huge_patch14_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Huge model (ViT-H/14) CLIP image tower."""
    model_args = dict(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_huge_patch14_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_huge_patch14_clip_336(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Huge model (ViT-H/14) CLIP image tower @ 336x336"""
    model_args = dict(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_huge_patch14_clip_336', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_huge_patch14_clip_378(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Huge model (ViT-H/14) CLIP image tower @ 378x378"""
    model_args = dict(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16, pre_norm=True, norm_layer=partial(LayerNorm, eps=1e-5))
    return _create_vision_transformer('vit_huge_patch14_clip_378', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giant_patch14_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Giant (little-g) model (ViT-g/14) from `Scaling Vision Transformers` - https://arxiv.org/abs/2106.04560"""
    model_args = dict(
        patch_size=14, embed_dim=1408, mlp_ratio=48/11, depth=40, num_heads=16, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5),
    )
    return _create_vision_transformer('vit_giant_patch14_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_gigantic_patch14_clip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-bigG model (ViT-G/14) from `Scaling Vision Transformers` - https://arxiv.org/abs/2106.04560"""
    model_args = dict(
        patch_size=14, embed_dim=1664, mlp_ratio=64/13, depth=48, num_heads=16, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5),
    )
    return _create_vision_transformer('vit_gigantic_patch14_clip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_gigantic_patch14_clip_378(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-bigG model (ViT-G/14) from `Scaling Vision Transformers` - https://arxiv.org/abs/2106.04560"""
    model_args = dict(
        patch_size=14, embed_dim=1664, mlp_ratio=64/13, depth=48, num_heads=16, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5),
    )
    return _create_vision_transformer('vit_gigantic_patch14_clip_378', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_clip_quickgelu_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/32 CLIP image tower @ 224x224"""
    model_args = dict(
        patch_size=32, embed_dim=768, depth=12, num_heads=12, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5), act_layer='quick_gelu'
    )
    return _create_vision_transformer('vit_base_patch32_clip_quickgelu_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_clip_quickgelu_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/16 CLIP image tower w/ QuickGELU act"""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5), act_layer='quick_gelu'
    )
    return _create_vision_transformer('vit_base_patch16_clip_quickgelu_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch14_clip_quickgelu_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Large model (ViT-L/14) CLIP image tower w/ QuickGELU act"""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5), act_layer='quick_gelu'
    )
    return _create_vision_transformer('vit_large_patch14_clip_quickgelu_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch14_clip_quickgelu_336(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Large model (ViT-L/14) CLIP image tower @ 336x336 w/ QuickGELU act"""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5), act_layer='quick_gelu'
    )
    return _create_vision_transformer('vit_large_patch14_clip_quickgelu_336', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_huge_patch14_clip_quickgelu_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Huge model (ViT-H/14) CLIP image tower w/ QuickGELU act."""
    model_args = dict(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5), act_layer='quick_gelu'
    )
    return _create_vision_transformer('vit_huge_patch14_clip_quickgelu_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_huge_patch14_clip_quickgelu_378(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Huge model (ViT-H/14) CLIP image tower @ 378x378 w/ QuickGELU act"""
    model_args = dict(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5), act_layer='quick_gelu'
    )
    return _create_vision_transformer('vit_huge_patch14_clip_quickgelu_378', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_gigantic_patch14_clip_quickgelu_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-bigG model (ViT-G/14) w/ QuickGELU act"""
    model_args = dict(
        patch_size=14, embed_dim=1664, mlp_ratio=64/13, depth=48, num_heads=16, pre_norm=True,
        norm_layer=partial(LayerNorm, eps=1e-5), act_layer='quick_gelu'
    )
    return _create_vision_transformer('vit_gigantic_patch14_clip_quickgelu_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_plus_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Base (ViT-B/32+)"""
    model_args = dict(patch_size=32, embed_dim=896, depth=12, num_heads=14, init_values=1e-5)
    return _create_vision_transformer('vit_base_patch32_plus_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_plus_240(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Base (ViT-B/16+)"""
    model_args = dict(patch_size=16, embed_dim=896, depth=12, num_heads=14, init_values=1e-5)
    return _create_vision_transformer('vit_base_patch16_plus_240', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_rpn_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Base (ViT-B/16) w/ residual post-norm"""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, qkv_bias=False, init_values=1e-5,
        class_token=False, block_fn=ResPostBlock, global_pool='avg')
    return _create_vision_transformer('vit_base_patch16_rpn_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_small_patch16_36x1_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Base w/ LayerScale + 36 x 1 (36 block serial) config. Experimental, may remove."""
    model_args = dict(patch_size=16, embed_dim=384, depth=36, num_heads=6, init_values=1e-5)
    return _create_vision_transformer('vit_small_patch16_36x1_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_small_patch16_18x2_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Small w/ LayerScale + 18 x 2 (36 block parallel) config. Experimental, may remove."""
    model_args = dict(
        patch_size=16, embed_dim=384, depth=18, num_heads=6, init_values=1e-5, block_fn=ParallelThingsBlock)
    return _create_vision_transformer('vit_small_patch16_18x2_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_18x2_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Base w/ LayerScale + 18 x 2 (36 block parallel) config. Experimental, may remove."""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=18, num_heads=12, init_values=1e-5, block_fn=ParallelThingsBlock)
    return _create_vision_transformer('vit_base_patch16_18x2_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def eva_large_patch14_196(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """EVA-large model https://arxiv.org/abs/2211.07636 /via MAE MIM pretrain"""
    model_args = dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16, global_pool='avg')
    return _create_vision_transformer('eva_large_patch14_196', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def eva_large_patch14_336(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """EVA-large model https://arxiv.org/abs/2211.07636 via MAE MIM pretrain"""
    model_args = dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16, global_pool='avg')
    return _create_vision_transformer('eva_large_patch14_336', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def flexivit_small(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """FlexiViT-Small"""
    model_args = dict(patch_size=16, embed_dim=384, depth=12, num_heads=6, no_embed_class=True)
    return _create_vision_transformer('flexivit_small', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def flexivit_base(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """FlexiViT-Base"""
    model_args = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, no_embed_class=True)
    return _create_vision_transformer('flexivit_base', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def flexivit_large(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """FlexiViT-Large"""
    model_args = dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16, no_embed_class=True)
    return _create_vision_transformer('flexivit_large', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_xp_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Large model (ViT-L/14) w/ parallel blocks and qk norm enabled."""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, pre_norm=True, no_embed_class=True,
        norm_layer=RmsNorm, block_fn=ParallelScalingBlock, qkv_bias=False, qk_norm=True,
    )
    return _create_vision_transformer('vit_base_patch16_xp_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch14_xp_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Large model (ViT-L/14) w/ parallel blocks and qk norm enabled."""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16, pre_norm=True, no_embed_class=True,
        norm_layer=RmsNorm, block_fn=ParallelScalingBlock, qkv_bias=False, qk_norm=True,
    )
    return _create_vision_transformer('vit_large_patch14_xp_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_huge_patch14_xp_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-Huge model (ViT-H/14) w/ parallel blocks and qk norm enabled."""
    model_args = dict(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16, pre_norm=True, no_embed_class=True,
        norm_layer=RmsNorm, block_fn=ParallelScalingBlock, qkv_bias=False, qk_norm=True,
    )
    return _create_vision_transformer('vit_huge_patch14_xp_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_small_patch14_dinov2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-S/14 for DINOv2"""
    model_args = dict(patch_size=14, embed_dim=384, depth=12, num_heads=6, init_values=1e-5)
    return _create_vision_transformer('vit_small_patch14_dinov2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch14_dinov2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/14 for DINOv2"""
    model_args = dict(patch_size=14, embed_dim=768, depth=12, num_heads=12, init_values=1e-5)
    return _create_vision_transformer('vit_base_patch14_dinov2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch14_dinov2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-L/14 for DINOv2"""
    model_args = dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16, init_values=1e-5)
    return _create_vision_transformer('vit_large_patch14_dinov2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giant_patch14_dinov2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-G/14 for DINOv2"""
    model_args = dict(
        patch_size=14, embed_dim=1536, depth=40, num_heads=24, init_values=1e-5,
        mlp_ratio=2.66667 * 2, mlp_layer=SwiGLUPacked, act_layer='silu'
    )
    return _create_vision_transformer('vit_giant_patch14_dinov2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_small_patch14_reg4_dinov2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-S/14 for DINOv2 w/ 4 registers"""
    model_args = dict(
        patch_size=14, embed_dim=384, depth=12, num_heads=6, init_values=1e-5,
        reg_tokens=4, no_embed_class=True,
    )
    return _create_vision_transformer('vit_small_patch14_reg4_dinov2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch14_reg4_dinov2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/14 for DINOv2 w/ 4 registers"""
    model_args = dict(
        patch_size=14, embed_dim=768, depth=12, num_heads=12, init_values=1e-5,
        reg_tokens=4, no_embed_class=True,
    )
    return _create_vision_transformer('vit_base_patch14_reg4_dinov2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch14_reg4_dinov2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-L/14 for DINOv2 w/ 4 registers"""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16, init_values=1e-5,
        reg_tokens=4, no_embed_class=True,
    )
    return _create_vision_transformer('vit_large_patch14_reg4_dinov2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giant_patch14_reg4_dinov2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-G/14 for DINOv2"""
    model_args = dict(
        patch_size=14, embed_dim=1536, depth=40, num_heads=24, init_values=1e-5, mlp_ratio=2.66667 * 2,
        mlp_layer=SwiGLUPacked, act_layer='silu', reg_tokens=4, no_embed_class=True,
    )
    return _create_vision_transformer('vit_giant_patch14_reg4_dinov2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch14_reg1_tipsv2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-B/14 for TIPSv2 (DINOv2-style w/ 1 register token, LayerScale init=1.0)."""
    model_args = dict(
        patch_size=14, embed_dim=768, depth=12, num_heads=12, init_values=1.0,
        reg_tokens=1, no_embed_class=True,
    )
    return _create_vision_transformer('vit_base_patch14_reg1_tipsv2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch14_reg1_tipsv2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-L/14 for TIPSv2 (DINOv2-style w/ 1 register token, LayerScale init=1.0)."""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16, init_values=1.0,
        reg_tokens=1, no_embed_class=True,
    )
    return _create_vision_transformer('vit_large_patch14_reg1_tipsv2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch14_reg1_tipsv2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """SoViT-400M/14 for TIPSv2 (DINOv2-style w/ 1 register token, LayerScale init=1.0)."""
    model_args = dict(
        patch_size=14, embed_dim=1152, depth=27, num_heads=16, init_values=1.0,
        mlp_ratio=4304 / 1152, reg_tokens=1, no_embed_class=True,
    )
    return _create_vision_transformer('vit_so400m_patch14_reg1_tipsv2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giant_patch14_reg1_tipsv2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT-G/14 for TIPSv2 (DINOv2-style w/ SwiGLU FFN, 1 register token, LayerScale init=1.0)."""
    model_args = dict(
        patch_size=14, embed_dim=1536, depth=40, num_heads=24, init_values=1.0,
        mlp_ratio=2.66667 * 2, mlp_layer=SwiGLUPacked, act_layer='silu',
        reg_tokens=1, no_embed_class=True,
    )
    return _create_vision_transformer('vit_giant_patch14_reg1_tipsv2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_siglip_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=32, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='map',
        act_layer='gelu_tanh',
    )
    return _create_vision_transformer('vit_base_patch32_siglip_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_siglip_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='map',
    )
    return _create_vision_transformer('vit_base_patch16_siglip_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_siglip_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='map',
    )
    return _create_vision_transformer('vit_base_patch16_siglip_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_siglip_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='map',
    )
    return _create_vision_transformer('vit_base_patch16_siglip_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_siglip_512(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='map',
    )
    return _create_vision_transformer('vit_base_patch16_siglip_512', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch16_siglip_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16, class_token=False, global_pool='map',
    )
    return _create_vision_transformer('vit_large_patch16_siglip_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch16_siglip_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16, class_token=False, global_pool='map',
    )
    return _create_vision_transformer('vit_large_patch16_siglip_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch16_siglip_512(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16, class_token=False, global_pool='map',
        act_layer='gelu_tanh'
    )
    return _create_vision_transformer('vit_large_patch16_siglip_512', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch14_siglip_378(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=14, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362, class_token=False, global_pool='map',
    )
    return _create_vision_transformer('vit_so400m_patch14_siglip_378', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch14_siglip_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=14, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362, class_token=False, global_pool='map',
    )
    return _create_vision_transformer('vit_so400m_patch14_siglip_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch16_siglip_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362, class_token=False, global_pool='map',
        act_layer='gelu_tanh',
    )
    return _create_vision_transformer('vit_so400m_patch16_siglip_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch16_siglip_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362, class_token=False, global_pool='map',
        act_layer='gelu_tanh',
    )
    return _create_vision_transformer('vit_so400m_patch16_siglip_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch16_siglip_512(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362, class_token=False, global_pool='map',
        act_layer='gelu_tanh',
    )
    return _create_vision_transformer('vit_so400m_patch16_siglip_512', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giantopt_patch16_siglip_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1536, depth=40, num_heads=16, class_token=False, global_pool='map',
        act_layer='gelu_tanh',
    )
    return _create_vision_transformer('vit_giantopt_patch16_siglip_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giantopt_patch16_siglip_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1536, depth=40, num_heads=16, class_token=False, global_pool='map',
        act_layer='gelu_tanh',
    )
    return _create_vision_transformer('vit_giantopt_patch16_siglip_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch32_siglip_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=32, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='avg', fc_norm=False,
        act_layer='gelu_tanh',
    )
    return _create_vision_transformer('vit_base_patch32_siglip_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_siglip_gap_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_base_patch16_siglip_gap_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_siglip_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_base_patch16_siglip_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_siglip_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_base_patch16_siglip_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_siglip_gap_512(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_base_patch16_siglip_gap_512', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch16_siglip_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16, class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_large_patch16_siglip_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch16_siglip_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16, class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_large_patch16_siglip_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_large_patch16_siglip_gap_512(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16, class_token=False,
        global_pool='avg', fc_norm=False, act_layer='gelu_tanh'
    )
    return _create_vision_transformer('vit_large_patch16_siglip_gap_512', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch14_siglip_gap_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=14, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362,
        class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_so400m_patch14_siglip_gap_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch14_siglip_gap_378(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=14, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362,
        class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_so400m_patch14_siglip_gap_378', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch14_siglip_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=14, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362,
        class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_so400m_patch14_siglip_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch14_siglip_gap_448(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=14, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362,
        class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_so400m_patch14_siglip_gap_448', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch14_siglip_gap_896(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=14, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362,
        class_token=False, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_so400m_patch14_siglip_gap_896', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch16_siglip_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """A SigLIP variant of ViT with global average pooling (GAP) instead of attention pooling (MAP)."""
    model_args = dict(
        patch_size=16, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362,
        class_token=False, global_pool='avg', fc_norm=False, act_layer='gelu_tanh',
    )
    return _create_vision_transformer('vit_so400m_patch16_siglip_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch16_siglip_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362, class_token=False,
        global_pool='avg', fc_norm=False, act_layer='gelu_tanh'
    )
    return _create_vision_transformer('vit_so400m_patch16_siglip_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so400m_patch16_siglip_gap_512(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1152, depth=27, num_heads=16, mlp_ratio=3.7362, class_token=False,
        global_pool='avg', fc_norm=False, act_layer='gelu_tanh'
    )
    return _create_vision_transformer('vit_so400m_patch16_siglip_gap_512', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giantopt_patch16_siglip_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1536, depth=40, num_heads=16, class_token=False,
        global_pool='avg', fc_norm=False, act_layer='gelu_tanh'
    )
    return _create_vision_transformer('vit_giantopt_patch16_siglip_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_giantopt_patch16_siglip_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=1536, depth=40, num_heads=16, class_token=False,
        global_pool='avg', fc_norm=False, act_layer='gelu_tanh'
    )
    return _create_vision_transformer('vit_giantopt_patch16_siglip_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_wee_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=256, depth=14, num_heads=4, init_values=1e-5, mlp_ratio=5,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg',
    )
    return _create_vision_transformer('vit_wee_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_dwee_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=256, depth=14, num_heads=4, init_values=1e-5, mlp_ratio=5,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg', attn_layer='diff',
    )
    return _create_vision_transformer('vit_dwee_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_pwee_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=256, depth=16, num_heads=4, init_values=1e-5, mlp_ratio=5,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg', block_fn=ParallelScalingBlock,
    )
    return _create_vision_transformer('vit_pwee_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_dpwee_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=256, depth=16, num_heads=4, init_values=1e-5, mlp_ratio=5,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg', block_fn=DiffParallelScalingBlock,
    )
    return _create_vision_transformer('vit_dpwee_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_little_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=320, depth=14, num_heads=5, init_values=1e-5, mlp_ratio=5.6,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg',
    )
    return _create_vision_transformer('vit_little_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_medium_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=512, depth=12, num_heads=8, init_values=1e-5,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg',
    )
    return _create_vision_transformer('vit_medium_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_mediumd_patch16_reg4_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=512, depth=20, num_heads=8, init_values=1e-5,
        class_token=False, no_embed_class=True, reg_tokens=4, global_pool='avg',
    )
    return _create_vision_transformer('vit_mediumd_patch16_reg4_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_mediumd_patch16_reg4_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=512, depth=20, num_heads=8, init_values=1e-5,
        class_token=False, no_embed_class=True, reg_tokens=4, global_pool='avg',
    )
    return _create_vision_transformer('vit_mediumd_patch16_reg4_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_betwixt_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=640, depth=12, num_heads=10, init_values=1e-5,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg',
    )
    return _create_vision_transformer('vit_betwixt_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_betwixt_patch16_reg4_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=640, depth=12, num_heads=10, init_values=1e-5,
        class_token=False, no_embed_class=True, reg_tokens=4, global_pool='avg',
    )
    return _create_vision_transformer('vit_betwixt_patch16_reg4_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_betwixt_patch16_reg4_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=640, depth=12, num_heads=10, init_values=1e-5,
        class_token=False, no_embed_class=True, reg_tokens=4, global_pool='avg',
    )
    return _create_vision_transformer('vit_betwixt_patch16_reg4_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_reg4_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, class_token=False,
        no_embed_class=True, global_pool='avg', reg_tokens=4,
    )
    return _create_vision_transformer('vit_base_patch16_reg4_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so150m_patch16_reg4_map_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """SO150M (shape optimized, but diff than paper def, optimized for GPU)"""
    model_args = dict(
        patch_size=16, embed_dim=896, depth=18, num_heads=14, mlp_ratio=2.572,
        class_token=False, reg_tokens=4, global_pool='map',
    )
    return _create_vision_transformer('vit_so150m_patch16_reg4_map_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so150m_patch16_reg4_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """SO150M (shape optimized, but diff than paper def, optimized for GPU)"""
    model_args = dict(
        patch_size=16, embed_dim=896, depth=18, num_heads=14, mlp_ratio=2.572,
        class_token=False, reg_tokens=4, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_so150m_patch16_reg4_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so150m_patch16_reg4_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """SO150M (shape optimized, but diff than paper def, optimized for GPU)"""
    model_args = dict(
        patch_size=16, embed_dim=896, depth=18, num_heads=14, mlp_ratio=2.572,
        class_token=False, reg_tokens=4, global_pool='avg', fc_norm=False,
    )
    return _create_vision_transformer('vit_so150m_patch16_reg4_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so150m2_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """SO150M v2 (shape optimized, but diff than paper def, optimized for GPU)"""
    model_args = dict(
        patch_size=16, embed_dim=832, depth=21, num_heads=13, mlp_ratio=34/13, init_values=1e-5,
        qkv_bias=False, class_token=False, reg_tokens=1, global_pool='avg',
    )
    return _create_vision_transformer('vit_so150m2_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so150m2_patch16_reg1_gap_384(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """SO150M v2 (shape optimized, but diff than paper def, optimized for GPU)"""
    model_args = dict(
        patch_size=16, embed_dim=832, depth=21, num_heads=13, mlp_ratio=34/13, init_values=1e-5,
        qkv_bias=False, class_token=False, reg_tokens=1, global_pool='avg',
    )
    return _create_vision_transformer('vit_so150m2_patch16_reg1_gap_384', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_so150m2_patch16_reg1_gap_448(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """SO150M v2 (shape optimized, but diff than paper def, optimized for GPU)"""
    model_args = dict(
        patch_size=16, embed_dim=832, depth=21, num_heads=13, mlp_ratio=34/13, init_values=1e-5,
        qkv_bias=False, class_token=False, reg_tokens=1, global_pool='avg',
    )
    return _create_vision_transformer('vit_so150m2_patch16_reg1_gap_448', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_intern300m_patch14_448(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16,
        init_values=0.1, final_norm=False, dynamic_img_size=True,
    )
    return _create_vision_transformer('vit_intern300m_patch14_448', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_large_patch14_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT Large AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=8, class_token=False, fc_norm=False,
        mlp_ratio=2.75, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_large_patch14_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_huge_patch14_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT Huge AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=1536, depth=24, num_heads=12, class_token=False, fc_norm=False,
        mlp_ratio=2.6667, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_huge_patch14_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_1b_patch14_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT 1B AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=2048, depth=24, num_heads=16, class_token=False, fc_norm=False,
        mlp_ratio=2.75, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_1b_patch14_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_3b_patch14_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT 3B AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=3072, depth=24, num_heads=24, class_token=False, fc_norm=False,
        mlp_ratio=2.6667, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_3b_patch14_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_large_patch14_336(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT Large AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=8, class_token=False, fc_norm=False,
        mlp_ratio=2.75, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_large_patch14_336', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_huge_patch14_336(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT Huge AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=1536, depth=24, num_heads=12, class_token=False, fc_norm=False,
        mlp_ratio=2.6667, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_huge_patch14_336', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_1b_patch14_336(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT 1B AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=2048, depth=24, num_heads=16, class_token=False, fc_norm=False,
        mlp_ratio=2.75, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_1b_patch14_336', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_3b_patch14_336(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT 3B AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=3072, depth=24, num_heads=24, class_token=False, fc_norm=False,
        mlp_ratio=2.6667, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_3b_patch14_336', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_large_patch14_448(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT Large AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=1024, depth=24, num_heads=8, class_token=False, fc_norm=False,
        mlp_ratio=2.75, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_large_patch14_448', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_huge_patch14_448(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT Huge AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=1536, depth=24, num_heads=12, class_token=False, fc_norm=False,
        mlp_ratio=2.6667, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_huge_patch14_448', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_1b_patch14_448(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT 1B AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=2048, depth=24, num_heads=16, class_token=False, fc_norm=False,
        mlp_ratio=2.75, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_1b_patch14_448', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def aimv2_3b_patch14_448(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """ViT 3B AIM-v2 model"""
    model_args = dict(
        patch_size=14, embed_dim=3072, depth=24, num_heads=24, class_token=False, fc_norm=False,
        mlp_ratio=2.6667, global_pool='avg', qkv_bias=False, proj_bias=False, act_layer='silu',
        norm_layer=partial(RmsNorm, eps=1e-5), embed_norm_layer=partial(RmsNorm, eps=1e-5), mlp_layer=SwiGLU,
    )
    return _create_vision_transformer('aimv2_3b_patch14_448', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def beit3_base_patch16_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """BEiT3 Base model (ViT-Base size) with patch size 16x16."""
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, mlp_ratio=4,
        scale_attn_norm=True, scale_mlp_norm=True, class_token=True, global_pool='avg',
        norm_layer=partial(LayerNorm, eps=1e-5)
    )
    return _create_vision_transformer('beit3_base_patch16_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def beit3_large_patch16_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """BEiT3 Large model (ViT-Large size) with patch size 16x16."""
    model_args = dict(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4,
        scale_attn_norm=True, scale_mlp_norm=True, class_token=True, global_pool='avg',
        norm_layer=partial(LayerNorm, eps=1e-5),
    )
    return _create_vision_transformer('beit3_large_patch16_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def beit3_giant_patch14_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """BEiT3 Giant model with patch size 14x14."""
    model_args = dict(
        patch_size=14, embed_dim=1408, depth=40, num_heads=16, mlp_ratio=4.3637,
        scale_attn_norm=True, scale_mlp_norm=True, class_token=True, global_pool='avg',
        norm_layer=partial(LayerNorm, eps=1e-5),
    )
    return _create_vision_transformer('beit3_giant_patch14_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def beit3_giant_patch14_336(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """BEiT3 Giant model with patch size 14x14 and image size 336x336."""
    model_args = dict(
        img_size=336, patch_size=14, embed_dim=1408, depth=40, num_heads=16, mlp_ratio=4.3637,
        scale_attn_norm=True, scale_mlp_norm=True, class_token=True, global_pool='avg',
        norm_layer=partial(LayerNorm, eps=1e-5),
    )
    return _create_vision_transformer('beit3_giant_patch14_336', pretrained=pretrained, **dict(model_args, **kwargs))
