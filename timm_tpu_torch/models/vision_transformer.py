"""Vision Transformer (counterpart of timm_tpu/models/vision_transformer.py).

Ported: the pre-norm ``Block`` (any attention layer, qk-norm, norm, act
and MLP layers), ``VisionTransformer`` with the forward_features /
forward_head / forward contract, get_classifier / reset_classifier,
no_weight_decay, group_matcher (layer decay), the token pad
``pad_tokens_to`` (which threads a key-padding mask into every attention),
``no_embed_class`` (the position embedding covers the patches only and is
added before the prefix tokens are concatenated) and ``attn_layer='diff'``
(differential attention, ``layers/diff_attention.py``, with each block's
depth), and the entrypoints test_vit, test_vit2, vit_tiny_patch16_224,
vit_base_patch16_224 and the "little" / "wee" family of 256 px register
models (vit_little_patch16_reg4_gap_256, vit_wee_patch16_reg1_gap_256 and
their differential-attention twins vit_dlittle_patch16_reg1_gap_256 and
vit_dwee_patch16_reg1_gap_256).

Input is NHWC, as in the JAX package. With ``dtype=torch.bfloat16`` the
casts follow the JAX model: the patch embedding, blocks and head compute in
bf16; the class token and position embedding are cast to the token dtype;
the final ``norm`` / ``fc_norm`` get no dtype, so on a bf16 input they return
fp32 (flax's promotion with fp32 parameters) and the head casts back to bf16.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..layers import (
    Attention, DiffAttention, DropPath, Dropout, LayerNorm, LayerScale, Linear, Mlp, PatchEmbed,
    calculate_drop_path_rates, global_pool_nlc, trunc_normal_,
)
from ._builder import build_model_with_cfg
from ._registry import generate_default_cfgs, register_model

__all__ = ['VisionTransformer', 'Block']


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(
            self,
            dim: int,
            num_heads: int,
            mlp_ratio: float = 4.0,
            qkv_bias: bool = False,
            qk_norm: bool = False,
            proj_bias: bool = True,
            proj_drop: float = 0.0,
            attn_drop: float = 0.0,
            init_values: Optional[float] = None,
            drop_path: float = 0.0,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Callable = LayerNorm,
            mlp_layer: Callable = Mlp,
            attn_layer: Optional[Callable] = None,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        attn_layer = attn_layer or Attention
        self.norm1 = norm_layer(dim, dtype=dtype)
        self.attn = attn_layer(dim, num_heads=num_heads, qkv_bias=qkv_bias, qk_norm=qk_norm,
                               proj_bias=proj_bias, attn_drop=attn_drop, proj_drop=proj_drop,
                               norm_layer=norm_layer, dtype=dtype, generator=generator)
        self.ls1 = LayerScale(dim, init_values=init_values) if init_values else None
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = norm_layer(dim, dtype=dtype)
        self.mlp = mlp_layer(dim, hidden_features=int(dim * mlp_ratio), act_layer=act_layer,
                             bias=proj_bias, drop=proj_drop, dtype=dtype, generator=generator)
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


_POOL_TYPES = ('', 'avg', 'avgmax', 'max', 'token')


class VisionTransformer(nn.Module):
    """ViT with the JAX package's model contract (the ported subset)."""

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
            init_values: Optional[float] = None,
            class_token: bool = True,
            no_embed_class: bool = False,
            reg_tokens: int = 0,
            drop_rate: float = 0.0,
            pos_drop_rate: float = 0.0,
            proj_drop_rate: float = 0.0,
            attn_drop_rate: float = 0.0,
            drop_path_rate: float = 0.0,
            attn_layer: Optional[Union[str, Callable]] = None,
            pad_tokens_to: Optional[Union[int, str]] = None,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if global_pool not in _POOL_TYPES:
            raise ValueError(f'global_pool {global_pool!r} is not ported')
        if not class_token and global_pool == 'token':
            raise ValueError("global_pool='token' needs a class token")

        # token pad: 'auto' rounds N up to a multiple of 8, an int pads to
        # exactly that length; pad keys are masked out of every attention and
        # stripped again before the head
        if pad_tokens_to is not None and pad_tokens_to != 'auto':
            pad_tokens_to = int(pad_tokens_to) or None
        self.pad_tokens_to = pad_tokens_to

        self.num_classes = num_classes
        self.global_pool = global_pool
        self.num_features = self.head_hidden_size = self.embed_dim = embed_dim
        self.num_prefix_tokens = (1 if class_token else 0) + reg_tokens
        self.num_reg_tokens = reg_tokens
        self.has_class_token = class_token
        self.no_embed_class = no_embed_class
        self.depth = depth
        self._dtype = dtype

        self.patch_embed = PatchEmbed(img_size=img_size, patch_size=patch_size, in_chans=in_chans,
                                      embed_dim=embed_dim, dtype=dtype, generator=generator)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if class_token else None
        self.reg_token = nn.Parameter(
            trunc_normal_(torch.empty(1, reg_tokens, embed_dim), std=0.02, generator=generator)
        ) if reg_tokens else None
        embed_len = self.patch_embed.num_patches + (0 if no_embed_class else self.num_prefix_tokens)
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, embed_len, embed_dim), std=0.02, generator=generator))
        self.pos_drop = Dropout(pos_drop_rate)

        def _resolve_attn_layer(i: int):
            if attn_layer == 'diff':
                return partial(DiffAttention, depth=i)  # depth-dependent lambda_init
            return attn_layer

        dpr = calculate_drop_path_rates(drop_path_rate, depth)
        self.blocks = nn.ModuleList([
            Block(dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                  init_values=init_values, proj_drop=proj_drop_rate, attn_drop=attn_drop_rate,
                  drop_path=dpr[i], attn_layer=_resolve_attn_layer(i), dtype=dtype,
                  generator=generator)
            for i in range(depth)])

        # feature norm (pre-pool), or fc norm (post-pool) for average pooling;
        # neither gets a dtype, as in JAX
        fc_norm = global_pool == 'avg'
        self.norm = None if fc_norm else LayerNorm(embed_dim)
        self.fc_norm = LayerNorm(embed_dim) if fc_norm else None
        self.head_drop = Dropout(drop_rate)
        self.head = Linear(embed_dim, num_classes, dtype=dtype, generator=generator) \
            if num_classes > 0 else None

    # ---- contract methods -------------------------------------------------
    def no_weight_decay(self) -> set:
        return {'pos_embed', 'cls_token', 'reg_token', 'dist_token'}

    def group_matcher(self, coarse: bool = False) -> Dict:
        return dict(
            stem=r'^cls_token|pos_embed|patch_embed|reg_token',
            blocks=[(r'^blocks\.(\d+)', None), (r'^norm', (99999,))],
        )

    def get_classifier(self) -> Optional[nn.Module]:
        return self.head

    def reset_classifier(self, num_classes: int, global_pool: Optional[str] = None,
                         generator: Optional[torch.Generator] = None):
        self.num_classes = num_classes
        if global_pool is not None:
            if global_pool not in _POOL_TYPES:
                raise ValueError(f'global_pool {global_pool!r} is not ported')
            self.global_pool = global_pool
        device = next(self.parameters()).device
        self.head = Linear(self.embed_dim, num_classes, dtype=self._dtype,
                           generator=generator).to(device) if num_classes > 0 else None

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

    def _pos_embed(self, x: torch.Tensor, pad_tokens_to=None):
        """Prefix tokens + position embedding, then the optional token pad.
        Returns (tokens, key_padding_mask or None, unpadded length)."""
        B = x.shape[0]
        prefix = []
        if self.cls_token is not None:
            prefix.append(self.cls_token.to(x.dtype).expand(B, -1, -1))
        if self.reg_token is not None:
            prefix.append(self.reg_token.to(x.dtype).expand(B, -1, -1))
        pos_embed = self.pos_embed.to(x.dtype)
        if self.no_embed_class:
            x = x + pos_embed
            x = torch.cat(prefix + [x], dim=1) if prefix else x
        else:
            x = torch.cat(prefix + [x], dim=1) if prefix else x
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

    def forward_features(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.patch_embed(x)
        # an external attn_mask is sized for the unpadded sequence, so the
        # token pad is skipped for that call
        x, pad_mask, orig_len = self._pos_embed(x, pad_tokens_to=0 if attn_mask is not None else None)
        if pad_mask is not None:
            attn_mask = pad_mask
        for blk in self.blocks:
            x = blk(x, attn_mask=attn_mask)
        if self.norm is not None:
            x = self.norm(x)
        if x.shape[1] != orig_len:
            x = x[:, :orig_len]  # strip the token pad before the head
        return x

    def pool(self, x: torch.Tensor, pool_type: Optional[str] = None, mask=None) -> torch.Tensor:
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
    'vit_base_patch16_224.augreg2_in21k_ft_in1k': _cfg(hf_hub_id='timm/'),
    'vit_base_patch16_224.augreg_in1k': _cfg(hf_hub_id='timm/'),
    'test_vit.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), crop_pct=0.95),
    'test_vit2.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), crop_pct=0.95),
    'vit_dlittle_patch16_reg1_gap_256.sbb_nadamuon_in1k': _cfg(
        hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_little_patch16_reg4_gap_256.sbb_in1k': _cfg(
        hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_wee_patch16_reg1_gap_256.sbb_in1k': _cfg(
        hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_dwee_patch16_reg1_gap_256.sbb_nadamuon_in1k': _cfg(
        hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
    'vit_dwee_patch16_reg1_gap_256.sbb_in1k': _cfg(
        hf_hub_id='timm/', input_size=(3, 256, 256), crop_pct=0.95),
})


def _create_vision_transformer(variant: str, pretrained: bool = False, **kwargs) -> VisionTransformer:
    return build_model_with_cfg(VisionTransformer, variant, pretrained, **kwargs)


@register_model
def vit_tiny_patch16_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=16, embed_dim=192, depth=12, num_heads=3)
    return _create_vision_transformer('vit_tiny_patch16_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_base_patch16_224(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12)
    return _create_vision_transformer('vit_base_patch16_224', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def test_vit(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """Minimal test ViT."""
    model_args = dict(img_size=160, patch_size=16, embed_dim=64, depth=2, num_heads=2, mlp_ratio=3)
    return _create_vision_transformer('test_vit', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def test_vit2(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """Test ViT with global average pool, a register token and layer scale."""
    model_args = dict(
        img_size=160, patch_size=16, embed_dim=64, depth=2, num_heads=2, mlp_ratio=3,
        class_token=False, reg_tokens=1, global_pool='avg', init_values=1e-5,
    )
    return _create_vision_transformer('test_vit2', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_dlittle_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    """Differential-attention 'little' ViT (sbb recipe)."""
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
def vit_wee_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=256, depth=14, num_heads=4, init_values=1e-5, mlp_ratio=5,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg',
    )
    return _create_vision_transformer(
        'vit_wee_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def vit_dwee_patch16_reg1_gap_256(pretrained: bool = False, **kwargs) -> VisionTransformer:
    model_args = dict(
        patch_size=16, embed_dim=256, depth=14, num_heads=4, init_values=1e-5, mlp_ratio=5,
        class_token=False, no_embed_class=True, reg_tokens=1, global_pool='avg', attn_layer='diff',
    )
    return _create_vision_transformer(
        'vit_dwee_patch16_reg1_gap_256', pretrained=pretrained, **dict(model_args, **kwargs))
