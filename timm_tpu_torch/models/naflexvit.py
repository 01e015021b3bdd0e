"""NaFlexVit: variable-resolution, sequence-packed ViT (counterpart of
timm_tpu/models/naflexvit.py).

Inputs are patchified on the host and padded to a sequence-length bucket:

  patches      (B, L, P*P*C) float
  patch_coord  (B, L, 2)     int (y, x) grid coords per token
  patch_valid  (B, L)        bool

so each (L, batch, patch dim) is one static shape, one CUDA graph of the
step on the card, as it is one jitted program in JAX. Position embeddings
are gathered from factorized row and column tables (or a learned 2-d grid)
by the clipped coords.

Attention masks. The JAX model builds a dense mask from ``patch_valid``
(``create_attention_mask``): (B, 1, L, L) in 'symmetric' mode, (B, 1, 1, L)
in 'key' mode. The port hands each block a ``SeqPadMask`` instead, the
(B, L) valid vector with the prefix tokens and the mode, which the
attention runs as a key-padding mask through the flash kernel on the card
and then, in 'symmetric' mode, gives the padded query rows JAX's value
(``layers/attention.py``). An NHWC image input has every token valid and
runs with no mask.

A batch whose patch dim differs from the model's patch size (variable patch
sizes) resamples the projection kernel inside the forward
(``layers/patch_embed.py resample_patch_embed``); the patch size is read
from the shape, so each patch size is its own static shape.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import nn

from ..layers import (
    Dropout, LayerNorm, Linear, Mlp, SeqPadMask, calculate_drop_path_rates, get_norm_layer,
    resample_patch_embed, trunc_normal_,
)
from ._builder import build_model_with_cfg
from ._features import feature_take_indices
from ._registry import generate_default_cfgs, register_model
from .vision_transformer import Block

__all__ = ['NaFlexEmbeds', 'NaFlexVit', 'create_attention_mask', 'global_pool_naflex',
           'patchify_image']


def create_attention_mask(patch_valid: torch.Tensor, num_prefix_tokens: int = 0,
                          symmetric: bool = True) -> torch.Tensor:
    """Token validity -> the JAX package's dense bool mask: (B, 1, L, L)
    when symmetric, else key-only (B, 1, 1, L)."""
    return _seq_pad_mask(patch_valid, num_prefix_tokens, symmetric).dense()


def _seq_pad_mask(patch_valid: torch.Tensor, num_prefix_tokens: int, symmetric: bool) -> SeqPadMask:
    valid = patch_valid.bool()
    if num_prefix_tokens:
        prefix = torch.ones(valid.shape[0], num_prefix_tokens, dtype=torch.bool, device=valid.device)
        valid = torch.cat([prefix, valid], dim=1)
    return SeqPadMask(valid, symmetric)


def global_pool_naflex(x: torch.Tensor, patch_valid: torch.Tensor, pool_type: str = 'avg',
                       num_prefix_tokens: int = 0) -> torch.Tensor:
    """Pooling over the valid patch tokens: 'avg', 'max' (padded tokens at
    the dtype's min) or 'token' (the first token)."""
    if pool_type == 'token':
        return x[:, 0]
    if num_prefix_tokens:
        x = x[:, num_prefix_tokens:]
    w = patch_valid.to(x.dtype)[..., None]
    if pool_type == 'avg':
        return (x * w).sum(dim=1) / torch.clamp_min(w.sum(dim=1), 1.0)
    if pool_type == 'max':
        return torch.where(w > 0, x, torch.finfo(x.dtype).min).amax(dim=1)
    raise ValueError(f'Unsupported NaFlex pool type {pool_type}')


def patchify_image(x: torch.Tensor, patch_size: int):
    """NHWC image -> (patches, coords, valid), every patch valid."""
    B, H, W, C = x.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = x[:, :gh * P, :gw * P]
    x = x.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, P * P * C)
    yy, xx = torch.meshgrid(torch.arange(gh, device=x.device), torch.arange(gw, device=x.device),
                            indexing='ij')
    coord = torch.stack([yy, xx], dim=-1).reshape(1, gh * gw, 2).expand(B, -1, -1)
    valid = torch.ones(B, gh * gw, dtype=torch.bool, device=x.device)
    return x, coord, valid


class NaFlexEmbeds(nn.Module):
    """Linear patch projection, position embedding gathered by the coords,
    then the class and register tokens."""

    def __init__(
            self,
            patch_size: int = 16,
            in_chans: int = 3,
            embed_dim: int = 768,
            max_grid_size: int = 64,
            pos_embed: str = 'factorized',
            pos_drop_rate: float = 0.0,
            class_token: bool = False,
            reg_tokens: int = 0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if pos_embed not in ('factorized', 'learn', 'none'):
            raise ValueError(f'unknown NaFlex position embedding {pos_embed!r}')
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.max_grid_size = max_grid_size
        self.pos_embed_type = pos_embed
        self.num_prefix_tokens = (1 if class_token else 0) + reg_tokens
        self.num_reg_tokens = reg_tokens

        self.proj = Linear(patch_size * patch_size * in_chans, embed_dim, dtype=dtype,
                           generator=generator)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if class_token else None
        self.reg_token = nn.Parameter(trunc_normal_(
            torch.empty(1, reg_tokens, embed_dim), std=0.02, generator=generator)) if reg_tokens else None

        def table(*shape):
            return nn.Parameter(trunc_normal_(torch.empty(*shape), std=0.02, generator=generator))

        self.pos_embed_y = self.pos_embed_x = self.pos_embed_grid = None
        if pos_embed == 'factorized':
            self.pos_embed_y = table(max_grid_size, embed_dim)
            self.pos_embed_x = table(max_grid_size, embed_dim)
        elif pos_embed == 'learn':
            self.pos_embed_grid = table(max_grid_size, max_grid_size, embed_dim)
        self.pos_drop = Dropout(pos_drop_rate)

    def _proj(self, patches: torch.Tensor, patch_size: Optional[int]) -> torch.Tensor:
        if patch_size is None or patch_size == self.patch_size:
            return self.proj(patches)
        # variable patch size: the kernel resampled to the batch's patch
        # size; the product runs in the patches' dtype, as in JAX
        P, C, D = self.patch_size, self.in_chans, self.embed_dim
        w = self.proj.weight.reshape(D, P, P, C)
        w = resample_patch_embed(w, (patch_size, patch_size)).reshape(D, -1)
        y = patches @ w.to(patches.dtype).t()
        if self.proj.bias is not None:
            y = y + self.proj.bias.to(y.dtype)
        return y

    def forward(self, patches: torch.Tensor, patch_coord: torch.Tensor,
                patch_size: Optional[int] = None) -> torch.Tensor:
        x = self._proj(patches, patch_size)
        B, L, D = x.shape
        yy = patch_coord[..., 0].long().clamp(0, self.max_grid_size - 1)
        xx = patch_coord[..., 1].long().clamp(0, self.max_grid_size - 1)
        if self.pos_embed_type == 'factorized':
            x = x + (self.pos_embed_y[yy] + self.pos_embed_x[xx]).to(x.dtype)
        elif self.pos_embed_type == 'learn':
            x = x + self.pos_embed_grid[yy, xx].to(x.dtype)
        prefix = []
        if self.cls_token is not None:
            prefix.append(self.cls_token.to(x.dtype).expand(B, -1, -1))
        if self.reg_token is not None:
            prefix.append(self.reg_token.to(x.dtype).expand(B, -1, -1))
        if prefix:
            x = torch.cat(prefix + [x], dim=1)
        return self.pos_drop(x)


class NaFlexVit(nn.Module):
    def __init__(
            self,
            patch_size: int = 16,
            in_chans: int = 3,
            num_classes: int = 1000,
            global_pool: str = 'avg',
            embed_dim: int = 768,
            depth: int = 12,
            num_heads: int = 12,
            mlp_ratio: float = 4.0,
            qkv_bias: bool = True,
            qk_norm: bool = False,
            init_values: Optional[float] = None,
            class_token: bool = False,
            reg_tokens: int = 0,
            pos_embed: str = 'factorized',
            max_grid_size: int = 64,
            final_norm: bool = True,
            fc_norm: Optional[bool] = None,
            drop_rate: float = 0.0,
            pos_drop_rate: float = 0.0,
            proj_drop_rate: float = 0.0,
            attn_drop_rate: float = 0.0,
            drop_path_rate: float = 0.0,
            norm_layer: Optional[Union[str, Callable]] = None,
            act_layer: Union[str, Callable] = 'gelu',
            block_fn: Callable = Block,
            mlp_layer: Callable = Mlp,
            mask_mode: str = 'symmetric',
            img_size=None,  # accepted for the factory; unused
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if global_pool not in ('', 'avg', 'max', 'token'):
            raise ValueError(f'global_pool {global_pool!r} is not supported')
        if global_pool == 'token' and not class_token:
            raise ValueError("global_pool='token' needs a class token")
        if mask_mode not in ('symmetric', 'key'):
            raise ValueError(f"mask_mode must be 'symmetric' or 'key', got {mask_mode!r}")
        norm_layer = get_norm_layer(norm_layer) or LayerNorm
        self.num_classes = num_classes
        self.global_pool = global_pool
        self.num_features = self.head_hidden_size = self.embed_dim = embed_dim
        self.mask_mode = mask_mode
        self.grad_checkpointing = False
        self._dtype = dtype

        self.embeds = NaFlexEmbeds(
            patch_size=patch_size, in_chans=in_chans, embed_dim=embed_dim,
            max_grid_size=max_grid_size, pos_embed=pos_embed, pos_drop_rate=pos_drop_rate,
            class_token=class_token, reg_tokens=reg_tokens, dtype=dtype, generator=generator)
        self.num_prefix_tokens = self.embeds.num_prefix_tokens

        dpr = calculate_drop_path_rates(drop_path_rate, depth)
        self.blocks = nn.ModuleList([
            block_fn(dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                     qk_norm=qk_norm, init_values=init_values, proj_drop=proj_drop_rate,
                     attn_drop=attn_drop_rate, drop_path=dpr[i], norm_layer=norm_layer,
                     act_layer=act_layer, mlp_layer=mlp_layer, dtype=dtype, generator=generator)
            for i in range(depth)])
        if fc_norm is None:
            fc_norm = global_pool == 'avg'
        self.norm = norm_layer(embed_dim) if final_norm and not fc_norm else None
        self.fc_norm = norm_layer(embed_dim) if final_norm and fc_norm else None
        self.head_drop = Dropout(drop_rate)
        self.head = Linear(embed_dim, num_classes, dtype=dtype, generator=generator) \
            if num_classes > 0 else None

    # ---- contract methods -------------------------------------------------
    def no_weight_decay(self) -> set:
        return {'embeds.cls_token', 'embeds.reg_token', 'embeds.pos_embed_y',
                'embeds.pos_embed_x', 'embeds.pos_embed_grid'}

    def group_matcher(self, coarse: bool = False) -> Dict:
        return dict(
            stem=r'^embeds',
            blocks=[(r'^blocks\.(\d+)', None), (r'^norm|^fc_norm', (99999,))],
        )

    def set_grad_checkpointing(self, enable: bool = True):
        # a flag the forward does not read, as in the JAX model
        self.grad_checkpointing = enable

    def get_classifier(self) -> Optional[nn.Module]:
        return self.head

    def reset_classifier(self, num_classes: int, global_pool: Optional[str] = None,
                         generator: Optional[torch.Generator] = None):
        self.num_classes = num_classes
        if global_pool is not None:
            self.global_pool = global_pool
        device = next(self.parameters()).device
        self.head = Linear(self.embed_dim, num_classes, dtype=self._dtype,
                           generator=generator).to(device) if num_classes > 0 else None

    # ---- forward ----------------------------------------------------------
    def _attn_mask(self, patch_valid: Optional[torch.Tensor]) -> Optional[SeqPadMask]:
        if patch_valid is None:
            return None
        return _seq_pad_mask(patch_valid, self.num_prefix_tokens, self.mask_mode == 'symmetric')

    def forward_features(self, patches: torch.Tensor, patch_coord: torch.Tensor,
                         patch_valid: Optional[torch.Tensor] = None,
                         patch_size: Optional[int] = None) -> torch.Tensor:
        x = self.embeds(patches, patch_coord, patch_size=patch_size)
        attn_mask = self._attn_mask(patch_valid)
        for blk in self.blocks:
            x = blk(x, attn_mask=attn_mask)
        if self.norm is not None:
            x = self.norm(x)
        return x

    def forward_head(self, x: torch.Tensor, patch_valid: Optional[torch.Tensor] = None,
                     pre_logits: bool = False) -> torch.Tensor:
        if not self.global_pool:
            return x
        if patch_valid is None:
            patch_valid = torch.ones(x.shape[0], x.shape[1] - self.num_prefix_tokens,
                                     dtype=torch.bool, device=x.device)
        x = global_pool_naflex(x, patch_valid, pool_type=self.global_pool,
                               num_prefix_tokens=self.num_prefix_tokens)
        if self.fc_norm is not None:
            x = self.fc_norm(x)
        x = self.head_drop(x)
        if pre_logits or self.head is None:
            return x
        return self.head(x)

    def _inputs(self, x, patch_coord=None, patch_valid=None):
        """(patches, coords, valid or None for an image, patch size or None)
        from a dict batch, arrays or an NHWC image."""
        if isinstance(x, dict):
            x, patch_coord, patch_valid = x['patches'], x['patch_coord'], x.get('patch_valid')
        elif x.ndim == 4:
            x, patch_coord, _ = patchify_image(x, self.embeds.patch_size)
            patch_valid = None  # every token valid: no mask
        patch_size = None
        pd = x.shape[-1]
        if pd != self.embeds.patch_size ** 2 * self.embeds.in_chans:
            patch_size = math.isqrt(pd // self.embeds.in_chans)
        return x, patch_coord, patch_valid, patch_size

    def forward(self, patches, patch_coord: Optional[torch.Tensor] = None,
                patch_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A NaFlex dict batch, (patches, coord, valid) tensors, or an NHWC
        image (patchified here, every token valid)."""
        patches, patch_coord, patch_valid, patch_size = self._inputs(patches, patch_coord, patch_valid)
        x = self.forward_features(patches, patch_coord, patch_valid, patch_size=patch_size)
        return self.forward_head(x, patch_valid)

    def forward_intermediates(self, x, indices=None, norm: bool = False, stop_early: bool = False,
                              output_fmt: str = 'NHWC', intermediates_only: bool = False):
        """Per-block token outputs without the prefix tokens; NHWC for an
        image input, NLC for a dict batch."""
        take_indices, max_index = feature_take_indices(len(self.blocks), indices)
        grid = None
        if isinstance(x, dict):
            patches, patch_coord, patch_valid = x['patches'], x['patch_coord'], x.get('patch_valid')
        elif x.ndim == 4:
            P = self.embeds.patch_size
            grid = (x.shape[1] // P, x.shape[2] // P)
            patches, patch_coord, patch_valid = patchify_image(x, P)
        else:
            raise ValueError('forward_intermediates expects an NHWC image or a NaFlex dict')
        if output_fmt == 'NHWC' and grid is None:
            output_fmt = 'NLC'
        tokens = self.embeds(patches, patch_coord)
        attn_mask = self._attn_mask(patch_valid)
        intermediates = []
        blocks = self.blocks if not stop_early else list(self.blocks)[:max_index + 1]
        for i, blk in enumerate(blocks):
            tokens = blk(tokens, attn_mask=attn_mask)
            if i in take_indices:
                y = self.norm(tokens) if (norm and self.norm is not None) else tokens
                y = y[:, self.num_prefix_tokens:]
                if output_fmt == 'NHWC':
                    y = y.reshape(y.shape[0], grid[0], grid[1], -1)
                intermediates.append(y)
        if intermediates_only:
            return intermediates
        if self.norm is not None:
            tokens = self.norm(tokens)
        return tokens, intermediates

    def prune_intermediate_layers(self, indices=1, prune_norm: bool = False,
                                  prune_head: bool = True):
        take_indices, max_index = feature_take_indices(len(self.blocks), indices)
        self.blocks = nn.ModuleList(list(self.blocks)[:max_index + 1])
        if prune_norm:
            self.norm = None
        if prune_head:
            self.fc_norm = None
            self.reset_classifier(0)
        return take_indices


def _cfg(url: str = '', **kwargs) -> Dict[str, Any]:
    return {
        'url': url,
        'num_classes': 1000,
        'input_size': (3, 384, 384),
        'pool_size': None,
        'crop_pct': 1.0,
        'interpolation': 'bicubic',
        'mean': (0.5, 0.5, 0.5),
        'std': (0.5, 0.5, 0.5),
        'first_conv': 'embeds.proj',
        'classifier': 'head',
        **kwargs,
    }


default_cfgs = generate_default_cfgs({
    'naflexvit_base_patch16_gap.e300_s576_in1k': _cfg(hf_hub_id='timm/'),
    'naflexvit_base_patch16_par_gap.e300_s576_in1k': _cfg(hf_hub_id='timm/'),
    'naflexvit_base_patch16_map.untrained': _cfg(),
    'naflexvit_so150m2_patch16_reg1_gap.untrained': _cfg(),
    'test_naflexvit.untrained': _cfg(input_size=(3, 160, 160)),
})


def _create_naflexvit(variant: str, pretrained: bool = False, **kwargs) -> NaFlexVit:
    return build_model_with_cfg(NaFlexVit, variant, pretrained, **kwargs)


@register_model
def naflexvit_base_patch16_gap(pretrained: bool = False, **kwargs) -> NaFlexVit:
    """ViT-B/16 NaFlex with global average pooling."""
    model_args = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, global_pool='avg',
                      pos_embed='factorized', reg_tokens=0)
    return _create_naflexvit('naflexvit_base_patch16_gap', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def naflexvit_base_patch16_par_gap(pretrained: bool = False, **kwargs) -> NaFlexVit:
    """ViT-B/16 NaFlex with patch-aspect-ratio training and average pooling."""
    model_args = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, global_pool='avg',
                      pos_embed='factorized', reg_tokens=0)
    return _create_naflexvit('naflexvit_base_patch16_par_gap', pretrained=pretrained,
                             **dict(model_args, **kwargs))


@register_model
def naflexvit_base_patch16_map(pretrained: bool = False, **kwargs) -> NaFlexVit:
    model_args = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, global_pool='avg',
                      pos_embed='factorized', reg_tokens=1)
    return _create_naflexvit('naflexvit_base_patch16_map', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def naflexvit_so150m2_patch16_reg1_gap(pretrained: bool = False, **kwargs) -> NaFlexVit:
    model_args = dict(patch_size=16, embed_dim=832, depth=21, num_heads=13, mlp_ratio=34 / 8,
                      global_pool='avg', pos_embed='factorized', reg_tokens=1, qkv_bias=False)
    return _create_naflexvit('naflexvit_so150m2_patch16_reg1_gap', pretrained=pretrained,
                             **dict(model_args, **kwargs))


@register_model
def test_naflexvit(pretrained: bool = False, **kwargs) -> NaFlexVit:
    model_args = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, mlp_ratio=3,
                      global_pool='avg', pos_embed='factorized', max_grid_size=24)
    return _create_naflexvit('test_naflexvit', pretrained=pretrained, **dict(model_args, **kwargs))
