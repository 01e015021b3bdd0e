"""DeiT (counterpart of timm_tpu/models/deit.py).

``VisionTransformerDistilled`` adds a distillation token after the class
token and a second head on it; the forward averages the two heads' logits
(both are returned while ``distilled_training`` is on). DeiT-III is the
plain ``VisionTransformer`` with layer scale and ``no_embed_class``. The 5
entrypoints and cfgs are the JAX module's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..layers import Linear, trunc_normal_
from ._builder import build_model_with_cfg
from ._registry import generate_default_cfgs, register_model
from .vision_transformer import VisionTransformer

__all__ = ['VisionTransformerDistilled']


class VisionTransformerDistilled(VisionTransformer):
    """ViT with a distillation token and its own head."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        if kwargs.pop('global_pool', 'token') != 'token':
            raise ValueError('VisionTransformerDistilled needs token pooling')
        kwargs.pop('class_token', None)
        super().__init__(*args, class_token=True, global_pool='token', generator=generator,
                         **kwargs)
        self.num_prefix_tokens += 1
        self.dist_token = nn.Parameter(trunc_normal_(
            torch.empty(1, 1, self.embed_dim), std=0.02, generator=generator))
        # the position embedding needs the extra token's slot: drawn anew,
        # after the distillation token, as JAX draws it
        num_patches = self.patch_embed.num_patches
        embed_len = num_patches if self.no_embed_class else num_patches + self.num_prefix_tokens
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, embed_len, self.embed_dim), std=0.02, generator=generator))
        self.head_dist = Linear(self.embed_dim, self.num_classes, dtype=self._dtype,
                                generator=generator) if self.num_classes > 0 else None
        self.distilled_training = False  # set by a distillation task

    def group_matcher(self, coarse: bool = False) -> Dict:
        return dict(
            stem=r'^cls_token|pos_embed|patch_embed|dist_token',
            blocks=[(r'^blocks\.(\d+)', None), (r'^norm', (99999,))],
        )

    def no_weight_decay(self) -> set:
        return super().no_weight_decay() | {'dist_token'}

    def get_classifier(self):
        return self.head, self.head_dist

    def reset_classifier(self, num_classes: int, global_pool: Optional[str] = None,
                         generator: Optional[torch.Generator] = None):
        super().reset_classifier(num_classes, global_pool, generator=generator)
        self.head_dist = Linear(self.embed_dim, num_classes, dtype=self._dtype,
                                generator=generator).to(self._device()) if num_classes > 0 else None

    def set_distilled_training(self, enable: bool = True) -> None:
        self.distilled_training = enable

    def _prefix_tokens(self, x: torch.Tensor):
        B = x.shape[0]
        return [self.cls_token.to(x.dtype).expand(B, -1, -1),
                self.dist_token.to(x.dtype).expand(B, -1, -1)]

    def forward_head(self, x: torch.Tensor, pre_logits: bool = False):
        x_cls, x_dist = x[:, 0], x[:, 1]
        if pre_logits or self.head is None or self.head_dist is None:
            return (x_cls + x_dist) / 2
        x_cls, x_dist = self.head(x_cls), self.head_dist(x_dist)
        if self.distilled_training:
            return x_cls, x_dist
        return (x_cls + x_dist) / 2


def _cfg(url: str = '', **kwargs) -> Dict[str, Any]:
    return {
        'url': url,
        'num_classes': 1000,
        'input_size': (3, 224, 224),
        'pool_size': None,
        'crop_pct': 0.875,
        'interpolation': 'bicubic',
        'fixed_input_size': True,
        'mean': (0.485, 0.456, 0.406),
        'std': (0.229, 0.224, 0.225),
        'first_conv': 'patch_embed.proj',
        'classifier': ('head', 'head_dist'),
        **kwargs,
    }


default_cfgs = generate_default_cfgs({
    'deit_tiny_distilled_patch16_224.fb_in1k': _cfg(hf_hub_id='timm/'),
    'deit_small_distilled_patch16_224.fb_in1k': _cfg(hf_hub_id='timm/'),
    'deit_base_distilled_patch16_224.fb_in1k': _cfg(hf_hub_id='timm/'),
    'deit3_small_patch16_224.fb_in22k_ft_in1k': _cfg(hf_hub_id='timm/', classifier='head'),
    'deit3_base_patch16_224.fb_in22k_ft_in1k': _cfg(hf_hub_id='timm/', classifier='head'),
})


def _create_deit(variant: str, pretrained: bool = False, distilled: bool = False, **kwargs):
    model_cls = VisionTransformerDistilled if distilled else VisionTransformer
    return build_model_with_cfg(model_cls, variant, pretrained, **kwargs)


@register_model
def deit_tiny_distilled_patch16_224(pretrained=False, **kwargs):
    model_args = dict(patch_size=16, embed_dim=192, depth=12, num_heads=3)
    return _create_deit('deit_tiny_distilled_patch16_224', pretrained, distilled=True, **dict(model_args, **kwargs))


@register_model
def deit_small_distilled_patch16_224(pretrained=False, **kwargs):
    model_args = dict(patch_size=16, embed_dim=384, depth=12, num_heads=6)
    return _create_deit('deit_small_distilled_patch16_224', pretrained, distilled=True, **dict(model_args, **kwargs))


@register_model
def deit_base_distilled_patch16_224(pretrained=False, **kwargs):
    model_args = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12)
    return _create_deit('deit_base_distilled_patch16_224', pretrained, distilled=True, **dict(model_args, **kwargs))


@register_model
def deit3_small_patch16_224(pretrained=False, **kwargs):
    """DeiT-III: no distillation token, layer scale, no position embedding
    for the class token."""
    model_args = dict(
        patch_size=16, embed_dim=384, depth=12, num_heads=6, no_embed_class=True, init_values=1e-6)
    return _create_deit('deit3_small_patch16_224', pretrained, **dict(model_args, **kwargs))


@register_model
def deit3_base_patch16_224(pretrained=False, **kwargs):
    model_args = dict(
        patch_size=16, embed_dim=768, depth=12, num_heads=12, no_embed_class=True, init_values=1e-6)
    return _create_deit('deit3_base_patch16_224', pretrained, **dict(model_args, **kwargs))
