"""ConvNeXt and ConvNeXt-V2 (counterpart of timm_tpu/models/convnext.py).

Blocks are a depthwise 7x7 conv -> LayerNorm -> channels-last MLP ->
LayerScale -> DropPath, on NHWC activations as in the JAX package; V2 swaps
LayerScale for GRN in the MLP. The convolutions are ``layers.Conv2d``
(``F.conv2d`` on channels_last views, cuDNN on the card); no Pallas kernel
of the JAX package lies on this model's forward.

dtypes follow the JAX model: the convolutions, MLPs and head ``fc`` take
the model's ``dtype``; every norm (the stem's, the downsamples', the
blocks', the head's) is built without one, so on bf16 input it returns
fp32. So with ``dtype=torch.bfloat16`` the stem's output and stage 0's
residual stream are fp32 (``x + shortcut`` promotes), while stages 1-3,
which start at a bf16 downsample conv, carry a bf16 stream, as JAX's do.

Ported: the modules, the model contract (no_weight_decay, group_matcher,
get_classifier, reset_classifier, forward_features, forward_head,
forward_intermediates, prune_intermediate_layers), the default cfgs and
every registered entrypoint. ``conv_mlp`` is accepted and ignored, and
``head_init_scale`` accepted and unused, as in JAX. Gradient checkpointing
runs each stage's blocks through ``checkpoint_seq``; stage scan (block scan)
is accepted and runs the same loop, as a CUDA graph captures the step once;
``features_only`` takes the four stages; ``checkpoint_filter_fn`` maps upstream
torch timm names and needs a hub (ROADMAP A.5.1): weights come from the
JAX package through ``load_jax_state_dict``.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..layers import (
    ClassifierHead, DropPath, GlobalResponseNormMlp, LayerNorm, LayerScale, Mlp,
    NormMlpClassifierHead, calculate_drop_path_rates, create_conv2d, get_act_fn,
    get_norm_layer, make_divisible,
)
from ._builder import build_model_with_cfg
from ._features import feature_take_indices
from ._manipulate import checkpoint_seq
from ._registry import generate_default_cfgs, register_model

__all__ = ['ConvNeXt', 'ConvNeXtBlock', 'ConvNeXtStage', 'Downsample']


class Downsample(nn.Module):
    def __init__(self, in_chs, out_chs, stride=1, dilation=1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = create_conv2d(in_chs, out_chs, 1, stride=stride, dilation=dilation, bias=True,
                                  dtype=dtype, generator=generator) \
            if in_chs != out_chs or stride > 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.conv is None else self.conv(x)


class ConvNeXtBlock(nn.Module):
    def __init__(
            self,
            in_chs: int,
            out_chs: Optional[int] = None,
            kernel_size: int = 7,
            stride: int = 1,
            dilation: int = 1,
            mlp_ratio: float = 4.0,
            conv_bias: bool = True,
            use_grn: bool = False,
            ls_init_value: Optional[float] = 1e-6,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Optional[Callable] = None,
            drop_path: float = 0.0,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_chs = out_chs or in_chs
        norm_layer = norm_layer or LayerNorm
        self.use_shortcut = stride == 1 and in_chs == out_chs
        self.conv_dw = create_conv2d(in_chs, out_chs, kernel_size, stride=stride,
                                     dilation=dilation, depthwise=True, bias=conv_bias,
                                     dtype=dtype, generator=generator)
        self.norm = norm_layer(out_chs)
        mlp_layer = GlobalResponseNormMlp if use_grn else Mlp
        self.mlp = mlp_layer(out_chs, int(mlp_ratio * out_chs), act_layer=act_layer, dtype=dtype,
                             generator=generator)
        self.ls = LayerScale(out_chs, ls_init_value) if ls_init_value is not None else None
        self.drop_path = DropPath(drop_path)
        self.shortcut = None if self.use_shortcut else Downsample(
            in_chs, out_chs, stride=stride, dilation=dilation, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.mlp(self.norm(self.conv_dw(x)))
        if self.ls is not None:
            x = self.ls(x)
        x = self.drop_path(x)
        if self.shortcut is not None:
            shortcut = self.shortcut(shortcut)
        return x + shortcut


class ConvNeXtStage(nn.Module):
    def __init__(
            self,
            in_chs: int,
            out_chs: int,
            kernel_size: int = 7,
            stride: int = 2,
            depth: int = 2,
            dilation=(1, 1),
            drop_path_rates=None,
            ls_init_value: Optional[float] = 1.0,
            conv_bias: bool = True,
            use_grn: bool = False,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Optional[Callable] = None,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        norm_layer = norm_layer or LayerNorm
        if in_chs != out_chs or stride > 1 or dilation[0] != dilation[1]:
            self.downsample_norm = norm_layer(in_chs)
            self.downsample_conv = create_conv2d(
                in_chs, out_chs, stride if stride > 1 else 1, stride=stride,
                dilation=dilation[0], padding=0, bias=conv_bias, dtype=dtype, generator=generator)
            in_chs = out_chs
        else:
            self.downsample_norm = None
            self.downsample_conv = None
        drop_path_rates = drop_path_rates or [0.0] * depth
        self.blocks = nn.ModuleList([
            ConvNeXtBlock(
                in_chs=in_chs if i == 0 else out_chs, out_chs=out_chs, kernel_size=kernel_size,
                dilation=dilation[1], drop_path=drop_path_rates[i], ls_init_value=ls_init_value,
                conv_bias=conv_bias, use_grn=use_grn, act_layer=act_layer, norm_layer=norm_layer,
                dtype=dtype, generator=generator)
            for i in range(depth)])
        self.grad_checkpointing = False
        self.stage_scan = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample_norm is not None:
            x = self.downsample_conv(self.downsample_norm(x))
        if self.grad_checkpointing:
            return checkpoint_seq(self.blocks, x)
        for blk in self.blocks:
            x = blk(x)
        return x


class ConvNeXt(nn.Module):
    def __init__(
            self,
            in_chans: int = 3,
            num_classes: int = 1000,
            global_pool: str = 'avg',
            output_stride: int = 32,
            depths: Tuple[int, ...] = (3, 3, 9, 3),
            dims: Tuple[int, ...] = (96, 192, 384, 768),
            kernel_sizes: Union[int, Tuple[int, ...]] = 7,
            ls_init_value: Optional[float] = 1e-6,
            stem_type: str = 'patch',
            patch_size: int = 4,
            head_init_scale: float = 1.0,
            head_norm_first: bool = False,
            head_hidden_size: Optional[int] = None,
            conv_bias: bool = True,
            use_grn: bool = False,
            conv_mlp: bool = False,
            act_layer: Union[str, Callable] = 'gelu',
            norm_layer: Optional[Union[str, Callable]] = None,
            norm_eps: Optional[float] = None,
            drop_rate: float = 0.0,
            drop_path_rate: float = 0.0,
            stage_scan: Optional[bool] = None,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if output_stride not in (8, 16, 32):
            raise ValueError(f'output_stride {output_stride} not in (8, 16, 32)')
        if isinstance(kernel_sizes, int):
            kernel_sizes = (kernel_sizes,) * 4
        # conv_mlp only picks the upstream torch layout of the MLP; on NHWC a
        # Linear is the 1x1 conv, so it changes nothing here (as in JAX)
        del conv_mlp
        norm_layer = get_norm_layer(norm_layer) or LayerNorm
        if norm_eps is not None:
            norm_layer = partial(norm_layer, eps=norm_eps)
        self.num_classes = num_classes
        self.drop_rate = drop_rate
        self._dtype = dtype
        conv = partial(create_conv2d, bias=conv_bias, dtype=dtype, generator=generator)

        if stem_type not in ('patch', 'overlap', 'overlap_tiered', 'overlap_act'):
            raise ValueError(f'Unknown stem_type {stem_type}')
        self.stem_act = None
        if stem_type == 'patch':
            self.stem_conv = conv(in_chans, dims[0], patch_size, stride=patch_size, padding=0)
            self.stem_conv2 = None
            stem_stride = patch_size
        else:
            mid_chs = make_divisible(dims[0] // 2) if 'tiered' in stem_type else dims[0]
            self.stem_conv = conv(in_chans, mid_chs, 3, stride=2, padding=None)
            self.stem_act = get_act_fn(act_layer) if 'act' in stem_type else None
            self.stem_conv2 = conv(mid_chs, dims[0], 3, stride=2, padding=None)
            stem_stride = 4
        self.stem_norm = norm_layer(dims[0])

        dp_rates = calculate_drop_path_rates(drop_path_rate, list(depths), stagewise=True)
        stages = []
        prev_chs = dims[0]
        curr_stride = stem_stride
        dilation = 1
        self.feature_info = []
        for i in range(len(depths)):
            stride = 2 if curr_stride == 2 or i > 0 else 1
            if curr_stride >= output_stride and stride > 1:
                dilation *= stride
                stride = 1
            curr_stride *= stride
            first_dilation = 1 if dilation in (1, 2) else 2
            out_chs = dims[i]
            stages.append(ConvNeXtStage(
                prev_chs, out_chs, kernel_size=kernel_sizes[i], stride=stride,
                dilation=(first_dilation, dilation), depth=depths[i], drop_path_rates=dp_rates[i],
                ls_init_value=ls_init_value, conv_bias=conv_bias, use_grn=use_grn,
                act_layer=act_layer, norm_layer=norm_layer, dtype=dtype, generator=generator))
            prev_chs = out_chs
            self.feature_info += [dict(num_chs=prev_chs, reduction=curr_stride, module=f'stages.{i}')]
        self.stages = nn.ModuleList(stages)
        self.set_stage_scan(bool(stage_scan))

        self.num_features = self.head_hidden_size = prev_chs
        if head_norm_first:
            self.norm_pre = norm_layer(self.num_features)
            self.head = ClassifierHead(self.num_features, num_classes, pool_type=global_pool,
                                       drop_rate=drop_rate, dtype=dtype, generator=generator)
        else:
            self.norm_pre = None
            self.head = NormMlpClassifierHead(
                self.num_features, num_classes, hidden_size=head_hidden_size,
                pool_type=global_pool, drop_rate=drop_rate, norm_layer=norm_layer,
                act_layer='gelu', dtype=dtype, generator=generator)
            if head_hidden_size:
                self.head_hidden_size = head_hidden_size

    # -- contract ------------------------------------------------------------
    def no_weight_decay(self) -> set:
        return set()

    def group_matcher(self, coarse: bool = False):
        return dict(
            stem=r'^stem_',
            blocks=r'^stages\.(\d+)' if coarse else [
                (r'^stages\.(\d+)\.downsample', (0,)),
                (r'^stages\.(\d+)\.blocks\.(\d+)', None),
                (r'^norm_pre', (99999,)),
            ],
        )

    def set_grad_checkpointing(self, enable: bool = True):
        for s in self.stages:
            s.grad_checkpointing = enable

    def set_stage_scan(self, enable: bool = True):
        """Accepted for the JAX contract; the stages run their block loop
        either way (a CUDA graph captures the step once)."""
        for s in self.stages:
            s.stage_scan = enable

    set_block_scan = set_stage_scan

    def get_classifier(self) -> Optional[nn.Module]:
        return self.head.fc

    def reset_classifier(self, num_classes: int, global_pool: Optional[str] = None,
                         generator: Optional[torch.Generator] = None):
        self.num_classes = num_classes
        self.head.reset(num_classes, pool_type=global_pool, generator=generator)
        self.head.to(self.stem_conv.weight.device)

    # -- forward -------------------------------------------------------------
    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_conv(x)
        if self.stem_conv2 is not None:
            if self.stem_act is not None:
                x = self.stem_act(x)
            x = self.stem_conv2(x)
        return self.stem_norm(x)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H/32, W/32, num_features)."""
        x = self._stem(x)
        for stage in self.stages:
            x = stage(x)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        return x

    def forward_head(self, x: torch.Tensor, pre_logits: bool = False) -> torch.Tensor:
        return self.head(x, pre_logits=pre_logits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_head(self.forward_features(x))

    def forward_intermediates(
            self,
            x: torch.Tensor,
            indices: Optional[Union[int, List[int]]] = None,
            norm: bool = False,
            stop_early: bool = False,
            output_fmt: str = 'NHWC',
            intermediates_only: bool = False,
    ):
        """The stages' NHWC outputs at ``indices``, and the final features
        unless ``intermediates_only``."""
        if output_fmt != 'NHWC':
            raise ValueError('Conv models emit NHWC features')
        take_indices, max_index = feature_take_indices(len(self.stages), indices)
        x = self._stem(x)
        intermediates = []
        stages = self.stages if not stop_early else list(self.stages)[:max_index + 1]
        for i, stage in enumerate(stages):
            x = stage(x)
            if i in take_indices:
                intermediates.append(x)
        if intermediates_only:
            return intermediates
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        return x, intermediates

    def prune_intermediate_layers(self, indices=1, prune_norm: bool = False,
                                  prune_head: bool = True):
        take_indices, max_index = feature_take_indices(len(self.stages), indices)
        self.stages = self.stages[:max_index + 1]
        if prune_norm:
            self.norm_pre = None
        if prune_head:
            self.reset_classifier(0, '')
        return take_indices


def _cfg(url: str = '', **kwargs) -> Dict[str, Any]:
    return {
        'url': url,
        'num_classes': 1000,
        'input_size': (3, 224, 224),
        'pool_size': (7, 7),
        'crop_pct': 0.875,
        'interpolation': 'bicubic',
        'mean': (0.485, 0.456, 0.406),
        'std': (0.229, 0.224, 0.225),
        'first_conv': 'stem_conv',
        'classifier': 'head.fc',
        **kwargs,
    }


_CLIP_MEAN, _CLIP_STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
_IN_MEAN, _IN_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _cfg2(size=224, pool=7, crop_pct=0.875, mean=_IN_MEAN, std=_IN_STD, **kwargs):
    """The cfgs of the JAX package's later entries (stem.0 / head.fc names)."""
    return _cfg(input_size=(3, size, size), pool_size=(pool, pool), crop_pct=crop_pct, mean=mean,
                std=std, first_conv='stem.0', classifier='head.fc', **kwargs)


_HUB = dict(hf_hub_id='timm/')
_R160 = dict(_HUB, input_size=(3, 160, 160), crop_pct=0.95)
_T288 = dict(test_input_size=(3, 288, 288))

default_cfgs = generate_default_cfgs({
    'convnext_atto.d2_in1k': _cfg(**_HUB),
    'convnext_femto.d1_in1k': _cfg(**_HUB),
    'convnext_pico.d1_in1k': _cfg(**_HUB),
    'convnext_nano.d1h_in1k': _cfg(**_HUB),
    'convnext_tiny.fb_in1k': _cfg(**_HUB),
    'convnext_small.fb_in1k': _cfg(**_HUB),
    'convnext_base.fb_in1k': _cfg(**_HUB),
    'convnext_large.fb_in1k': _cfg(**_HUB),
    'convnextv2_atto.fcmae_ft_in1k': _cfg(**_HUB),
    'convnextv2_nano.fcmae_ft_in1k': _cfg(**_HUB),
    'convnextv2_tiny.fcmae_ft_in1k': _cfg(**_HUB),
    'convnextv2_base.fcmae_ft_in1k': _cfg(**_HUB),
    'test_convnext.r160_in1k': _cfg(**_R160),
    'test_convnext2.r160_in1k': _cfg(**_R160),
    'test_convnext3.r160_in1k': _cfg(**_R160),
    'convnext_zepto_rms.ra4_e3600_r224_in1k': _cfg2(mean=(0.5,) * 3, std=(0.5,) * 3, **_HUB),
    'convnext_zepto_rms_ols.ra4_e3600_r224_in1k': _cfg2(crop_pct=0.9, mean=(0.5,) * 3,
                                                        std=(0.5,) * 3, **_HUB),
    'convnext_atto_ols.a2_in1k': _cfg2(test_crop_pct=0.95, **_T288, **_HUB),
    'convnext_atto_rms.untrained': _cfg2(test_input_size=(3, 256, 256), test_crop_pct=0.95),
    'convnext_femto_ols.d1_in1k': _cfg2(test_crop_pct=0.95, **_T288, **_HUB),
    'convnext_pico_ols.d1_in1k': _cfg2(crop_pct=0.95, test_crop_pct=1.0, **_T288, **_HUB),
    'convnext_nano_ols.d1h_in1k': _cfg2(crop_pct=0.95, test_crop_pct=1.0, **_T288, **_HUB),
    'convnext_tiny_hnf.a2h_in1k': _cfg2(crop_pct=0.95, test_crop_pct=1.0, **_T288, **_HUB),
    'convnext_large_mlp.clip_laion2b_soup_ft_in12k_in1k_320': _cfg2(
        320, 10, 1.0, _CLIP_MEAN, _CLIP_STD, **_HUB),
    'convnext_large_mlp.clip_laion2b_soup_ft_in12k_in1k_384': _cfg2(
        384, 12, 1.0, _CLIP_MEAN, _CLIP_STD, crop_mode='squash', **_HUB),
    'convnext_large_mlp.clip_laion2b_augreg_ft_in1k': _cfg2(
        256, 8, 1.0, _CLIP_MEAN, _CLIP_STD, **_HUB),
    'convnext_large_mlp.clip_laion2b_augreg_ft_in1k_384': _cfg2(
        384, 12, 1.0, _CLIP_MEAN, _CLIP_STD, crop_mode='squash', **_HUB),
    'convnext_large_mlp.clip_laion2b_soup_ft_in12k_320': _cfg2(
        320, 10, 1.0, _CLIP_MEAN, _CLIP_STD, num_classes=11821, **_HUB),
    'convnext_large_mlp.clip_laion2b_augreg_ft_in12k_384': _cfg2(
        384, 12, 1.0, _CLIP_MEAN, _CLIP_STD, num_classes=11821, crop_mode='squash', **_HUB),
    'convnext_large_mlp.clip_laion2b_soup_ft_in12k_384': _cfg2(
        384, 12, 1.0, _CLIP_MEAN, _CLIP_STD, num_classes=11821, crop_mode='squash', **_HUB),
    'convnext_large_mlp.clip_laion2b_augreg': _cfg2(
        256, 8, 1.0, _CLIP_MEAN, _CLIP_STD, num_classes=768, **_HUB),
    'convnext_large_mlp.clip_laion2b_ft_320': _cfg2(
        320, 10, 1.0, _CLIP_MEAN, _CLIP_STD, num_classes=768, **_HUB),
    'convnext_large_mlp.clip_laion2b_ft_soup_320': _cfg2(
        320, 10, 1.0, _CLIP_MEAN, _CLIP_STD, num_classes=768, **_HUB),
    'convnext_xlarge.fb_in22k_ft_in1k': _cfg2(test_crop_pct=1.0, **_T288, **_HUB),
    'convnext_xlarge.fb_in22k_ft_in1k_384': _cfg2(384, 12, 1.0, crop_mode='squash', **_HUB),
    'convnext_xlarge.fb_in22k': _cfg2(num_classes=21841, **_HUB),
    'convnext_xxlarge.clip_laion2b_soup_ft_in1k': _cfg2(256, 8, 1.0, _CLIP_MEAN, _CLIP_STD, **_HUB),
    'convnext_xxlarge.clip_laion2b_soup_ft_in12k': _cfg2(
        256, 8, 1.0, _CLIP_MEAN, _CLIP_STD, num_classes=11821, **_HUB),
    'convnext_xxlarge.clip_laion2b_soup': _cfg2(
        256, 8, 1.0, _CLIP_MEAN, _CLIP_STD, num_classes=1024, **_HUB),
    'convnext_xxlarge.clip_laion2b_rewind': _cfg2(
        256, 8, 1.0, _CLIP_MEAN, _CLIP_STD, num_classes=1024, **_HUB),
    'convnextv2_femto.fcmae_ft_in1k': _cfg2(test_crop_pct=0.95, **_T288, **_HUB),
    'convnextv2_femto.fcmae': _cfg2(num_classes=0, **_HUB),
    'convnextv2_pico.fcmae_ft_in1k': _cfg2(test_crop_pct=0.95, **_T288, **_HUB),
    'convnextv2_pico.fcmae': _cfg2(num_classes=0, **_HUB),
    'convnextv2_small.untrained': _cfg2(),
    'convnextv2_large.fcmae_ft_in22k_in1k': _cfg2(test_crop_pct=1.0, **_T288, **_HUB),
    'convnextv2_large.fcmae_ft_in22k_in1k_384': _cfg2(384, 12, 1.0, crop_mode='squash', **_HUB),
    'convnextv2_large.fcmae_ft_in1k': _cfg2(test_crop_pct=1.0, **_T288, **_HUB),
    'convnextv2_large.fcmae': _cfg2(num_classes=0, **_HUB),
    'convnextv2_huge.fcmae_ft_in22k_in1k_384': _cfg2(384, 12, 1.0, crop_mode='squash', **_HUB),
    'convnextv2_huge.fcmae_ft_in22k_in1k_512': _cfg2(512, 15, 1.0, crop_mode='squash', **_HUB),
    'convnextv2_huge.fcmae_ft_in1k': _cfg2(test_crop_pct=1.0, **_T288, **_HUB),
    'convnextv2_huge.fcmae': _cfg2(num_classes=0, **_HUB),
})


def _create_convnext(variant: str, pretrained: bool = False, **kwargs) -> ConvNeXt:
    out_indices = kwargs.pop('out_indices', (0, 1, 2, 3))
    return build_model_with_cfg(ConvNeXt, variant, pretrained,
                                feature_cfg=dict(out_indices=out_indices), **kwargs)


def _entry(variant: str, **model_args):
    """Register the entrypoint ``variant`` building ConvNeXt with
    ``model_args`` (a caller's kwargs override them)."""
    def entrypoint(pretrained: bool = False, **kwargs) -> ConvNeXt:
        return _create_convnext(variant, pretrained=pretrained, **dict(model_args, **kwargs))
    entrypoint.__name__ = entrypoint.__qualname__ = variant
    entrypoint.__module__ = __name__
    return register_model(entrypoint)


_V2 = dict(use_grn=True, ls_init_value=None)
convnext_atto = _entry('convnext_atto', depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
convnext_femto = _entry('convnext_femto', depths=(2, 2, 6, 2), dims=(48, 96, 192, 384))
convnext_pico = _entry('convnext_pico', depths=(2, 2, 6, 2), dims=(64, 128, 256, 512))
convnext_nano = _entry('convnext_nano', depths=(2, 2, 8, 2), dims=(80, 160, 320, 640))
convnext_tiny = _entry('convnext_tiny', depths=(3, 3, 9, 3), dims=(96, 192, 384, 768))
convnext_small = _entry('convnext_small', depths=(3, 3, 27, 3), dims=(96, 192, 384, 768))
convnext_base = _entry('convnext_base', depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024))
convnext_large = _entry('convnext_large', depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536))
convnextv2_atto = _entry('convnextv2_atto', depths=(2, 2, 6, 2), dims=(40, 80, 160, 320),
                         conv_bias=True, **_V2)
convnextv2_nano = _entry('convnextv2_nano', depths=(2, 2, 8, 2), dims=(80, 160, 320, 640),
                         conv_bias=True, **_V2)
convnextv2_tiny = _entry('convnextv2_tiny', depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), **_V2)
convnextv2_base = _entry('convnextv2_base', depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                         **_V2)
test_convnext = _entry('test_convnext', depths=(1, 2, 4, 2), dims=(24, 32, 48, 64),
                       norm_layer='layernorm')
test_convnext2 = _entry('test_convnext2', depths=(1, 1, 1, 1), dims=(32, 64, 96, 128))
test_convnext3 = _entry('test_convnext3', depths=(1, 1, 1, 1), dims=(32, 64, 96, 128),
                        stem_type='overlap_tiered', **_V2)
convnext_zepto_rms = _entry('convnext_zepto_rms', depths=(2, 2, 4, 2), dims=(32, 64, 128, 256),
                            conv_mlp=True, norm_layer='simplenorm')
convnext_zepto_rms_ols = _entry('convnext_zepto_rms_ols', depths=(2, 2, 4, 2),
                                dims=(32, 64, 128, 256), conv_mlp=True, norm_layer='simplenorm',
                                stem_type='overlap_act')
convnext_atto_ols = _entry('convnext_atto_ols', depths=(2, 2, 6, 2), dims=(40, 80, 160, 320),
                           conv_mlp=True, stem_type='overlap_tiered')
convnext_atto_rms = _entry('convnext_atto_rms', depths=(2, 2, 6, 2), dims=(40, 80, 160, 320),
                           conv_mlp=True, norm_layer='rmsnorm2d')
convnext_femto_ols = _entry('convnext_femto_ols', depths=(2, 2, 6, 2), dims=(48, 96, 192, 384),
                            conv_mlp=True, stem_type='overlap_tiered')
convnext_pico_ols = _entry('convnext_pico_ols', depths=(2, 2, 6, 2), dims=(64, 128, 256, 512),
                           conv_mlp=True, stem_type='overlap_tiered')
convnext_nano_ols = _entry('convnext_nano_ols', depths=(2, 2, 8, 2), dims=(80, 160, 320, 640),
                           conv_mlp=True, stem_type='overlap')
convnext_tiny_hnf = _entry('convnext_tiny_hnf', depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                           head_norm_first=True, conv_mlp=True)
convnext_large_mlp = _entry('convnext_large_mlp', depths=(3, 3, 27, 3),
                            dims=(192, 384, 768, 1536), head_hidden_size=1536)
convnext_xlarge = _entry('convnext_xlarge', depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048))
convnext_xxlarge = _entry('convnext_xxlarge', depths=(3, 4, 30, 3), dims=(384, 768, 1536, 3072),
                          norm_eps=1e-5)
convnextv2_femto = _entry('convnextv2_femto', depths=(2, 2, 6, 2), dims=(48, 96, 192, 384),
                          conv_mlp=True, **_V2)
convnextv2_pico = _entry('convnextv2_pico', depths=(2, 2, 6, 2), dims=(64, 128, 256, 512),
                         conv_mlp=True, **_V2)
convnextv2_small = _entry('convnextv2_small', depths=(3, 3, 27, 3), dims=(96, 192, 384, 768),
                          **_V2)
convnextv2_large = _entry('convnextv2_large', depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536),
                          **_V2)
convnextv2_huge = _entry('convnextv2_huge', depths=(3, 3, 27, 3), dims=(352, 704, 1408, 2816),
                         **_V2)
