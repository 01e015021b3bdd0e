"""EfficientNet / EfficientNetV2 and the MobileNet / MNASNet / MixNet
family built by the same arch-string decoder (counterpart of
timm_tpu/models/efficientnet.py).

Depthwise convolutions, SE and SiLU over NHWC activations: a stem conv with
its BatchNorm + act, the stages of ``_efficientnet_builder.py``, a 1x1 head
conv with its BatchNorm + act, global pooling, dropout and the classifier.
The convolutions are ``layers.Conv2d`` (``F.conv2d`` on channels_last
views, cuDNN on the card) and the norms ``BatchNormAct2d``
(``layers/norm.py``: flax's BatchNorm semantics, running statistics
updated in place); no Pallas kernel of the JAX package lies on this
model's forward. Every module takes the model's ``dtype``, as in JAX: with
``dtype=torch.bfloat16`` the whole stream is bf16, BatchNorm's training
arithmetic fp32 inside.

Ported: the model, its contract (no_weight_decay, group_matcher,
get_classifier, reset_classifier, forward_features, forward_head,
forward_intermediates, prune_intermediate_layers), the default cfgs and
every registered entrypoint of the JAX module. Three raise, because a layer
they need comes with the rest of the zoo (ROADMAP A.5.9):
``efficientnet_blur_b0`` (blur pool), ``gc_efficientnetv2_rw_t`` (the 'gc'
attention) and ``test_efficientnet_evos`` (EvoNorm). Gradient
checkpointing runs each stage through ``checkpoint_seq`` (the running
statistics are written once a step); ``features_only`` takes the JAX
feature points (the five stride levels of a 7-stack net, else every
stack); ``checkpoint_filter_fn`` maps upstream torch timm names and needs a hub
(ROADMAP A.5.1): weights come from the JAX package through
``load_jax_state_dict``.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch import nn

from ..layers import (
    BatchNormAct2d, Dropout, GroupNormAct, LayerNormAct2d, Linear, SelectAdaptivePool2d,
    SqueezeExcite, create_conv2d, get_attn,
)
from ._builder import build_model_with_cfg
from ._efficientnet_builder import (
    BN_EPS_TF_DEFAULT, EfficientNetBuilder, decode_arch_def, resolve_act_layer, resolve_bn_args,
    round_channels,
)
from ._features import feature_take_indices
from ._manipulate import checkpoint_seq
from ._registry import generate_default_cfgs, register_model

__all__ = ['EfficientNet']


def EvoNorm2dS0(*args, **kwargs):  # noqa: N802 (the JAX package's class name)
    raise NotImplementedError('EvoNorm2dS0 is not ported yet (ROADMAP A.5.9, with the rest of '
                              'the zoo)')


class EfficientNet(nn.Module):
    def __init__(
            self,
            block_args: List[List[Dict]],
            num_classes: int = 1000,
            num_features: int = 1280,
            in_chans: int = 3,
            stem_size: int = 32,
            stem_kernel_size: int = 3,
            fix_stem: bool = False,
            output_stride: int = 32,
            pad_type: str = '',
            act_layer: Union[str, Callable] = 'relu',
            norm_layer: Callable = BatchNormAct2d,
            aa_layer: Optional[Union[str, Callable]] = None,
            se_layer: Optional[Union[str, Callable]] = None,
            se_from_exp: bool = False,
            round_chs_fn: Callable = round_channels,
            drop_rate: float = 0.0,
            drop_path_rate: float = 0.0,
            global_pool: str = 'avg',
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.drop_rate = drop_rate
        self._dtype = dtype
        if not fix_stem:
            stem_size = round_chs_fn(stem_size)
        self.conv_stem = create_conv2d(in_chans, stem_size, stem_kernel_size, stride=2,
                                       padding=pad_type or None, dtype=dtype, generator=generator)
        self.bn1 = norm_layer(stem_size, act_layer=act_layer, dtype=dtype)

        builder_se = get_attn(se_layer) if isinstance(se_layer, str) else se_layer
        builder = EfficientNetBuilder(
            output_stride=output_stride, pad_type=pad_type, round_chs_fn=round_chs_fn,
            se_from_exp=se_from_exp, act_layer=act_layer, norm_layer=norm_layer,
            aa_layer=aa_layer, se_layer=builder_se if builder_se is not None else SqueezeExcite,
            drop_path_rate=drop_path_rate, dtype=dtype, generator=generator)
        self.blocks = nn.Sequential(*builder(stem_size, block_args))
        self.feature_info = builder.features
        self.grad_checkpointing = False
        head_chs = builder.in_chs

        # num_features == 0: no head conv
        if num_features > 0:
            self.conv_head = create_conv2d(head_chs, num_features, 1, padding=pad_type or None,
                                           dtype=dtype, generator=generator)
            self.bn2 = norm_layer(num_features, act_layer=act_layer, dtype=dtype)
        else:
            self.conv_head = None
            self.bn2 = None
            num_features = head_chs
        self.num_features = self.head_hidden_size = num_features
        self.global_pool = SelectAdaptivePool2d(pool_type=global_pool, flatten=True)
        self.head_drop = Dropout(drop_rate)
        self.classifier = Linear(num_features, num_classes, dtype=dtype, generator=generator) \
            if num_classes > 0 else None

    # -- contract ------------------------------------------------------------
    def no_weight_decay(self) -> set:
        return set()

    def group_matcher(self, coarse: bool = False):
        return dict(
            stem=r'^conv_stem|bn1',
            blocks=[
                (r'^blocks\.(\d+)' if coarse else r'^blocks\.(\d+)\.(\d+)', None),
                (r'conv_head|bn2', (99999,)),
            ],
        )

    def set_grad_checkpointing(self, enable: bool = True):
        self.grad_checkpointing = enable

    def get_classifier(self) -> Optional[nn.Module]:
        return self.classifier

    def reset_classifier(self, num_classes: int, global_pool: Optional[str] = None,
                         generator: Optional[torch.Generator] = None):
        self.num_classes = num_classes
        if global_pool is not None:
            self.global_pool = SelectAdaptivePool2d(pool_type=global_pool, flatten=True)
        self.classifier = Linear(self.num_features, num_classes, dtype=self._dtype,
                                 generator=generator).to(self.conv_stem.weight.device) \
            if num_classes > 0 else None

    # -- forward -------------------------------------------------------------
    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H/32, W/32, num_features)."""
        x = self.bn1(self.conv_stem(x))
        for stage in self.blocks:
            x = checkpoint_seq(stage, x) if self.grad_checkpointing else stage(x)
        if self.conv_head is not None:
            x = self.bn2(self.conv_head(x))
        return x

    def forward_head(self, x: torch.Tensor, pre_logits: bool = False) -> torch.Tensor:
        x = self.head_drop(self.global_pool(x))
        if pre_logits or self.classifier is None:
            return x
        return self.classifier(x)

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
        take_indices, max_index = feature_take_indices(len(self.blocks), indices)
        x = self.bn1(self.conv_stem(x))
        intermediates = []
        stages = self.blocks if not stop_early else list(self.blocks)[:max_index + 1]
        for i, stage in enumerate(stages):
            x = stage(x)
            if i in take_indices:
                intermediates.append(x)
        if intermediates_only:
            return intermediates
        if self.conv_head is not None:
            x = self.bn2(self.conv_head(x))
        return x, intermediates

    def prune_intermediate_layers(self, indices=1, prune_norm: bool = False,
                                  prune_head: bool = True):
        take_indices, max_index = feature_take_indices(len(self.blocks), indices)
        self.blocks = self.blocks[:max_index + 1]
        if prune_head:
            self.reset_classifier(0, '')
        return take_indices


def _create_effnet(variant, pretrained=False, **kwargs):
    """The common builder: the TF-origin BatchNorm overrides (``bn_eps``,
    ``bn_momentum``, ``bn_tf``) go into the norm layer."""
    kwargs.pop('pruned', None)  # pruned checkpoints need a hub (ROADMAP A.5.1)
    bn_args = resolve_bn_args(kwargs)
    if bn_args:
        kwargs['norm_layer'] = partial(BatchNormAct2d, **bn_args)
    n_stacks = len(kwargs.get('block_args', ()))
    # a 7-stack net exposes its 5 stride levels, a shorter one every stack
    out_indices = (1, 2, 3, 4, 5) if n_stacks == 7 else tuple(range(n_stacks))
    return build_model_with_cfg(EfficientNet, variant, pretrained,
                                feature_cfg=dict(out_indices=out_indices), **kwargs)


def _gen_efficientnet(variant, channel_multiplier=1.0, depth_multiplier=1.0, channel_divisor=8, group_size=None, pretrained=False, **kwargs):
    """EfficientNet B0-B8/L2 generator."""
    arch_def = [
        ['ds_r1_k3_s1_e1_c16_se0.25'],
        ['ir_r2_k3_s2_e6_c24_se0.25'],
        ['ir_r2_k5_s2_e6_c40_se0.25'],
        ['ir_r3_k3_s2_e6_c80_se0.25'],
        ['ir_r3_k5_s1_e6_c112_se0.25'],
        ['ir_r4_k5_s2_e6_c192_se0.25'],
        ['ir_r1_k3_s1_e6_c320_se0.25'],
    ]
    round_chs_fn = partial(round_channels, multiplier=channel_multiplier, divisor=channel_divisor)
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier, group_size=group_size),
        num_features=round_chs_fn(1280),
        stem_size=32,
        round_chs_fn=round_chs_fn,
        act_layer=resolve_act_layer(kwargs, 'silu'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_efficientnet_edge(variant, channel_multiplier=1.0, depth_multiplier=1.0, pretrained=False, **kwargs):
    """EfficientNet-EdgeTPU es/em/el."""
    arch_def = [
        ['er_r1_k3_s1_e4_c24_fc24_noskip'],
        ['er_r2_k3_s2_e8_c32'],
        ['er_r4_k3_s2_e8_c48'],
        ['ir_r5_k5_s2_e8_c96'],
        ['ir_r4_k5_s1_e8_c144'],
        ['ir_r2_k5_s2_e8_c192'],
    ]
    round_chs_fn = partial(round_channels, multiplier=channel_multiplier)
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier),
        num_features=round_chs_fn(1280),
        stem_size=32,
        round_chs_fn=round_chs_fn,
        act_layer=resolve_act_layer(kwargs, 'relu'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_efficientnet_lite(variant, channel_multiplier=1.0, depth_multiplier=1.0, pretrained=False, **kwargs):
    """EfficientNet-Lite."""
    arch_def = [
        ['ds_r1_k3_s1_e1_c16'],
        ['ir_r2_k3_s2_e6_c24'],
        ['ir_r2_k5_s2_e6_c40'],
        ['ir_r3_k3_s2_e6_c80'],
        ['ir_r3_k5_s1_e6_c112'],
        ['ir_r4_k5_s2_e6_c192'],
        ['ir_r1_k3_s1_e6_c320'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier, fix_first_last=True),
        num_features=1280,
        stem_size=32,
        fix_stem=True,
        round_chs_fn=partial(round_channels, multiplier=channel_multiplier),
        act_layer=resolve_act_layer(kwargs, 'relu6'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_efficientnetv2_base(variant, channel_multiplier=1.0, depth_multiplier=1.0, pretrained=False, **kwargs):
    """EfficientNet-V2 base/b0-b3."""
    arch_def = [
        ['cn_r1_k3_s1_e1_c16_skip'],
        ['er_r2_k3_s2_e4_c32'],
        ['er_r2_k3_s2_e4_c48'],
        ['ir_r3_k3_s2_e4_c96_se0.25'],
        ['ir_r5_k3_s1_e6_c112_se0.25'],
        ['ir_r8_k3_s2_e6_c192_se0.25'],
    ]
    round_chs_fn = partial(round_channels, multiplier=channel_multiplier, round_limit=0.0)
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier),
        num_features=round_chs_fn(1280),
        stem_size=32,
        round_chs_fn=round_chs_fn,
        act_layer=resolve_act_layer(kwargs, 'silu'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_efficientnetv2_s(variant, channel_multiplier=1.0, depth_multiplier=1.0, rw=False, pretrained=False, **kwargs):
    """EfficientNet-V2 small."""
    arch_def = [
        ['cn_r2_k3_s1_e1_c24_skip'],
        ['er_r4_k3_s2_e4_c48'],
        ['er_r4_k3_s2_e4_c64'],
        ['ir_r6_k3_s2_e4_c128_se0.25'],
        ['ir_r9_k3_s1_e6_c160_se0.25'],
        ['ir_r15_k3_s2_e6_c256_se0.25'],
    ]
    num_features = 1280
    if rw:
        # timm's pre-release v2 small variant
        arch_def[0] = ['er_r2_k3_s1_e1_c24']
        arch_def[-1] = ['ir_r15_k3_s2_e6_c272_se0.25']
        num_features = 1792
    round_chs_fn = partial(round_channels, multiplier=channel_multiplier)
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier),
        num_features=round_chs_fn(num_features),
        stem_size=24,
        round_chs_fn=round_chs_fn,
        act_layer=resolve_act_layer(kwargs, 'silu'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_efficientnetv2_m(variant, pretrained=False, **kwargs):
    """EfficientNet-V2 medium."""
    arch_def = [
        ['cn_r3_k3_s1_e1_c24_skip'],
        ['er_r5_k3_s2_e4_c48'],
        ['er_r5_k3_s2_e4_c80'],
        ['ir_r7_k3_s2_e4_c160_se0.25'],
        ['ir_r14_k3_s1_e6_c176_se0.25'],
        ['ir_r18_k3_s2_e6_c304_se0.25'],
        ['ir_r5_k3_s1_e6_c512_se0.25'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def),
        num_features=1280,
        stem_size=24,
        act_layer=resolve_act_layer(kwargs, 'silu'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_efficientnetv2_l(variant, pretrained=False, **kwargs):
    """EfficientNet-V2 large."""
    arch_def = [
        ['cn_r4_k3_s1_e1_c32_skip'],
        ['er_r7_k3_s2_e4_c64'],
        ['er_r7_k3_s2_e4_c96'],
        ['ir_r10_k3_s2_e4_c192_se0.25'],
        ['ir_r19_k3_s1_e6_c224_se0.25'],
        ['ir_r25_k3_s2_e6_c384_se0.25'],
        ['ir_r7_k3_s1_e6_c640_se0.25'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def),
        num_features=1280,
        stem_size=32,
        act_layer=resolve_act_layer(kwargs, 'silu'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_efficientnetv2_xl(variant, pretrained=False, **kwargs):
    """EfficientNet-V2 xlarge."""
    arch_def = [
        ['cn_r4_k3_s1_e1_c32_skip'],
        ['er_r8_k3_s2_e4_c64'],
        ['er_r8_k3_s2_e4_c96'],
        ['ir_r16_k3_s2_e4_c192_se0.25'],
        ['ir_r24_k3_s1_e6_c256_se0.25'],
        ['ir_r32_k3_s2_e6_c512_se0.25'],
        ['ir_r8_k3_s1_e6_c640_se0.25'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def),
        num_features=1280,
        stem_size=32,
        act_layer=resolve_act_layer(kwargs, 'silu'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_mnasnet_a1(variant, channel_multiplier=1.0, pretrained=False, **kwargs):
    """MNASNet-A1 (w/ SE) a.k.a. semnasnet."""
    arch_def = [
        ['ds_r1_k3_s1_e1_c16_noskip'],
        ['ir_r2_k3_s2_e6_c24'],
        ['ir_r3_k5_s2_e3_c40_se0.25'],
        ['ir_r4_k3_s2_e6_c80'],
        ['ir_r2_k3_s1_e6_c112_se0.25'],
        ['ir_r3_k5_s2_e6_c160_se0.25'],
        ['ir_r1_k3_s1_e6_c320'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def),
        stem_size=32,
        round_chs_fn=partial(round_channels, multiplier=channel_multiplier),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_mnasnet_b1(variant, channel_multiplier=1.0, pretrained=False, **kwargs):
    """MNASNet-B1."""
    arch_def = [
        ['ds_r1_k3_s1_c16_noskip'],
        ['ir_r3_k3_s2_e3_c24'],
        ['ir_r3_k5_s2_e3_c40'],
        ['ir_r3_k5_s2_e6_c80'],
        ['ir_r2_k3_s1_e6_c96'],
        ['ir_r4_k5_s2_e6_c192'],
        ['ir_r1_k3_s1_e6_c320_noskip'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def),
        stem_size=32,
        round_chs_fn=partial(round_channels, multiplier=channel_multiplier),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_mnasnet_small(variant, channel_multiplier=1.0, pretrained=False, **kwargs):
    """MNASNet small."""
    arch_def = [
        ['ds_r1_k3_s1_c8'],
        ['ir_r1_k3_s2_e3_c16'],
        ['ir_r2_k3_s2_e6_c16'],
        ['ir_r4_k5_s2_e6_c32_se0.25'],
        ['ir_r3_k3_s1_e6_c32_se0.25'],
        ['ir_r3_k5_s2_e6_c88_se0.25'],
        ['ir_r1_k3_s1_e6_c144'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def),
        stem_size=8,
        round_chs_fn=partial(round_channels, multiplier=channel_multiplier),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_mobilenet_v2(variant, channel_multiplier=1.0, depth_multiplier=1.0, fix_stem_head=False,
                      pretrained=False, **kwargs):
    """MobileNet-V2."""
    arch_def = [
        ['ds_r1_k3_s1_c16'],
        ['ir_r2_k3_s2_e6_c24'],
        ['ir_r3_k3_s2_e6_c32'],
        ['ir_r4_k3_s2_e6_c64'],
        ['ir_r3_k3_s1_e6_c96'],
        ['ir_r3_k3_s2_e6_c160'],
        ['ir_r1_k3_s1_e6_c320'],
    ]
    round_chs_fn = partial(round_channels, multiplier=channel_multiplier)
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier=depth_multiplier, fix_first_last=fix_stem_head),
        num_features=1280 if fix_stem_head else max(1280, round_chs_fn(1280)),
        stem_size=32,
        fix_stem=fix_stem_head,
        round_chs_fn=round_chs_fn,
        act_layer=resolve_act_layer(kwargs, 'relu6'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_fbnetc(variant, channel_multiplier=1.0, pretrained=False, **kwargs):
    """FBNet-C."""
    arch_def = [
        ['ir_r1_k3_s1_e1_c16'],
        ['ir_r1_k3_s2_e6_c24', 'ir_r2_k3_s1_e1_c24'],
        ['ir_r1_k5_s2_e6_c32', 'ir_r1_k5_s1_e3_c32', 'ir_r1_k5_s1_e6_c32', 'ir_r1_k3_s1_e6_c32'],
        ['ir_r1_k5_s2_e6_c64', 'ir_r1_k5_s1_e3_c64', 'ir_r2_k5_s1_e6_c64'],
        ['ir_r3_k5_s1_e6_c112', 'ir_r1_k5_s1_e3_c112'],
        ['ir_r4_k5_s2_e6_c184'],
        ['ir_r1_k3_s1_e6_c352'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def),
        stem_size=16,
        num_features=1984,
        round_chs_fn=partial(round_channels, multiplier=channel_multiplier),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_spnasnet(variant, channel_multiplier=1.0, pretrained=False, **kwargs):
    """Single-Path NAS."""
    arch_def = [
        ['ds_r1_k3_s1_c16_noskip'],
        ['ir_r3_k3_s2_e3_c24'],
        ['ir_r1_k5_s2_e6_c40', 'ir_r3_k3_s1_e3_c40'],
        ['ir_r1_k5_s2_e6_c80', 'ir_r3_k3_s1_e3_c80'],
        ['ir_r1_k5_s1_e6_c96', 'ir_r3_k5_s1_e3_c96'],
        ['ir_r4_k5_s2_e6_c192'],
        ['ir_r1_k3_s1_e6_c320_noskip'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def),
        stem_size=32,
        round_chs_fn=partial(round_channels, multiplier=channel_multiplier),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_tinynet(variant, model_width=1.0, depth_multiplier=1.0, pretrained=False, **kwargs):
    """TinyNet."""
    arch_def = [
        ['ds_r1_k3_s1_e1_c16_se0.25'], ['ir_r2_k3_s2_e6_c24_se0.25'],
        ['ir_r2_k5_s2_e6_c40_se0.25'], ['ir_r3_k3_s2_e6_c80_se0.25'],
        ['ir_r3_k5_s1_e6_c112_se0.25'], ['ir_r4_k5_s2_e6_c192_se0.25'],
        ['ir_r1_k3_s1_e6_c320_se0.25'],
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier, depth_trunc='round'),
        num_features=max(1280, round_channels(1280, model_width, 8, None)),
        stem_size=32,
        fix_stem=True,
        round_chs_fn=partial(round_channels, multiplier=model_width),
        act_layer=resolve_act_layer(kwargs, 'swish'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


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
        'first_conv': 'conv_stem',
        'classifier': 'classifier',
        **kwargs,
    }


# (channel_multiplier, depth_multiplier, train res, crop_pct) per B-variant —
# the compound-scaling table of timm
_B_PARAMS = {
    'b0': (1.0, 1.0, 224, 0.875), 'b1': (1.0, 1.1, 240, 0.882),
    'b2': (1.1, 1.2, 260, 0.89), 'b3': (1.2, 1.4, 300, 0.904),
    'b4': (1.4, 1.8, 380, 0.922), 'b5': (1.6, 2.2, 456, 0.934),
    'b6': (1.8, 2.6, 528, 0.942), 'b7': (2.0, 3.1, 600, 0.949),
    'b8': (2.2, 3.6, 672, 0.954), 'l2': (4.3, 5.3, 800, 0.961),
}
_LITE_PARAMS = {
    'lite0': (1.0, 1.0, 224, 0.875), 'lite1': (1.0, 1.1, 240, 0.882),
    'lite2': (1.1, 1.2, 260, 0.89), 'lite3': (1.2, 1.4, 280, 0.904),
    'lite4': (1.4, 1.8, 300, 0.92),
}
_TF_STATS = dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))


def _res_cfg(res, crop, **kwargs):
    return _cfg(input_size=(3, res, res), pool_size=(res // 32, res // 32), crop_pct=crop, **kwargs)


default_cfgs = generate_default_cfgs({
    'efficientnet_b0.ra_in1k': _cfg(hf_hub_id='timm/'),
    'efficientnet_b1.ft_in1k': _res_cfg(240, 0.882, hf_hub_id='timm/'),
    'efficientnet_b2.ra_in1k': _res_cfg(256, 0.89, hf_hub_id='timm/'),
    'efficientnet_b3.ra2_in1k': _res_cfg(288, 0.904, hf_hub_id='timm/'),
    'efficientnet_b4.ra2_in1k': _res_cfg(320, 0.922, hf_hub_id='timm/'),
    'efficientnet_b5.sw_in12k_ft_in1k': _res_cfg(448, 1.0, hf_hub_id='timm/', crop_mode='squash'),
    'efficientnet_b6.untrained': _res_cfg(528, 0.942),
    'efficientnet_b7.untrained': _res_cfg(600, 0.949),
    'efficientnet_b8.untrained': _res_cfg(672, 0.954),
    'efficientnet_l2.untrained': _res_cfg(800, 0.961),
    **{f'tf_efficientnet_{v}.in1k': _res_cfg(r, c, hf_hub_id='timm/', **_TF_STATS)
       for v, (_, _, r, c) in _B_PARAMS.items() if v in ('b0', 'b1', 'b2', 'b3', 'b4', 'b5')},
    'tf_efficientnet_b6.aa_in1k': _res_cfg(528, 0.942, hf_hub_id='timm/', **_TF_STATS),
    'tf_efficientnet_b7.ra_in1k': _res_cfg(600, 0.949, hf_hub_id='timm/', **_TF_STATS),
    'tf_efficientnet_b8.ra_in1k': _res_cfg(672, 0.954, hf_hub_id='timm/', **_TF_STATS),
    'tf_efficientnet_l2.ns_jft_in1k': _res_cfg(800, 0.96, hf_hub_id='timm/', **_TF_STATS),

    'efficientnet_es.ra_in1k': _cfg(hf_hub_id='timm/'),
    'efficientnet_em.ra2_in1k': _res_cfg(240, 0.882, hf_hub_id='timm/'),
    'efficientnet_el.ra_in1k': _res_cfg(300, 0.904, hf_hub_id='timm/'),
    'tf_efficientnet_es.in1k': _cfg(hf_hub_id='timm/', **_TF_STATS),
    'tf_efficientnet_em.in1k': _res_cfg(240, 0.882, hf_hub_id='timm/', **_TF_STATS),
    'tf_efficientnet_el.in1k': _res_cfg(300, 0.904, hf_hub_id='timm/', **_TF_STATS),

    'efficientnet_lite0.ra_in1k': _cfg(hf_hub_id='timm/'),
    'efficientnet_lite1.untrained': _res_cfg(240, 0.882),
    'efficientnet_lite2.untrained': _res_cfg(260, 0.89),
    'efficientnet_lite3.untrained': _res_cfg(280, 0.904),
    'efficientnet_lite4.untrained': _res_cfg(300, 0.92),
    **{f'tf_efficientnet_{v}.in1k': _res_cfg(r, c, hf_hub_id='timm/', **_TF_STATS)
       for v, (_, _, r, c) in _LITE_PARAMS.items()},

    'efficientnetv2_rw_t.ra2_in1k': _res_cfg(224, 1.0, hf_hub_id='timm/', test_input_size=(3, 288, 288)),
    'efficientnetv2_rw_s.ra2_in1k': _res_cfg(288, 1.0, hf_hub_id='timm/', test_input_size=(3, 384, 384)),
    'efficientnetv2_rw_m.agc_in1k': _res_cfg(320, 1.0, hf_hub_id='timm/', test_input_size=(3, 416, 416)),
    'efficientnetv2_s.in1k': _res_cfg(300, 1.0, hf_hub_id='timm/', test_input_size=(3, 384, 384)),
    'efficientnetv2_m.untrained': _res_cfg(320, 1.0, test_input_size=(3, 416, 416)),
    'efficientnetv2_l.untrained': _res_cfg(384, 1.0, test_input_size=(3, 480, 480)),
    'efficientnetv2_xl.untrained': _res_cfg(384, 1.0, test_input_size=(3, 512, 512)),
    'efficientnetv2_b0.untrained': _cfg(),
    'efficientnetv2_b1.untrained': _res_cfg(240, 0.882),
    'efficientnetv2_b2.untrained': _res_cfg(260, 0.89),
    'efficientnetv2_b3.untrained': _res_cfg(288, 0.904),
    'tf_efficientnetv2_s.in1k': _res_cfg(300, 1.0, hf_hub_id='timm/', test_input_size=(3, 384, 384), **_TF_STATS),
    'tf_efficientnetv2_m.in21k_ft_in1k': _res_cfg(
        384, 1.0, hf_hub_id='timm/', test_input_size=(3, 480, 480), **_TF_STATS),
    'tf_efficientnetv2_l.in21k_ft_in1k': _res_cfg(
        384, 1.0, hf_hub_id='timm/', test_input_size=(3, 480, 480), **_TF_STATS),
    'tf_efficientnetv2_xl.in21k_ft_in1k': _res_cfg(
        384, 1.0, hf_hub_id='timm/', test_input_size=(3, 512, 512), **_TF_STATS),
    'tf_efficientnetv2_b0.in1k': _res_cfg(192, 0.875, hf_hub_id='timm/', test_input_size=(3, 224, 224), **_TF_STATS),
    'tf_efficientnetv2_b1.in1k': _res_cfg(192, 0.882, hf_hub_id='timm/', test_input_size=(3, 240, 240), **_TF_STATS),
    'tf_efficientnetv2_b2.in1k': _res_cfg(208, 0.89, hf_hub_id='timm/', test_input_size=(3, 260, 260), **_TF_STATS),
    'tf_efficientnetv2_b3.in1k': _res_cfg(240, 0.904, hf_hub_id='timm/', test_input_size=(3, 300, 300), **_TF_STATS),

    'mnasnet_050.untrained': _cfg(),
    'mnasnet_075.untrained': _cfg(),
    'mnasnet_100.rmsp_in1k': _cfg(hf_hub_id='timm/'),
    'mnasnet_140.untrained': _cfg(),
    'semnasnet_050.untrained': _cfg(),
    'semnasnet_075.rmsp_in1k': _cfg(hf_hub_id='timm/'),
    'semnasnet_100.rmsp_in1k': _cfg(hf_hub_id='timm/'),
    'semnasnet_140.untrained': _cfg(),
    'mnasnet_small.lamb_in1k': _cfg(hf_hub_id='timm/'),
    'mobilenetv2_035.untrained': _cfg(),
    'mobilenetv2_050.lamb_in1k': _cfg(hf_hub_id='timm/'),
    'mobilenetv2_075.untrained': _cfg(),
    'mobilenetv2_100.ra_in1k': _cfg(hf_hub_id='timm/'),
    'mobilenetv2_110d.ra_in1k': _cfg(hf_hub_id='timm/'),
    'mobilenetv2_120d.ra_in1k': _cfg(hf_hub_id='timm/'),
    'mobilenetv2_140.ra_in1k': _cfg(hf_hub_id='timm/'),
    'fbnetc_100.rmsp_in1k': _cfg(hf_hub_id='timm/'),
    'spnasnet_100.rmsp_in1k': _cfg(hf_hub_id='timm/'),
    'tinynet_a.in1k': _res_cfg(192, 0.875, hf_hub_id='timm/'),
    'tinynet_b.in1k': _res_cfg(188, 0.875, hf_hub_id='timm/'),
    'tinynet_c.in1k': _res_cfg(184, 0.875, hf_hub_id='timm/'),
    'tinynet_d.in1k': _res_cfg(152, 0.875, hf_hub_id='timm/'),
    'tinynet_e.in1k': _res_cfg(106, 0.875, hf_hub_id='timm/'),
    'test_efficientnet.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), crop_pct=0.95),
    'mobilenetv1_100.ra4_e3600_r224_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), test_input_size=(3, 256, 256), test_crop_pct=0.95, first_conv='conv_stem', classifier='classifier'),
    'mobilenetv1_100h.ra4_e3600_r224_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), test_input_size=(3, 256, 256), test_crop_pct=0.95, first_conv='conv_stem', classifier='classifier'),
    'mobilenetv1_125.ra4_e3600_r224_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.9, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), test_input_size=(3, 256, 256), test_crop_pct=1.0, first_conv='conv_stem', classifier='classifier'),
    'efficientnet_b0_gn.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_b0_g8_gn.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_b0_g16_evos.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_b3_gn.untrained': _cfg(input_size=(3, 288, 288), pool_size=(9, 9), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 320, 320), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_b3_g8_gn.untrained': _cfg(input_size=(3, 288, 288), pool_size=(9, 9), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 320, 320), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_blur_b0.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_es_pruned.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_el_pruned.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 300, 300), pool_size=(10, 10), crop_pct=0.904, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_cc_b0_4e.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_cc_b0_8e.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_cc_b1_8e.untrained': _cfg(input_size=(3, 240, 240), pool_size=(8, 8), crop_pct=0.882, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'gc_efficientnetv2_rw_t.agc_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), first_conv='conv_stem', classifier='classifier'),
    'tf_efficientnet_cc_b0_4e.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), first_conv='conv_stem', classifier='classifier'),
    'tf_efficientnet_cc_b0_8e.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), first_conv='conv_stem', classifier='classifier'),
    'tf_efficientnet_cc_b1_8e.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), pool_size=(8, 8), crop_pct=0.882, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_x_b3.untrained': _cfg(input_size=(3, 288, 288), pool_size=(9, 9), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_x_b5.sw_r448_e450_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 448, 448), pool_size=(14, 14), crop_pct=1.0, crop_mode='squash', mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 576, 576), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_h_b5.sw_r448_e450_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 448, 448), pool_size=(14, 14), crop_pct=1.0, crop_mode='squash', mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 576, 576), first_conv='conv_stem', classifier='classifier'),
    'mixnet_s.ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'mixnet_m.ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'mixnet_l.ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'mixnet_xl.ra_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'mixnet_xxl.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'tf_mixnet_s.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'tf_mixnet_m.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'tf_mixnet_l.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'mobilenet_edgetpu_100.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.9, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'mobilenet_edgetpu_v2_xs.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.9, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'mobilenet_edgetpu_v2_s.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.9, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'mobilenet_edgetpu_v2_m.ra4_e3600_r224_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.9, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), test_input_size=(3, 256, 256), test_crop_pct=0.95, first_conv='conv_stem', classifier='classifier'),
    'mobilenet_edgetpu_v2_l.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.9, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'test_efficientnet_gn.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), pool_size=(5, 5), crop_pct=0.95, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), first_conv='conv_stem', classifier='classifier'),
    'test_efficientnet_ln.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), pool_size=(5, 5), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv_stem', classifier='classifier'),
    'test_efficientnet_evos.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), pool_size=(5, 5), crop_pct=0.95, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), first_conv='conv_stem', classifier='classifier'),
    'efficientnet_b1_pruned.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 240, 240), pool_size=(8, 8), crop_pct=0.882, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'efficientnet_b2_pruned.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 260, 260), pool_size=(9, 9), crop_pct=0.89, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
    'efficientnet_b3_pruned.in1k': _cfg(hf_hub_id='timm/', input_size=(3, 300, 300), pool_size=(10, 10), crop_pct=0.904, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
})


def _register_effnet_b(name: str):
    cm, dm, _, _ = _B_PARAMS[name]

    def base(pretrained=False, **kwargs):
        return _gen_efficientnet(f'efficientnet_{name}', cm, dm, pretrained=pretrained, **kwargs)

    def tf(pretrained=False, **kwargs):
        kwargs.setdefault('bn_eps', 1e-3)
        kwargs.setdefault('pad_type', 'same')
        return _gen_efficientnet(f'tf_efficientnet_{name}', cm, dm, pretrained=pretrained, **kwargs)

    base.__name__ = f'efficientnet_{name}'
    base.__doc__ = f'EfficientNet-{name.upper()}'
    tf.__name__ = f'tf_efficientnet_{name}'
    tf.__doc__ = f'EfficientNet-{name.upper()}, TF-origin weights (SAME padding, bn_eps=1e-3)'
    register_model(base)
    register_model(tf)


for _b in _B_PARAMS:
    _register_effnet_b(_b)


def _register_effnet_lite(name: str):
    cm, dm, _, _ = _LITE_PARAMS[name]

    def base(pretrained=False, **kwargs):
        return _gen_efficientnet_lite(f'efficientnet_{name}', cm, dm, pretrained, **kwargs)

    def tf(pretrained=False, **kwargs):
        kwargs.setdefault('bn_eps', 1e-3)
        kwargs.setdefault('pad_type', 'same')
        return _gen_efficientnet_lite(f'tf_efficientnet_{name}', cm, dm, pretrained, **kwargs)

    base.__name__ = f'efficientnet_{name}'
    base.__doc__ = f'EfficientNet-{name}'
    tf.__name__ = f'tf_efficientnet_{name}'
    tf.__doc__ = f'EfficientNet-{name}, TF-origin weights (SAME padding, bn_eps=1e-3)'
    register_model(base)
    register_model(tf)


for _l in _LITE_PARAMS:
    _register_effnet_lite(_l)


@register_model
def efficientnet_es(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnet_edge('efficientnet_es', 1.0, 1.0, pretrained, **kwargs)


@register_model
def efficientnet_em(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnet_edge('efficientnet_em', 1.0, 1.1, pretrained, **kwargs)


@register_model
def efficientnet_el(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnet_edge('efficientnet_el', 1.2, 1.4, pretrained, **kwargs)


@register_model
def tf_efficientnet_es(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnet_edge('tf_efficientnet_es', 1.0, 1.0, pretrained, **kwargs)


@register_model
def tf_efficientnet_em(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnet_edge('tf_efficientnet_em', 1.0, 1.1, pretrained, **kwargs)


@register_model
def tf_efficientnet_el(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnet_edge('tf_efficientnet_el', 1.2, 1.4, pretrained, **kwargs)


@register_model
def efficientnetv2_rw_t(pretrained=False, **kwargs) -> EfficientNet:
    """V2 Tiny: a 0.8/0.9-scaled v2-S."""
    return _gen_efficientnetv2_s(
        'efficientnetv2_rw_t', channel_multiplier=0.8, depth_multiplier=0.9, rw=False,
        pretrained=pretrained, **kwargs)


@register_model
def efficientnetv2_rw_s(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_s('efficientnetv2_rw_s', rw=True, pretrained=pretrained, **kwargs)


@register_model
def efficientnetv2_rw_m(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_s(
        'efficientnetv2_rw_m', channel_multiplier=1.2, depth_multiplier=(1.2,) * 4 + (1.6,) * 2,
        rw=True, pretrained=pretrained, **kwargs)


@register_model
def efficientnetv2_s(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_s('efficientnetv2_s', pretrained=pretrained, **kwargs)


@register_model
def efficientnetv2_m(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_m('efficientnetv2_m', pretrained=pretrained, **kwargs)


@register_model
def efficientnetv2_l(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_l('efficientnetv2_l', pretrained=pretrained, **kwargs)


@register_model
def efficientnetv2_xl(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_xl('efficientnetv2_xl', pretrained=pretrained, **kwargs)


@register_model
def efficientnetv2_b0(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_base('efficientnetv2_b0', 1.0, 1.0, pretrained, **kwargs)


@register_model
def efficientnetv2_b1(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_base('efficientnetv2_b1', 1.0, 1.1, pretrained, **kwargs)


@register_model
def efficientnetv2_b2(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_base('efficientnetv2_b2', 1.1, 1.2, pretrained, **kwargs)


@register_model
def efficientnetv2_b3(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_efficientnetv2_base('efficientnetv2_b3', 1.2, 1.4, pretrained, **kwargs)


@register_model
def tf_efficientnetv2_s(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnetv2_s('tf_efficientnetv2_s', pretrained=pretrained, **kwargs)


@register_model
def tf_efficientnetv2_m(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnetv2_m('tf_efficientnetv2_m', pretrained=pretrained, **kwargs)


@register_model
def tf_efficientnetv2_l(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnetv2_l('tf_efficientnetv2_l', pretrained=pretrained, **kwargs)


@register_model
def tf_efficientnetv2_xl(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnetv2_xl('tf_efficientnetv2_xl', pretrained=pretrained, **kwargs)


@register_model
def tf_efficientnetv2_b0(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnetv2_base('tf_efficientnetv2_b0', 1.0, 1.0, pretrained, **kwargs)


@register_model
def tf_efficientnetv2_b1(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnetv2_base('tf_efficientnetv2_b1', 1.0, 1.1, pretrained, **kwargs)


@register_model
def tf_efficientnetv2_b2(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnetv2_base('tf_efficientnetv2_b2', 1.1, 1.2, pretrained, **kwargs)


@register_model
def tf_efficientnetv2_b3(pretrained=False, **kwargs) -> EfficientNet:
    kwargs.setdefault('bn_eps', 1e-3)
    kwargs.setdefault('pad_type', 'same')
    return _gen_efficientnetv2_base('tf_efficientnetv2_b3', 1.2, 1.4, pretrained, **kwargs)


@register_model
def mnasnet_050(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mnasnet_b1('mnasnet_050', 0.5, pretrained=pretrained, **kwargs)


@register_model
def mnasnet_075(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mnasnet_b1('mnasnet_075', 0.75, pretrained=pretrained, **kwargs)


@register_model
def mnasnet_100(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mnasnet_b1('mnasnet_100', 1.0, pretrained=pretrained, **kwargs)


@register_model
def mnasnet_140(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mnasnet_b1('mnasnet_140', 1.4, pretrained=pretrained, **kwargs)


@register_model
def semnasnet_050(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mnasnet_a1('semnasnet_050', 0.5, pretrained=pretrained, **kwargs)


@register_model
def semnasnet_075(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mnasnet_a1('semnasnet_075', 0.75, pretrained=pretrained, **kwargs)


@register_model
def semnasnet_100(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mnasnet_a1('semnasnet_100', 1.0, pretrained=pretrained, **kwargs)


@register_model
def semnasnet_140(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mnasnet_a1('semnasnet_140', 1.4, pretrained=pretrained, **kwargs)


@register_model
def mnasnet_small(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mnasnet_small('mnasnet_small', 1.0, pretrained=pretrained, **kwargs)


@register_model
def mobilenetv2_035(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mobilenet_v2('mobilenetv2_035', 0.35, pretrained=pretrained, **kwargs)


@register_model
def mobilenetv2_050(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mobilenet_v2('mobilenetv2_050', 0.5, pretrained=pretrained, **kwargs)


@register_model
def mobilenetv2_075(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mobilenet_v2('mobilenetv2_075', 0.75, pretrained=pretrained, **kwargs)


@register_model
def mobilenetv2_100(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mobilenet_v2('mobilenetv2_100', 1.0, pretrained=pretrained, **kwargs)


@register_model
def mobilenetv2_110d(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mobilenet_v2(
        'mobilenetv2_110d', 1.1, depth_multiplier=1.2, fix_stem_head=True, pretrained=pretrained, **kwargs)


@register_model
def mobilenetv2_120d(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mobilenet_v2(
        'mobilenetv2_120d', 1.2, depth_multiplier=1.4, fix_stem_head=True, pretrained=pretrained, **kwargs)


@register_model
def mobilenetv2_140(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_mobilenet_v2('mobilenetv2_140', 1.4, pretrained=pretrained, **kwargs)


@register_model
def fbnetc_100(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_fbnetc('fbnetc_100', 1.0, pretrained=pretrained, **kwargs)


@register_model
def spnasnet_100(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_spnasnet('spnasnet_100', 1.0, pretrained=pretrained, **kwargs)


@register_model
def tinynet_a(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_tinynet('tinynet_a', 1.0, 1.2, pretrained=pretrained, **kwargs)


@register_model
def tinynet_b(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_tinynet('tinynet_b', 0.75, 1.1, pretrained=pretrained, **kwargs)


@register_model
def tinynet_c(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_tinynet('tinynet_c', 0.54, 0.85, pretrained=pretrained, **kwargs)


@register_model
def tinynet_d(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_tinynet('tinynet_d', 0.54, 0.695, pretrained=pretrained, **kwargs)


@register_model
def tinynet_e(pretrained=False, **kwargs) -> EfficientNet:
    return _gen_tinynet('tinynet_e', 0.51, 0.6, pretrained=pretrained, **kwargs)


def _gen_test_efficientnet(variant, channel_multiplier=1.0, depth_multiplier=1.0, pretrained=False, **kwargs):
    """Minimal test EfficientNet generator."""
    arch_def = [
        ['cn_r1_k3_s1_e1_c16_skip'],
        ['er_r1_k3_s2_e4_c24'],
        ['er_r1_k3_s2_e4_c32'],
        ['ir_r1_k3_s2_e4_c48_se0.25'],
        ['ir_r1_k3_s2_e4_c64_se0.25'],
    ]
    round_chs_fn = partial(round_channels, multiplier=channel_multiplier, round_limit=0.)
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier),
        num_features=round_chs_fn(256),
        stem_size=24,
        round_chs_fn=round_chs_fn,
        act_layer=resolve_act_layer(kwargs, 'silu'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_mobilenet_v1(
        variant, channel_multiplier=1.0, depth_multiplier=1.0,
        group_size=None, fix_stem_head=False, head_conv=False, pretrained=False, **kwargs):
    """MobileNet-V1."""
    arch_def = [
        ['dsa_r1_k3_s1_c64'],
        ['dsa_r2_k3_s2_c128'],
        ['dsa_r2_k3_s2_c256'],
        ['dsa_r6_k3_s2_c512'],
        ['dsa_r2_k3_s2_c1024'],
    ]
    round_chs_fn = partial(round_channels, multiplier=channel_multiplier)
    head_features = (1024 if fix_stem_head else max(1024, round_chs_fn(1024))) if head_conv else 0
    model_kwargs = dict(
        block_args=decode_arch_def(
            arch_def, depth_multiplier=depth_multiplier, fix_first_last=fix_stem_head,
            group_size=group_size),
        num_features=head_features,
        stem_size=32,
        fix_stem=fix_stem_head,
        round_chs_fn=round_chs_fn,
        act_layer=resolve_act_layer(kwargs, 'relu6'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_efficientnet_condconv(
        variant, channel_multiplier=1.0, depth_multiplier=1.0, experts_multiplier=1,
        pretrained=False, **kwargs):
    """EfficientNet-CondConv."""
    arch_def = [
        ['ds_r1_k3_s1_e1_c16_se0.25'],
        ['ir_r2_k3_s2_e6_c24_se0.25'],
        ['ir_r2_k5_s2_e6_c40_se0.25'],
        ['ir_r3_k3_s2_e6_c80_se0.25'],
        ['ir_r3_k5_s1_e6_c112_se0.25_cc4'],
        ['ir_r4_k5_s2_e6_c192_se0.25_cc4'],
        ['ir_r1_k3_s1_e6_c320_se0.25_cc4'],
    ]
    round_chs_fn = partial(round_channels, multiplier=channel_multiplier)
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier, experts_multiplier=experts_multiplier),
        num_features=round_chs_fn(1280),
        stem_size=32,
        round_chs_fn=round_chs_fn,
        act_layer=resolve_act_layer(kwargs, 'swish'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_efficientnet_x(
        variant, channel_multiplier=1.0, depth_multiplier=1.0, channel_divisor=8,
        group_size=None, version=1, pretrained=False, **kwargs):
    """EfficientNet-X: edge-residual
    early stages w/ relu, depthwise-separable-style later stages w/ silu."""
    if version == 1:
        arch_def = [
            ['ds_r1_k3_s1_e1_c16_se0.25_d1'],
            ['er_r2_k3_s2_e6_c24_se0.25_nre'],
            ['er_r2_k5_s2_e6_c40_se0.25_nre'],
            ['ir_r3_k3_s2_e6_c80_se0.25'],
            ['ir_r3_k5_s1_e6_c112_se0.25'],
            ['ir_r4_k5_s2_e6_c192_se0.25'],
            ['ir_r1_k3_s1_e6_c320_se0.25'],
        ]
    else:
        arch_def = [
            ['ds_r1_k3_s1_e1_c16_se0.25_d1'],
            ['er_r2_k3_s2_e4_c24_se0.25_nre'],
            ['er_r2_k5_s2_e4_c40_se0.25_nre'],
            ['ir_r3_k3_s2_e4_c80_se0.25'],
            ['ir_r3_k5_s1_e6_c112_se0.25'],
            ['ir_r4_k5_s2_e6_c192_se0.25'],
            ['ir_r1_k3_s1_e6_c320_se0.25'],
        ]
    round_chs_fn = partial(round_channels, multiplier=channel_multiplier, divisor=channel_divisor)
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier, group_size=group_size),
        num_features=round_chs_fn(1280),
        stem_size=32,
        round_chs_fn=round_chs_fn,
        act_layer=resolve_act_layer(kwargs, 'silu'),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_mixnet_s(variant, channel_multiplier=1.0, pretrained=False, **kwargs):
    """MixNet Small: mixed (grouped multi-size) depthwise kernels."""
    arch_def = [
        ['ds_r1_k3_s1_e1_c16'],  # relu
        ['ir_r1_k3_a1.1_p1.1_s2_e6_c24', 'ir_r1_k3_a1.1_p1.1_s1_e3_c24'],  # relu
        ['ir_r1_k3.5.7_s2_e6_c40_se0.5_nsw', 'ir_r3_k3.5_a1.1_p1.1_s1_e6_c40_se0.5_nsw'],  # swish
        ['ir_r1_k3.5.7_p1.1_s2_e6_c80_se0.25_nsw', 'ir_r2_k3.5_p1.1_s1_e6_c80_se0.25_nsw'],  # swish
        ['ir_r1_k3.5.7_a1.1_p1.1_s1_e6_c120_se0.5_nsw', 'ir_r2_k3.5.7.9_a1.1_p1.1_s1_e3_c120_se0.5_nsw'],  # swish
        ['ir_r1_k3.5.7.9.11_s2_e6_c200_se0.5_nsw', 'ir_r2_k3.5.7.9_p1.1_s1_e6_c200_se0.5_nsw'],  # swish
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def),
        num_features=1536,
        stem_size=16,
        round_chs_fn=partial(round_channels, multiplier=channel_multiplier),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_mixnet_m(variant, channel_multiplier=1.0, depth_multiplier=1.0, pretrained=False, **kwargs):
    """MixNet Medium/Large/XL."""
    arch_def = [
        ['ds_r1_k3_s1_e1_c24'],  # relu
        ['ir_r1_k3.5.7_a1.1_p1.1_s2_e6_c32', 'ir_r1_k3_a1.1_p1.1_s1_e3_c32'],  # relu
        ['ir_r1_k3.5.7.9_s2_e6_c40_se0.5_nsw', 'ir_r3_k3.5_a1.1_p1.1_s1_e6_c40_se0.5_nsw'],  # swish
        ['ir_r1_k3.5.7_s2_e6_c80_se0.25_nsw', 'ir_r3_k3.5.7.9_a1.1_p1.1_s1_e6_c80_se0.25_nsw'],  # swish
        ['ir_r1_k3_s1_e6_c120_se0.5_nsw', 'ir_r3_k3.5.7.9_a1.1_p1.1_s1_e3_c120_se0.5_nsw'],  # swish
        ['ir_r1_k3.5.7.9_s2_e6_c200_se0.5_nsw', 'ir_r3_k3.5.7.9_p1.1_s1_e6_c200_se0.5_nsw'],  # swish
    ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier, depth_trunc='round'),
        num_features=1536,
        stem_size=24,
        round_chs_fn=partial(round_channels, multiplier=channel_multiplier),
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


def _gen_mobilenet_edgetpu(variant, channel_multiplier=1.0, depth_multiplier=1.0, pretrained=False, **kwargs):
    """MobileNet-EdgeTPU v1/v2."""
    if 'edgetpu_v2' in variant:
        stem_size = 64
        stem_kernel_size = 5
        group_size = 64
        num_features = 1280
        act_layer = resolve_act_layer(kwargs, 'relu')

        def _arch_def(chs, group_size):
            return [
                [f'cn_r1_k1_s1_c{chs[0]}'],
                [f'er_r1_k3_s2_e8_c{chs[1]}', f'er_r1_k3_s1_e4_gs{group_size}_c{chs[1]}'],
                [
                    f'er_r1_k3_s2_e8_c{chs[2]}',
                    f'er_r1_k3_s1_e4_gs{group_size}_c{chs[2]}',
                    f'er_r1_k3_s1_e4_c{chs[2]}',
                    f'er_r1_k3_s1_e4_gs{group_size}_c{chs[2]}',
                ],
                [f'er_r1_k3_s2_e8_c{chs[3]}', f'ir_r3_k3_s1_e4_c{chs[3]}'],
                [f'ir_r1_k3_s1_e8_c{chs[4]}', f'ir_r3_k3_s1_e4_c{chs[4]}'],
                [f'ir_r1_k3_s2_e8_c{chs[5]}', f'ir_r3_k3_s1_e4_c{chs[5]}'],
                [f'ir_r1_k3_s1_e8_c{chs[6]}'],
            ]

        if 'edgetpu_v2_xs' in variant:
            stem_size = 32
            stem_kernel_size = 3
            channels = [16, 32, 48, 96, 144, 160, 192]
        elif 'edgetpu_v2_s' in variant:
            channels = [24, 48, 64, 128, 160, 192, 256]
        elif 'edgetpu_v2_m' in variant:
            channels = [32, 64, 80, 160, 192, 240, 320]
            num_features = 1344
        elif 'edgetpu_v2_l' in variant:
            stem_kernel_size = 7
            group_size = 128
            channels = [32, 64, 96, 192, 240, 256, 384]
            num_features = 1408
        else:
            raise AssertionError(f'unknown edgetpu v2 variant {variant}')
        arch_def = _arch_def(channels, group_size)
    else:  # v1
        stem_size = 32
        stem_kernel_size = 3
        num_features = 1280
        act_layer = resolve_act_layer(kwargs, 'relu')
        arch_def = [
            ['cn_r1_k1_s1_c16'],
            ['er_r1_k3_s2_e8_c32', 'er_r3_k3_s1_e4_c32'],
            ['er_r1_k3_s2_e8_c48', 'er_r3_k3_s1_e4_c48'],
            ['ir_r1_k3_s2_e8_c96', 'ir_r3_k3_s1_e4_c96'],
            ['ir_r1_k3_s1_e8_c96_noskip', 'ir_r3_k3_s1_e4_c96'],
            ['ir_r1_k5_s2_e8_c160', 'ir_r3_k5_s1_e4_c160'],
            ['ir_r1_k3_s1_e8_c192'],
        ]
    model_kwargs = dict(
        block_args=decode_arch_def(arch_def, depth_multiplier),
        num_features=num_features,
        stem_size=stem_size,
        stem_kernel_size=stem_kernel_size,
        round_chs_fn=partial(round_channels, multiplier=channel_multiplier),
        act_layer=act_layer,
        **kwargs,
    )
    return _create_effnet(variant, pretrained, **model_kwargs)


@register_model
def test_efficientnet(pretrained=False, **kwargs) -> EfficientNet:
    """Tiny fixture."""
    return _gen_test_efficientnet('test_efficientnet', pretrained=pretrained, **kwargs)


@register_model
def mobilenetv1_100(pretrained=False, **kwargs) -> EfficientNet:
    """ MobileNet V1 """
    model = _gen_mobilenet_v1('mobilenetv1_100', 1.0, pretrained=pretrained, **kwargs)
    return model


@register_model
def mobilenetv1_100h(pretrained=False, **kwargs) -> EfficientNet:
    """ MobileNet V1 """
    model = _gen_mobilenet_v1('mobilenetv1_100h', 1.0, head_conv=True, pretrained=pretrained, **kwargs)
    return model


@register_model
def mobilenetv1_125(pretrained=False, **kwargs) -> EfficientNet:
    """ MobileNet V1 """
    model = _gen_mobilenet_v1('mobilenetv1_125', 1.25, pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_b0_gn(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B0 + GroupNorm"""
    model = _gen_efficientnet(
        'efficientnet_b0_gn', norm_layer=partial(GroupNormAct, group_size=8), pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_b0_g8_gn(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B0 w/ group conv + GroupNorm"""
    model = _gen_efficientnet(
        'efficientnet_b0_g8_gn', group_size=8, norm_layer=partial(GroupNormAct, group_size=8),
        pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_b0_g16_evos(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B0 w/ group 16 conv + EvoNorm"""
    model = _gen_efficientnet(
        'efficientnet_b0_g16_evos', group_size=16, channel_divisor=16,
        pretrained=pretrained, **kwargs) #norm_layer=partial(EvoNorm2dS0, group_size=16),
    return model


@register_model
def efficientnet_b3_gn(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B3 w/ GroupNorm """
    # NOTE for train, drop_rate should be 0.3, drop_path_rate should be 0.2
    model = _gen_efficientnet(
        'efficientnet_b3_gn', channel_multiplier=1.2, depth_multiplier=1.4, channel_divisor=16,
        norm_layer=partial(GroupNormAct, group_size=16), pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_b3_g8_gn(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B3 w/ grouped conv + BN"""
    # NOTE for train, drop_rate should be 0.3, drop_path_rate should be 0.2
    model = _gen_efficientnet(
        'efficientnet_b3_g8_gn', channel_multiplier=1.2, depth_multiplier=1.4, group_size=8, channel_divisor=16,
        norm_layer=partial(GroupNormAct, group_size=16), pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_blur_b0(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B0 w/ BlurPool """
    # NOTE for train, drop_rate should be 0.2, drop_path_rate should be 0.2
    model = _gen_efficientnet(
        'efficientnet_blur_b0', channel_multiplier=1.0, depth_multiplier=1.0, pretrained=pretrained,
        aa_layer='blurpc', **kwargs
    )
    return model


@register_model
def efficientnet_es_pruned(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-Edge Small Pruned. For more info: https://github.com/DeGirum/pruned-models/releases/tag/efficientnet_v1.0"""
    model = _gen_efficientnet_edge(
        'efficientnet_es_pruned', channel_multiplier=1.0, depth_multiplier=1.0, pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_el_pruned(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-Edge-Large pruned. For more info: https://github.com/DeGirum/pruned-models/releases/tag/efficientnet_v1.0"""
    model = _gen_efficientnet_edge(
        'efficientnet_el_pruned', channel_multiplier=1.2, depth_multiplier=1.4, pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_cc_b0_4e(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-CondConv-B0 w/ 8 Experts """
    # NOTE for train, drop_rate should be 0.2, drop_path_rate should be 0.2
    model = _gen_efficientnet_condconv(
        'efficientnet_cc_b0_4e', channel_multiplier=1.0, depth_multiplier=1.0, pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_cc_b0_8e(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-CondConv-B0 w/ 8 Experts """
    # NOTE for train, drop_rate should be 0.2, drop_path_rate should be 0.2
    model = _gen_efficientnet_condconv(
        'efficientnet_cc_b0_8e', channel_multiplier=1.0, depth_multiplier=1.0, experts_multiplier=2,
        pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_cc_b1_8e(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-CondConv-B1 w/ 8 Experts """
    # NOTE for train, drop_rate should be 0.2, drop_path_rate should be 0.2
    model = _gen_efficientnet_condconv(
        'efficientnet_cc_b1_8e', channel_multiplier=1.0, depth_multiplier=1.1, experts_multiplier=2,
        pretrained=pretrained, **kwargs)
    return model


@register_model
def gc_efficientnetv2_rw_t(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-V2 Tiny w/ Global Context Attn (Custom variant, tiny not in paper). """
    model = _gen_efficientnetv2_s(
        'gc_efficientnetv2_rw_t', channel_multiplier=0.8, depth_multiplier=0.9,
        rw=False, se_layer='gc', pretrained=pretrained, **kwargs)
    return model


@register_model
def tf_efficientnet_cc_b0_4e(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-CondConv-B0 w/ 4 Experts. Tensorflow compatible variant """
    # NOTE for train, drop_rate should be 0.2, drop_path_rate should be 0.2
    kwargs.setdefault('bn_eps', BN_EPS_TF_DEFAULT)
    kwargs.setdefault('pad_type', 'same')
    model = _gen_efficientnet_condconv(
        'tf_efficientnet_cc_b0_4e', channel_multiplier=1.0, depth_multiplier=1.0, pretrained=pretrained, **kwargs)
    return model


@register_model
def tf_efficientnet_cc_b0_8e(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-CondConv-B0 w/ 8 Experts. Tensorflow compatible variant """
    # NOTE for train, drop_rate should be 0.2, drop_path_rate should be 0.2
    kwargs.setdefault('bn_eps', BN_EPS_TF_DEFAULT)
    kwargs.setdefault('pad_type', 'same')
    model = _gen_efficientnet_condconv(
        'tf_efficientnet_cc_b0_8e', channel_multiplier=1.0, depth_multiplier=1.0, experts_multiplier=2,
        pretrained=pretrained, **kwargs)
    return model


@register_model
def tf_efficientnet_cc_b1_8e(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-CondConv-B1 w/ 8 Experts. Tensorflow compatible variant """
    # NOTE for train, drop_rate should be 0.2, drop_path_rate should be 0.2
    kwargs.setdefault('bn_eps', BN_EPS_TF_DEFAULT)
    kwargs.setdefault('pad_type', 'same')
    model = _gen_efficientnet_condconv(
        'tf_efficientnet_cc_b1_8e', channel_multiplier=1.0, depth_multiplier=1.1, experts_multiplier=2,
        pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_x_b3(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B3 """
    # NOTE for train, drop_rate should be 0.3, drop_path_rate should be 0.2
    model = _gen_efficientnet_x(
        'efficientnet_x_b3', channel_multiplier=1.2, depth_multiplier=1.4, pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_x_b5(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B5 """
    model = _gen_efficientnet_x(
        'efficientnet_x_b5', channel_multiplier=1.6, depth_multiplier=2.2, pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_h_b5(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B5 """
    model = _gen_efficientnet_x(
        'efficientnet_h_b5', channel_multiplier=1.92, depth_multiplier=2.2, version=2, pretrained=pretrained, **kwargs)
    return model


@register_model
def mixnet_s(pretrained=False, **kwargs) -> EfficientNet:
    """Creates a MixNet Small model.
    """
    model = _gen_mixnet_s(
        'mixnet_s', channel_multiplier=1.0, pretrained=pretrained, **kwargs)
    return model


@register_model
def mixnet_m(pretrained=False, **kwargs) -> EfficientNet:
    """Creates a MixNet Medium model.
    """
    model = _gen_mixnet_m(
        'mixnet_m', channel_multiplier=1.0, pretrained=pretrained, **kwargs)
    return model


@register_model
def mixnet_l(pretrained=False, **kwargs) -> EfficientNet:
    """Creates a MixNet Large model.
    """
    model = _gen_mixnet_m(
        'mixnet_l', channel_multiplier=1.3, pretrained=pretrained, **kwargs)
    return model


@register_model
def mixnet_xl(pretrained=False, **kwargs) -> EfficientNet:
    """Creates a MixNet Extra-Large model.
    Not a paper spec, experimental def by RW w/ depth scaling.
    """
    model = _gen_mixnet_m(
        'mixnet_xl', channel_multiplier=1.6, depth_multiplier=1.2, pretrained=pretrained, **kwargs)
    return model


@register_model
def mixnet_xxl(pretrained=False, **kwargs) -> EfficientNet:
    """Creates a MixNet Double Extra Large model.
    Not a paper spec, experimental def by RW w/ depth scaling.
    """
    model = _gen_mixnet_m(
        'mixnet_xxl', channel_multiplier=2.4, depth_multiplier=1.3, pretrained=pretrained, **kwargs)
    return model


@register_model
def tf_mixnet_s(pretrained=False, **kwargs) -> EfficientNet:
    """Creates a MixNet Small model. Tensorflow compatible variant
    """
    kwargs.setdefault('bn_eps', BN_EPS_TF_DEFAULT)
    kwargs.setdefault('pad_type', 'same')
    model = _gen_mixnet_s(
        'tf_mixnet_s', channel_multiplier=1.0, pretrained=pretrained, **kwargs)
    return model


@register_model
def tf_mixnet_m(pretrained=False, **kwargs) -> EfficientNet:
    """Creates a MixNet Medium model. Tensorflow compatible variant
    """
    kwargs.setdefault('bn_eps', BN_EPS_TF_DEFAULT)
    kwargs.setdefault('pad_type', 'same')
    model = _gen_mixnet_m(
        'tf_mixnet_m', channel_multiplier=1.0, pretrained=pretrained, **kwargs)
    return model


@register_model
def tf_mixnet_l(pretrained=False, **kwargs) -> EfficientNet:
    """Creates a MixNet Large model. Tensorflow compatible variant
    """
    kwargs.setdefault('bn_eps', BN_EPS_TF_DEFAULT)
    kwargs.setdefault('pad_type', 'same')
    model = _gen_mixnet_m(
        'tf_mixnet_l', channel_multiplier=1.3, pretrained=pretrained, **kwargs)
    return model


@register_model
def mobilenet_edgetpu_100(pretrained=False, **kwargs) -> EfficientNet:
    """ MobileNet-EdgeTPU-v1 100. """
    model = _gen_mobilenet_edgetpu('mobilenet_edgetpu_100', pretrained=pretrained, **kwargs)
    return model


@register_model
def mobilenet_edgetpu_v2_xs(pretrained=False, **kwargs) -> EfficientNet:
    """ MobileNet-EdgeTPU-v2 Extra Small. """
    model = _gen_mobilenet_edgetpu('mobilenet_edgetpu_v2_xs', pretrained=pretrained, **kwargs)
    return model


@register_model
def mobilenet_edgetpu_v2_s(pretrained=False, **kwargs) -> EfficientNet:
    """ MobileNet-EdgeTPU-v2 Small. """
    model = _gen_mobilenet_edgetpu('mobilenet_edgetpu_v2_s', pretrained=pretrained, **kwargs)
    return model


@register_model
def mobilenet_edgetpu_v2_m(pretrained=False, **kwargs) -> EfficientNet:
    """ MobileNet-EdgeTPU-v2 Medium. """
    model = _gen_mobilenet_edgetpu('mobilenet_edgetpu_v2_m', pretrained=pretrained, **kwargs)
    return model


@register_model
def mobilenet_edgetpu_v2_l(pretrained=False, **kwargs) -> EfficientNet:
    """ MobileNet-EdgeTPU-v2 Large. """
    model = _gen_mobilenet_edgetpu('mobilenet_edgetpu_v2_l', pretrained=pretrained, **kwargs)
    return model


@register_model
def test_efficientnet_gn(pretrained=False, **kwargs) -> EfficientNet:

    model = _gen_test_efficientnet(
        'test_efficientnet_gn',
        pretrained=pretrained,
        norm_layer=kwargs.pop('norm_layer', partial(GroupNormAct, group_size=8)),
        **kwargs
    )
    return model


@register_model
def test_efficientnet_ln(pretrained=False, **kwargs) -> EfficientNet:
    model = _gen_test_efficientnet(
        'test_efficientnet_ln',
        pretrained=pretrained,
        norm_layer=kwargs.pop('norm_layer', LayerNormAct2d),
        **kwargs
    )
    return model


@register_model
def test_efficientnet_evos(pretrained=False, **kwargs) -> EfficientNet:
    model = _gen_test_efficientnet(
        'test_efficientnet_evos',
        pretrained=pretrained,
        norm_layer=kwargs.pop('norm_layer', partial(EvoNorm2dS0, group_size=8)),
        **kwargs
    )
    return model


@register_model
def efficientnet_b1_pruned(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B1 Pruned. The pruning has been obtained using https://arxiv.org/pdf/2002.08258.pdf  """
    kwargs.setdefault('bn_eps', BN_EPS_TF_DEFAULT)
    kwargs.setdefault('pad_type', 'same')
    variant = 'efficientnet_b1_pruned'
    model = _gen_efficientnet(
        variant, channel_multiplier=1.0, depth_multiplier=1.1, pruned=True, pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_b2_pruned(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B2 Pruned. The pruning has been obtained using https://arxiv.org/pdf/2002.08258.pdf """
    kwargs.setdefault('bn_eps', BN_EPS_TF_DEFAULT)
    kwargs.setdefault('pad_type', 'same')
    model = _gen_efficientnet(
        'efficientnet_b2_pruned', channel_multiplier=1.1, depth_multiplier=1.2, pruned=True,
        pretrained=pretrained, **kwargs)
    return model


@register_model
def efficientnet_b3_pruned(pretrained=False, **kwargs) -> EfficientNet:
    """ EfficientNet-B3 Pruned. The pruning has been obtained using https://arxiv.org/pdf/2002.08258.pdf """
    kwargs.setdefault('bn_eps', BN_EPS_TF_DEFAULT)
    kwargs.setdefault('pad_type', 'same')
    model = _gen_efficientnet(
        'efficientnet_b3_pruned', channel_multiplier=1.2, depth_multiplier=1.4, pruned=True,
        pretrained=pretrained, **kwargs)
    return model
