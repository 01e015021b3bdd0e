"""ResNet / ResNeXt / SE-ResNet / ECA-ResNet / ResNet-D / ResNet-RS over NHWC
activations (counterpart of timm_tpu/models/resnet.py).

A stem (one 7x7 conv, or the 'deep' / 'deep_tiered' three 3x3 convs) with
its BatchNorm + ReLU, the stem pool, four stages of ``BasicBlock`` or
``Bottleneck`` and the classifier head. The convolutions are
``layers.Conv2d`` (``F.conv2d`` on channels_last views, cuDNN on the card)
and the norms ``BatchNormAct2d`` (flax's BatchNorm semantics, running
statistics updated in place) or, for ``resnet50_gn``, ``GroupNormAct``; no
Pallas kernel of the JAX package lies on this model's forward. Every module
takes the model's ``dtype``, as in JAX.

Traps, where the JAX package is not torch timm:

- ``avg_pool2d`` (``DownsampleAvg``) is XLA's 'SAME' window: a 2x2 window at
  stride 2 padded at the end, divided by the count of real elements
  (count_include_pad=False); ``max_pool2d`` pads (k - 1) // 2 on both sides,
  torch-style, with -inf (the stem's 3x3 / 2 pool).
- The anti-aliased stem: blur pool gives a 3x3 max pool at stride 1 followed
  by the blur at stride 2 (``stem_pool_max = 'stride1'``); the average-pool
  anti-aliasing replaces the max pool by ``AvgPool2dAA``; ``replace_stem_pool``
  gives a strided 3x3 conv (stride 1 and the aa layer when there is one)
  and its norm + act.
- A block's anti-aliasing runs its 3x3 conv at stride 1 and the aa layer at
  the stride, after the norm (``BasicBlock``: after bn1; ``Bottleneck``:
  after bn2).
- ``zero_init_last`` zeroes every block's last BatchNorm scale, so at init
  each block is its shortcut: comparisons of random weights set those
  scales first.
- ``block_args=dict(attn_layer=...)`` becomes the block's ``se_layer``
  (``get_attn``), as in JAX; ResNet-RS's is SE with ``rd_ratio=0.25``.
- ``output_stride`` 16 or 8 turns the last strides into dilation. The JAX
  package passes the blocks no ``first_dilation``, so a dilated stage's
  first block dilates as its others do, where torch timm keeps the
  previous stage's dilation there; the port copies JAX.

Ported: the model, its contract (no_weight_decay, group_matcher,
get_classifier, reset_classifier, forward_features, forward_head,
forward_intermediates, prune_intermediate_layers), the default cfgs and
every entrypoint of the JAX module. Gradient checkpointing and
``features_only`` raise (ROADMAP A.5.7); ``checkpoint_filter_fn`` maps
upstream torch timm names and needs a hub (ROADMAP A.5.1): weights come from
the JAX package through ``load_jax_state_dict``.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (
    AvgPool2dAA, BatchNormAct2d, BlurPool2d, ClassifierHead, DropPath, EcaModule, SEModule,
    calculate_drop_path_rates, create_conv2d, get_aa_layer, get_act_fn, get_attn,
    get_norm_act_layer,
)
from ._builder import build_model_with_cfg
from ._features import feature_take_indices
from ._registry import generate_default_cfgs, register_model

__all__ = ['ResNet', 'BasicBlock', 'Bottleneck']


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f'{what} is not ported yet (ROADMAP A.5.7)')


def _same_end_pad(size: int, k: int, s: int) -> int:
    """XLA's 'SAME' total padding of a window k at stride s; its (total // 2,
    total - total // 2) split puts all of it at the end when k == s."""
    return max((-(-size // s) - 1) * s + k - size, 0)


def avg_pool2d(x: torch.Tensor, kernel: int = 2, stride: int = 2,
               pad_same: bool = False) -> torch.Tensor:
    """NHWC average pool: 'VALID' divided by k^2, or 'SAME' divided by the
    count of real elements in each window (count_include_pad=False)."""
    x = x.permute(0, 3, 1, 2)
    if not pad_same:
        return F.avg_pool2d(x, kernel, stride).permute(0, 2, 3, 1)
    th, tw = (_same_end_pad(n, kernel, stride) for n in x.shape[2:])
    pads = (tw // 2, tw - tw // 2, th // 2, th - th // 2)
    total = F.avg_pool2d(F.pad(x, pads), kernel, stride, divisor_override=1)
    ones = F.pad(torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device), pads)
    counts = F.avg_pool2d(ones, kernel, stride, divisor_override=1)
    return (total / counts).permute(0, 2, 3, 1)


def max_pool2d(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """NHWC max pool with the symmetric (k - 1) // 2 padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, padding=(kernel - 1) // 2)
    return y.permute(0, 2, 3, 1)


class DownsampleConv(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 1, stride: int = 1,
                 dilation: int = 1, norm_layer=None, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNormAct2d
        kernel_size = 1 if stride == 1 and dilation == 1 else kernel_size
        first_dilation = (dilation or 1) if kernel_size > 1 else 1
        self.conv = create_conv2d(in_chs, out_chs, kernel_size, stride=stride,
                                  dilation=first_dilation, padding=None, dtype=dtype,
                                  generator=generator)
        self.bn = norm_layer(out_chs, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class DownsampleAvg(nn.Module):
    """'SAME' 2x2 average pool + 1x1 conv + norm (the 'd' variants)."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, dilation: int = 1,
                 norm_layer=None, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNormAct2d
        self.pool_stride = stride if dilation == 1 else 1
        self.conv = create_conv2d(in_chs, out_chs, 1, dtype=dtype, generator=generator)
        self.bn = norm_layer(out_chs, apply_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_stride > 1:
            x = avg_pool2d(x, 2, self.pool_stride, pad_same=True)
        return self.bn(self.conv(x))


def _zero_(norm: nn.Module) -> None:
    if getattr(norm, 'weight', None) is not None:
        with torch.no_grad():
            norm.weight.zero_()


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, cardinality: int = 1,
                 base_width: int = 64, reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act_layer: Union[str, Callable] = 'relu',
                 norm_layer: Callable = BatchNormAct2d, attn_layer: Optional[Callable] = None,
                 aa_layer: Optional[Callable] = None, drop_path: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cardinality != 1 or base_width != 64:
            raise ValueError('BasicBlock only supports default cardinality / width')
        first_planes = planes // reduce_first
        outplanes = planes * self.expansion
        first_dilation = first_dilation or dilation
        use_aa = aa_layer is not None and (stride == 2 or first_dilation != dilation)
        conv = partial(create_conv2d, padding=None, dtype=dtype, generator=generator)
        self.conv1 = conv(inplanes, first_planes, 3, stride=1 if use_aa else stride,
                          dilation=first_dilation)
        self.bn1 = norm_layer(first_planes, act_layer=act_layer, dtype=dtype)
        self.aa = aa_layer(channels=first_planes, stride=stride) if use_aa else None
        self.conv2 = conv(first_planes, outplanes, 3, dilation=dilation)
        self.bn2 = norm_layer(outplanes, apply_act=False, dtype=dtype)
        self.se = attn_layer(outplanes, dtype=dtype, generator=generator) if attn_layer else None
        self.act = get_act_fn(act_layer)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path)

    def zero_init_last(self) -> None:
        _zero_(self.bn2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.bn1(self.conv1(x))
        if self.aa is not None:
            x = self.aa(x)
        x = self.bn2(self.conv2(x))
        if self.se is not None:
            x = self.se(x)
        x = self.drop_path(x)
        if self.downsample is not None:
            shortcut = self.downsample(shortcut)
        return self.act(x + shortcut)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, cardinality: int = 1,
                 base_width: int = 64, reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act_layer: Union[str, Callable] = 'relu',
                 norm_layer: Callable = BatchNormAct2d, attn_layer: Optional[Callable] = None,
                 aa_layer: Optional[Callable] = None, drop_path: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64)) * cardinality)
        first_planes = width // reduce_first
        outplanes = planes * self.expansion
        first_dilation = first_dilation or dilation
        use_aa = aa_layer is not None and (stride == 2 or first_dilation != dilation)
        conv = partial(create_conv2d, dtype=dtype, generator=generator)
        self.conv1 = conv(inplanes, first_planes, 1)
        self.bn1 = norm_layer(first_planes, act_layer=act_layer, dtype=dtype)
        self.conv2 = conv(first_planes, width, 3, stride=1 if use_aa else stride,
                          dilation=first_dilation, groups=cardinality, padding=None)
        self.bn2 = norm_layer(width, act_layer=act_layer, dtype=dtype)
        self.aa = aa_layer(channels=width, stride=stride) if use_aa else None
        self.conv3 = conv(width, outplanes, 1)
        self.bn3 = norm_layer(outplanes, apply_act=False, dtype=dtype)
        self.se = attn_layer(outplanes, dtype=dtype, generator=generator) if attn_layer else None
        self.act = get_act_fn(act_layer)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path)

    def zero_init_last(self) -> None:
        _zero_(self.bn3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.bn1(self.conv1(x))
        x = self.bn2(self.conv2(x))
        if self.aa is not None:
            x = self.aa(x)
        x = self.bn3(self.conv3(x))
        if self.se is not None:
            x = self.se(x)
        x = self.drop_path(x)
        if self.downsample is not None:
            shortcut = self.downsample(shortcut)
        return self.act(x + shortcut)


class ResNet(nn.Module):
    def __init__(
            self,
            block: Union[Type[BasicBlock], Type[Bottleneck], str] = Bottleneck,
            layers: Tuple[int, ...] = (3, 4, 6, 3),
            channels: Tuple[int, ...] = (64, 128, 256, 512),
            num_classes: int = 1000,
            in_chans: int = 3,
            output_stride: int = 32,
            global_pool: str = 'avg',
            cardinality: int = 1,
            base_width: int = 64,
            stem_width: int = 64,
            stem_type: str = '',
            replace_stem_pool: bool = False,
            avg_down: bool = False,
            block_reduce_first: int = 1,
            down_kernel_size: int = 1,
            act_layer: Union[str, Callable] = 'relu',
            norm_layer: Union[str, Callable] = BatchNormAct2d,
            se_layer: Optional[Callable] = None,
            aa_layer: Optional[Union[str, Callable]] = None,
            block_args: Optional[Dict[str, Any]] = None,
            drop_rate: float = 0.0,
            drop_path_rate: float = 0.0,
            zero_init_last: bool = True,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if isinstance(block, str):
            block = {'basic': BasicBlock, 'bottleneck': Bottleneck}[block.lower()]
        if output_stride not in (8, 16, 32):
            raise ValueError(f'output_stride {output_stride}: 8, 16 or 32')
        self.num_classes = num_classes
        self.drop_rate = drop_rate
        block_args = dict(block_args) if block_args else {}
        if 'attn_layer' in block_args:
            se_layer = se_layer or get_attn(block_args.pop('attn_layer'))
        aa_layer = get_aa_layer(aa_layer)
        if isinstance(norm_layer, str):
            norm_layer = get_norm_act_layer(norm_layer, act_layer=act_layer)
        conv = partial(create_conv2d, padding=None, dtype=dtype, generator=generator)
        norm_act = partial(norm_layer, act_layer=act_layer, dtype=dtype)

        # stem
        deep_stem = 'deep' in stem_type
        inplanes = stem_width * 2 if deep_stem else 64
        if deep_stem:
            stem_chs = (stem_width, stem_width)
            if 'tiered' in stem_type:
                stem_chs = (3 * (stem_width // 4), stem_width)
            self.conv1 = nn.ModuleList([
                conv(in_chans, stem_chs[0], 3, stride=2),
                conv(stem_chs[0], stem_chs[1], 3),
                conv(stem_chs[1], inplanes, 3)])
            self.bn_stem = nn.ModuleList([norm_act(stem_chs[0]), norm_act(stem_chs[1])])
        else:
            self.conv1 = conv(in_chans, inplanes, 7, stride=2)
            self.bn_stem = None
        self.bn1 = norm_act(inplanes)
        self.feature_info = [dict(num_chs=inplanes, reduction=2, module='bn1')]

        # stem pooling: a 3x3 / 2 max pool, a strided conv (+ norm / act) in
        # its place, or anti-aliasing after or in place of it
        self.stem_pool_conv = self.stem_pool_norm = self.stem_pool_aa = None
        if replace_stem_pool:
            self.stem_pool_max = False
            self.stem_pool_conv = conv(inplanes, inplanes, 3, stride=1 if aa_layer else 2)
            self.stem_pool_aa = (aa_layer(channels=inplanes, stride=2)
                                 if aa_layer is not None else None)
            self.stem_pool_norm = norm_act(inplanes)
        elif aa_layer is not None:
            if aa_layer is AvgPool2dAA:
                self.stem_pool_max = False
                self.stem_pool_aa = AvgPool2dAA(stride=2)
            else:
                self.stem_pool_max = 'stride1'
                self.stem_pool_aa = aa_layer(channels=inplanes, stride=2)
        else:
            self.stem_pool_max = True

        # stages
        dpr = calculate_drop_path_rates(drop_path_rate, list(layers), stagewise=True)
        net_stride, dilation = 4, 1
        stages = []
        for stage_idx, (planes, num_blocks) in enumerate(zip(channels, layers)):
            stride = 1 if stage_idx == 0 else 2
            if net_stride >= output_stride and stride > 1:
                dilation *= stride
                stride = 1
            else:
                net_stride *= stride
            downsample = None
            if stride != 1 or inplanes != planes * block.expansion:
                if avg_down:
                    downsample = DownsampleAvg(
                        inplanes, planes * block.expansion, stride=stride, dilation=dilation,
                        norm_layer=norm_layer, dtype=dtype, generator=generator)
                else:
                    downsample = DownsampleConv(
                        inplanes, planes * block.expansion, kernel_size=down_kernel_size,
                        stride=stride, dilation=dilation, norm_layer=norm_layer, dtype=dtype,
                        generator=generator)
            blocks = []
            for block_idx in range(num_blocks):
                blocks.append(block(
                    inplanes, planes, stride=stride if block_idx == 0 else 1,
                    downsample=downsample if block_idx == 0 else None,
                    cardinality=cardinality, base_width=base_width,
                    reduce_first=block_reduce_first, dilation=dilation, act_layer=act_layer,
                    norm_layer=norm_layer, attn_layer=se_layer, aa_layer=aa_layer,
                    drop_path=dpr[stage_idx][block_idx], dtype=dtype, generator=generator,
                    **block_args))
                inplanes = planes * block.expansion
            stages.append(nn.ModuleList(blocks))
            self.feature_info.append(dict(num_chs=inplanes, reduction=net_stride,
                                          module=f'layer{stage_idx + 1}'))
        self.layer1, self.layer2, self.layer3, self.layer4 = stages

        self.num_features = self.head_hidden_size = inplanes
        self.head = ClassifierHead(self.num_features, num_classes, pool_type=global_pool,
                                   drop_rate=drop_rate, dtype=dtype, generator=generator)
        if zero_init_last:
            for stage in stages:
                for b in stage:
                    b.zero_init_last()

    # -- contract ------------------------------------------------------------
    def no_weight_decay(self) -> set:
        return set()

    def group_matcher(self, coarse: bool = False):
        return dict(stem=r'^conv1|^bn1|^bn_stem',
                    blocks=r'^layer(\d+)' if coarse else r'^layer(\d+)\.(\d+)')

    def set_grad_checkpointing(self, enable: bool = True):
        if enable:
            raise _not_ported('gradient checkpointing')

    def get_classifier(self) -> Optional[nn.Module]:
        return self.head.fc

    def reset_classifier(self, num_classes: int, global_pool: Optional[str] = None,
                         generator: Optional[torch.Generator] = None):
        self.num_classes = num_classes
        self.head.reset(num_classes, pool_type=global_pool, generator=generator)
        self.head.to(self.bn1.weight.device)

    # -- forward -------------------------------------------------------------
    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn_stem is not None:
            x = self.bn_stem[0](self.conv1[0](x))
            x = self.bn_stem[1](self.conv1[1](x))
            x = self.conv1[2](x)
        else:
            x = self.conv1(x)
        x = self.bn1(x)
        if self.stem_pool_conv is not None:
            x = self.stem_pool_conv(x)
            if self.stem_pool_aa is not None:
                x = self.stem_pool_aa(x)
            return self.stem_pool_norm(x)
        if self.stem_pool_max == 'stride1':
            x = max_pool2d(x, 3, 1)
        elif self.stem_pool_max:
            x = max_pool2d(x, 3, 2)
        if self.stem_pool_aa is not None:
            x = self.stem_pool_aa(x)
        return x

    def _stages(self) -> List[nn.ModuleList]:
        return [self.layer1, self.layer2, self.layer3, self.layer4]

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H/32, W/32, num_features) at output_stride 32."""
        x = self._stem(x)
        for stage in self._stages():
            for b in stage:
                x = b(x)
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
        """The stem's (index 0) and the stages' NHWC outputs at ``indices``,
        and the final features unless ``intermediates_only``."""
        if output_fmt != 'NHWC':
            raise ValueError('Conv models emit NHWC features')
        stages = self._stages()
        take_indices, max_index = feature_take_indices(len(stages) + 1, indices)
        intermediates = []
        x = self._stem(x)
        if 0 in take_indices:
            intermediates.append(x)
        for i, stage in enumerate(stages):
            if not stop_early or i <= max_index - 1:
                for b in stage:
                    x = b(x)
                if (i + 1) in take_indices:
                    intermediates.append(x)
        if intermediates_only:
            return intermediates
        return x, intermediates

    def prune_intermediate_layers(self, indices=1, prune_norm: bool = False,
                                  prune_head: bool = True):
        take_indices, _ = feature_take_indices(5, indices)
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
        'first_conv': 'conv1',
        'classifier': 'head.fc',
        **kwargs,
    }


default_cfgs = generate_default_cfgs({
    'resnet18.a1_in1k': _cfg(hf_hub_id='timm/'),
    'resnet26.bt_in1k': _cfg(hf_hub_id='timm/'),
    'resnet34.a1_in1k': _cfg(hf_hub_id='timm/'),
    'resnet50.a1_in1k': _cfg(hf_hub_id='timm/'),
    'resnet50d.ra2_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0'),
    'resnet101.a1_in1k': _cfg(hf_hub_id='timm/'),
    'resnet152.a1_in1k': _cfg(hf_hub_id='timm/'),
    'resnext50_32x4d.a1_in1k': _cfg(hf_hub_id='timm/'),
    'wide_resnet50_2.racm_in1k': _cfg(hf_hub_id='timm/'),
    'seresnet50.ra2_in1k': _cfg(hf_hub_id='timm/'),
    'test_resnet.r160_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), crop_pct=0.95),
    # tail variants (cfg values ported exactly from reference resnet.py
    # default_cfgs; _ttcfg = timm-trained default: test 288px @ 0.95)
    'resnet10t.c3_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0', input_size=(3, 176, 176),
                              pool_size=(6, 6), test_input_size=(3, 224, 224), test_crop_pct=0.95),
    'resnet14t.c3_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0', input_size=(3, 176, 176),
                              pool_size=(6, 6), test_input_size=(3, 224, 224), test_crop_pct=0.95),
    'resnet18d.ra2_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0',
                               test_input_size=(3, 288, 288), test_crop_pct=0.95),
    'resnet26d.bt_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0',
                              test_input_size=(3, 288, 288), test_crop_pct=0.95),
    'resnet26t.ra2_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0', input_size=(3, 256, 256),
                               pool_size=(8, 8), crop_pct=0.94, test_input_size=(3, 320, 320),
                               test_crop_pct=1.0),
    'resnet34d.ra2_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0',
                               test_input_size=(3, 288, 288), test_crop_pct=0.95),
    'resnet50t.untrained': _cfg(first_conv='conv1.0', test_input_size=(3, 288, 288), test_crop_pct=0.95),
    'resnet101d.ra2_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0', input_size=(3, 256, 256),
                                pool_size=(8, 8), crop_pct=0.95, test_input_size=(3, 320, 320),
                                test_crop_pct=1.0),
    'resnet152d.ra2_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0', input_size=(3, 256, 256),
                                pool_size=(8, 8), crop_pct=0.95, test_input_size=(3, 320, 320),
                                test_crop_pct=1.0),
    'resnet200.untrained': _cfg(test_input_size=(3, 288, 288), test_crop_pct=0.95),
    'resnet200d.ra2_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0', input_size=(3, 256, 256),
                                pool_size=(8, 8), crop_pct=0.95, test_input_size=(3, 320, 320),
                                test_crop_pct=1.0),
    'resnext50d_32x4d.bt_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0'),
    'resnext101_32x4d.fb_ssl_yfcc100m_ft_in1k': _cfg(hf_hub_id='timm/'),
    'resnext101_32x8d.fb_wsl_ig1b_ft_in1k': _cfg(hf_hub_id='timm/'),
    'resnext101_32x16d.fb_wsl_ig1b_ft_in1k': _cfg(hf_hub_id='timm/'),
    'resnext101_64x4d.c1_in1k': _cfg(hf_hub_id='timm/'),
    'wide_resnet101_2.tv2_in1k': _cfg(
        hf_hub_id='timm/', input_size=(3, 176, 176), pool_size=(6, 6),
        test_input_size=(3, 224, 224), test_crop_pct=0.965),
    'seresnet34.untrained': _cfg(),
    'seresnet50t.untrained': _cfg(first_conv='conv1.0'),
    'seresnet101.untrained': _cfg(),
    'seresnet152.untrained': _cfg(),
    'seresnext26d_32x4d.bt_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0'),
    'seresnext26t_32x4d.bt_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0'),
    'seresnext50_32x4d.racm_in1k': _cfg(hf_hub_id='timm/'),
    'seresnext101_32x4d.untrained': _cfg(),
    'seresnext101_32x8d.ah_in1k': _cfg(
        hf_hub_id='timm/', crop_pct=0.95, test_input_size=(3, 288, 288), test_crop_pct=1.0),
    'seresnext101_64x4d.gluon_in1k': _cfg(hf_hub_id='timm/'),
    'ecaresnet26t.ra2_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0', input_size=(3, 256, 256),
                                  pool_size=(8, 8), test_input_size=(3, 320, 320), test_crop_pct=0.95),
    'ecaresnet50d.miil_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0'),
    'ecaresnet50t.ra2_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0', input_size=(3, 256, 256),
                                  test_input_size=(3, 320, 320), crop_pct=0.95),
    'ecaresnet101d.miil_in1k': _cfg(hf_hub_id='timm/', first_conv='conv1.0'),
    'ecaresnetlight.miil_in1k': _cfg(hf_hub_id='timm/'),
    'resnet50c.gluon_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'resnet50s.gluon_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'resnet101c.gluon_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'resnet101s.gluon_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'resnet152c.gluon_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'resnet152s.gluon_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'resnet50_gn.a1h_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.94, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1', classifier='fc'),
    'resnext101_32x32d.fb_wsl_ig1b_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, interpolation='bilinear', mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1', classifier='fc'),
    'ecaresnet50d_pruned.miil_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1.0', classifier='fc'),
    'ecaresnet101d_pruned.miil_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1.0', classifier='fc'),
    'ecaresnet200d.untrained': _cfg(input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1.0', classifier='fc'),
    'ecaresnet269d.ra2_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 320, 320), pool_size=(10, 10), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 352, 352), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'ecaresnext26t_32x4d.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'ecaresnext50t_32x4d.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'seresnet18.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1', classifier='fc'),
    'seresnet152d.ra2_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 320, 320), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'seresnet200d.untrained': _cfg(input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1.0', classifier='fc'),
    'seresnet269d.untrained': _cfg(input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1.0', classifier='fc'),
    'seresnext101d_32x8d.ah_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'senet154.gluon_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'resnetblur18.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1', classifier='fc'),
    'resnetblur50.bt_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1', classifier='fc'),
    'resnetblur50d.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1.0', classifier='fc'),
    'resnetblur101d.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1.0', classifier='fc'),
    'resnetaa34d.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1.0', classifier='fc'),
    'resnetaa50.a1h_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1', classifier='fc'),
    'resnetaa50d.sw_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'resnetaa50d.sw_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'resnetaa50d.d_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'resnetaa101d.sw_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'resnetaa101d.sw_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'seresnetaa50d.untrained': _cfg(input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=0.95, first_conv='conv1.0', classifier='fc'),
    'seresnextaa101d_32x8d.sw_in12k_ft_in1k_288': _cfg(hf_hub_id='timm/', input_size=(3, 288, 288), pool_size=(9, 9), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 320, 320), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'seresnextaa101d_32x8d.sw_in12k_ft_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.875, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'seresnextaa101d_32x8d.sw_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'seresnextaa101d_32x8d.ah_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 224, 224), pool_size=(7, 7), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'seresnextaa201d_32x8d.sw_in12k_ft_in1k_384': _cfg(hf_hub_id='timm/', input_size=(3, 384, 384), pool_size=(12, 12), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), first_conv='conv1.0', classifier='fc'),
    'seresnextaa201d_32x8d.sw_in12k': _cfg(hf_hub_id='timm/', num_classes=11821, input_size=(3, 320, 320), pool_size=(10, 10), crop_pct=0.95, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 384, 384), test_crop_pct=1.0, first_conv='conv1.0', classifier='fc'),
    'resnetrs50.tf_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 160, 160), pool_size=(5, 5), crop_pct=0.91, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 224, 224), first_conv='conv1.0', classifier='fc'),
    'resnetrs101.tf_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 192, 192), pool_size=(6, 6), crop_pct=0.94, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 288, 288), first_conv='conv1.0', classifier='fc'),
    'resnetrs152.tf_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 320, 320), first_conv='conv1.0', classifier='fc'),
    'resnetrs200.tf_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 320, 320), first_conv='conv1.0', classifier='fc'),
    'resnetrs270.tf_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 352, 352), first_conv='conv1.0', classifier='fc'),
    'resnetrs350.tf_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 288, 288), pool_size=(9, 9), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 384, 384), first_conv='conv1.0', classifier='fc'),
    'resnetrs420.tf_in1k': _cfg(hf_hub_id='timm/', input_size=(3, 320, 320), pool_size=(10, 10), crop_pct=1.0, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), test_input_size=(3, 416, 416), first_conv='conv1.0', classifier='fc'),
})


def _create_resnet(variant: str, pretrained: bool = False, **kwargs) -> ResNet:
    if kwargs.pop('features_only', False):
        raise _not_ported('features_only')
    kwargs.pop('out_indices', None)
    return build_model_with_cfg(ResNet, variant, pretrained, **kwargs)


@register_model
def resnet18(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=BasicBlock, layers=(2, 2, 2, 2))
    return _create_resnet('resnet18', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet26(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(2, 2, 2, 2))
    return _create_resnet('resnet26', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet34(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=BasicBlock, layers=(3, 4, 6, 3))
    return _create_resnet('resnet34', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet50(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3))
    return _create_resnet('resnet50', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet50d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnet50d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet101(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3))
    return _create_resnet('resnet101', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet152(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 8, 36, 3))
    return _create_resnet('resnet152', pretrained, **dict(model_args, **kwargs))


@register_model
def resnext50_32x4d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), cardinality=32, base_width=4)
    return _create_resnet('resnext50_32x4d', pretrained, **dict(model_args, **kwargs))


@register_model
def wide_resnet50_2(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), base_width=128)
    return _create_resnet('wide_resnet50_2', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnet50(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), se_layer=SEModule)
    return _create_resnet('seresnet50', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet10t(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=BasicBlock, layers=(1, 1, 1, 1), stem_width=32, stem_type='deep_tiered', avg_down=True)
    return _create_resnet('resnet10t', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet14t(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(1, 1, 1, 1), stem_width=32, stem_type='deep_tiered', avg_down=True)
    return _create_resnet('resnet14t', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet18d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=BasicBlock, layers=(2, 2, 2, 2), stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnet18d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet26d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(2, 2, 2, 2), stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnet26d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet26t(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(2, 2, 2, 2), stem_width=32, stem_type='deep_tiered', avg_down=True)
    return _create_resnet('resnet26t', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet34d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=BasicBlock, layers=(3, 4, 6, 3), stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnet34d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet50t(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), stem_width=32, stem_type='deep_tiered', avg_down=True)
    return _create_resnet('resnet50t', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet101d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnet101d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet152d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 8, 36, 3), stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnet152d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet200(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 24, 36, 3))
    return _create_resnet('resnet200', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet200d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 24, 36, 3), stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnet200d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnext50d_32x4d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 6, 3), cardinality=32, base_width=4,
        stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnext50d_32x4d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnext101_32x4d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), cardinality=32, base_width=4)
    return _create_resnet('resnext101_32x4d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnext101_32x8d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), cardinality=32, base_width=8)
    return _create_resnet('resnext101_32x8d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnext101_32x16d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), cardinality=32, base_width=16)
    return _create_resnet('resnext101_32x16d', pretrained, **dict(model_args, **kwargs))


@register_model
def resnext101_64x4d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), cardinality=64, base_width=4)
    return _create_resnet('resnext101_64x4d', pretrained, **dict(model_args, **kwargs))


@register_model
def wide_resnet101_2(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), base_width=128)
    return _create_resnet('wide_resnet101_2', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnet34(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=BasicBlock, layers=(3, 4, 6, 3), se_layer=SEModule)
    return _create_resnet('seresnet34', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnet50t(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 6, 3), stem_width=32, stem_type='deep_tiered',
        avg_down=True, se_layer=SEModule)
    return _create_resnet('seresnet50t', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnet101(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), se_layer=SEModule)
    return _create_resnet('seresnet101', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnet152(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 8, 36, 3), se_layer=SEModule)
    return _create_resnet('seresnet152', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnext26d_32x4d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(2, 2, 2, 2), cardinality=32, base_width=4, stem_width=32,
        stem_type='deep', avg_down=True, se_layer=SEModule)
    return _create_resnet('seresnext26d_32x4d', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnext26t_32x4d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(2, 2, 2, 2), cardinality=32, base_width=4, stem_width=32,
        stem_type='deep_tiered', avg_down=True, se_layer=SEModule)
    return _create_resnet('seresnext26t_32x4d', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnext50_32x4d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), cardinality=32, base_width=4, se_layer=SEModule)
    return _create_resnet('seresnext50_32x4d', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnext101_32x4d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), cardinality=32, base_width=4, se_layer=SEModule)
    return _create_resnet('seresnext101_32x4d', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnext101_32x8d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), cardinality=32, base_width=8, se_layer=SEModule)
    return _create_resnet('seresnext101_32x8d', pretrained, **dict(model_args, **kwargs))


@register_model
def seresnext101_64x4d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), cardinality=64, base_width=4, se_layer=SEModule)
    return _create_resnet('seresnext101_64x4d', pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnet26t(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(2, 2, 2, 2), stem_width=32, stem_type='deep_tiered',
        avg_down=True, se_layer=EcaModule)
    return _create_resnet('ecaresnet26t', pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnet50d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 6, 3), stem_width=32, stem_type='deep',
        avg_down=True, se_layer=EcaModule)
    return _create_resnet('ecaresnet50d', pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnet50t(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 6, 3), stem_width=32, stem_type='deep_tiered',
        avg_down=True, se_layer=EcaModule)
    return _create_resnet('ecaresnet50t', pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnet101d(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 23, 3), stem_width=32, stem_type='deep',
        avg_down=True, se_layer=EcaModule)
    return _create_resnet('ecaresnet101d', pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnetlight(pretrained=False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(1, 1, 11, 3), stem_width=32, avg_down=True, se_layer=EcaModule)
    return _create_resnet('ecaresnetlight', pretrained, **dict(model_args, **kwargs))


@register_model
def test_resnet(pretrained=False, **kwargs) -> ResNet:
    """Tiny fixture (reference resnet.py:2213)."""
    model_args = dict(block=BasicBlock, layers=(1, 1, 1, 1), channels=(32, 48, 48, 96))
    return _create_resnet('test_resnet', pretrained, **dict(model_args, **kwargs))


@register_model
def resnet50c(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-50-C model."""
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), stem_width=32, stem_type='deep')
    return _create_resnet('resnet50c', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnet50s(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-50-S model."""
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), stem_width=64, stem_type='deep')
    return _create_resnet('resnet50s', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnet101c(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-101-C model."""
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), stem_width=32, stem_type='deep')
    return _create_resnet('resnet101c', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnet101s(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-101-S model."""
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), stem_width=64, stem_type='deep')
    return _create_resnet('resnet101s', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnet152c(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-152-C model."""
    model_args = dict(block=Bottleneck, layers=(3, 8, 36, 3), stem_width=32, stem_type='deep')
    return _create_resnet('resnet152c', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnet152s(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-152-S model."""
    model_args = dict(block=Bottleneck, layers=(3, 8, 36, 3), stem_width=64, stem_type='deep')
    return _create_resnet('resnet152s', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnet50_gn(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-50 model w/ GroupNorm"""
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), norm_layer='groupnorm')
    return _create_resnet('resnet50_gn', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnext101_32x32d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNeXt-101 32x32d model"""
    model_args = dict(block=Bottleneck, layers=(3, 4, 23, 3), cardinality=32, base_width=32)
    return _create_resnet('resnext101_32x32d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnet50d_pruned(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-50-D model pruned with eca."""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 6, 3), stem_width=32, stem_type='deep', avg_down=True,
        block_args=dict(attn_layer='eca'))
    return _create_resnet('ecaresnet50d_pruned', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnet101d_pruned(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-101-D model pruned with eca."""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 23, 3), stem_width=32, stem_type='deep', avg_down=True,
        block_args=dict(attn_layer='eca'))
    return _create_resnet('ecaresnet101d_pruned', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnet200d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-200-D model with ECA."""
    model_args = dict(
        block=Bottleneck, layers=(3, 24, 36, 3), stem_width=32, stem_type='deep', avg_down=True,
        block_args=dict(attn_layer='eca'))
    return _create_resnet('ecaresnet200d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnet269d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-269-D model with ECA."""
    model_args = dict(
        block=Bottleneck, layers=(3, 30, 48, 8), stem_width=32, stem_type='deep', avg_down=True,
        block_args=dict(attn_layer='eca'))
    return _create_resnet('ecaresnet269d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnext26t_32x4d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs an ECA-ResNeXt-26-T model."""
    model_args = dict(
        block=Bottleneck, layers=(2, 2, 2, 2), cardinality=32, base_width=4, stem_width=32,
        stem_type='deep_tiered', avg_down=True, block_args=dict(attn_layer='eca'))
    return _create_resnet('ecaresnext26t_32x4d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def ecaresnext50t_32x4d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs an ECA-ResNeXt-50-T model."""
    model_args = dict(
        block=Bottleneck, layers=(2, 2, 2, 2), cardinality=32, base_width=4, stem_width=32,
        stem_type='deep_tiered', avg_down=True, block_args=dict(attn_layer='eca'))
    return _create_resnet('ecaresnext50t_32x4d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def seresnet18(pretrained: bool = False, **kwargs) -> ResNet:
    model_args = dict(block=BasicBlock, layers=(2, 2, 2, 2), block_args=dict(attn_layer='se'))
    return _create_resnet('seresnet18', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def seresnet152d(pretrained: bool = False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(3, 8, 36, 3), stem_width=32, stem_type='deep',
        avg_down=True, block_args=dict(attn_layer='se'))
    return _create_resnet('seresnet152d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def seresnet200d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-200-D model with SE attn."""
    model_args = dict(
        block=Bottleneck, layers=(3, 24, 36, 3), stem_width=32, stem_type='deep',
        avg_down=True, block_args=dict(attn_layer='se'))
    return _create_resnet('seresnet200d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def seresnet269d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-269-D model with SE attn."""
    model_args = dict(
        block=Bottleneck, layers=(3, 30, 48, 8), stem_width=32, stem_type='deep',
        avg_down=True, block_args=dict(attn_layer='se'))
    return _create_resnet('seresnet269d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def seresnext101d_32x8d(pretrained: bool = False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 23, 3), cardinality=32, base_width=8,
        stem_width=32, stem_type='deep', avg_down=True,
        block_args=dict(attn_layer='se'))
    return _create_resnet('seresnext101d_32x8d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def senet154(pretrained: bool = False, **kwargs) -> ResNet:
    model_args = dict(
        block=Bottleneck, layers=(3, 8, 36, 3), cardinality=64, base_width=4, stem_type='deep',
        down_kernel_size=3, block_reduce_first=2, block_args=dict(attn_layer='se'))
    return _create_resnet('senet154', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetblur18(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-18 model with blur anti-aliasing"""
    model_args = dict(block=BasicBlock, layers=(2, 2, 2, 2), aa_layer=BlurPool2d)
    return _create_resnet('resnetblur18', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetblur50(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-50 model with blur anti-aliasing"""
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), aa_layer=BlurPool2d)
    return _create_resnet('resnetblur50', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetblur50d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-50-D model with blur anti-aliasing"""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 6, 3), aa_layer=BlurPool2d,
        stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnetblur50d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetblur101d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-101-D model with blur anti-aliasing"""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 23, 3), aa_layer=BlurPool2d,
        stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnetblur101d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetaa34d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-34-D model w/ avgpool anti-aliasing"""
    model_args = dict(
        block=BasicBlock, layers=(3, 4, 6, 3),  aa_layer=AvgPool2dAA, stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnetaa34d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetaa50(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-50 model with avgpool anti-aliasing"""
    model_args = dict(block=Bottleneck, layers=(3, 4, 6, 3), aa_layer=AvgPool2dAA)
    return _create_resnet('resnetaa50', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetaa50d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-50-D model with avgpool anti-aliasing"""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 6, 3), aa_layer=AvgPool2dAA,
        stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnetaa50d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetaa101d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-101-D model with avgpool anti-aliasing"""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 23, 3), aa_layer=AvgPool2dAA,
        stem_width=32, stem_type='deep', avg_down=True)
    return _create_resnet('resnetaa101d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def seresnetaa50d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a SE=ResNet-50-D model with avgpool anti-aliasing"""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 6, 3), aa_layer=AvgPool2dAA,
        stem_width=32, stem_type='deep', avg_down=True, block_args=dict(attn_layer='se'))
    return _create_resnet('seresnetaa50d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def seresnextaa101d_32x8d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a SE=ResNeXt-101-D 32x8d model with avgpool anti-aliasing"""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 23, 3), cardinality=32, base_width=8,
        stem_width=32, stem_type='deep', avg_down=True, aa_layer=AvgPool2dAA,
        block_args=dict(attn_layer='se'))
    return _create_resnet('seresnextaa101d_32x8d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def seresnextaa201d_32x8d(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a SE=ResNeXt-101-D 32x8d model with avgpool anti-aliasing"""
    model_args = dict(
        block=Bottleneck, layers=(3, 24, 36, 4), cardinality=32, base_width=8,
        stem_width=64, stem_type='deep', avg_down=True, aa_layer=AvgPool2dAA,
        block_args=dict(attn_layer='se'))
    return _create_resnet('seresnextaa201d_32x8d', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetrs50(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-RS-50 model."""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 6, 3), stem_width=32, stem_type='deep', replace_stem_pool=True,
        avg_down=True,  block_args=dict(attn_layer=partial(get_attn('se'), rd_ratio=0.25)))
    return _create_resnet('resnetrs50', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetrs101(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-RS-101 model."""
    model_args = dict(
        block=Bottleneck, layers=(3, 4, 23, 3), stem_width=32, stem_type='deep', replace_stem_pool=True,
        avg_down=True,  block_args=dict(attn_layer=partial(get_attn('se'), rd_ratio=0.25)))
    return _create_resnet('resnetrs101', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetrs152(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-RS-152 model."""
    model_args = dict(
        block=Bottleneck, layers=(3, 8, 36, 3), stem_width=32, stem_type='deep', replace_stem_pool=True,
        avg_down=True,  block_args=dict(attn_layer=partial(get_attn('se'), rd_ratio=0.25)))
    return _create_resnet('resnetrs152', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetrs200(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-RS-200 model."""
    model_args = dict(
        block=Bottleneck, layers=(3, 24, 36, 3), stem_width=32, stem_type='deep', replace_stem_pool=True,
        avg_down=True,  block_args=dict(attn_layer=partial(get_attn('se'), rd_ratio=0.25)))
    return _create_resnet('resnetrs200', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetrs270(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-RS-270 model."""
    model_args = dict(
        block=Bottleneck, layers=(4, 29, 53, 4), stem_width=32, stem_type='deep', replace_stem_pool=True,
        avg_down=True,  block_args=dict(attn_layer=partial(get_attn('se'), rd_ratio=0.25)))
    return _create_resnet('resnetrs270', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetrs350(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-RS-350 model."""
    model_args = dict(
        block=Bottleneck, layers=(4, 36, 72, 4), stem_width=32, stem_type='deep', replace_stem_pool=True,
        avg_down=True,  block_args=dict(attn_layer=partial(get_attn('se'), rd_ratio=0.25)))
    return _create_resnet('resnetrs350', pretrained=pretrained, **dict(model_args, **kwargs))


@register_model
def resnetrs420(pretrained: bool = False, **kwargs) -> ResNet:
    """Constructs a ResNet-RS-420 model"""
    model_args = dict(
        block=Bottleneck, layers=(4, 44, 87, 4), stem_width=32, stem_type='deep', replace_stem_pool=True,
        avg_down=True,  block_args=dict(attn_layer=partial(get_attn('se'), rd_ratio=0.25)))
    return _create_resnet('resnetrs420', pretrained=pretrained, **dict(model_args, **kwargs))
