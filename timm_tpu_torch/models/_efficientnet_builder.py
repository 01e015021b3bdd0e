"""EfficientNet arch-string decoder and stage builder (counterpart of
timm_tpu/models/_efficientnet_builder.py).

The block-string language of timm: 'ir_r4_k3_s2_e6_c128_se0.25' decodes to
4 repeats of an InvertedResidual, kernel 3, stride 2, expansion 6, 128
output channels, SE ratio 0.25. The builder turns the decoded stages into
blocks with the per-block drop-path rate ``drop_path_rate * i / n`` over
the n blocks, the output-stride to dilation conversion and the
space-to-depth region, as JAX's does.
"""
from __future__ import annotations

import inspect
import math
import re
from copy import deepcopy
from functools import partial
from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn

from ..layers import BatchNormAct2d, SqueezeExcite, get_aa_layer, make_divisible
from ._efficientnet_blocks import (
    CondConvResidual, ConvBnAct, DepthwiseSeparableConv, EdgeResidual, InvertedResidual,
    MobileAttention, UniversalInvertedResidual, _no_aa,
)

__all__ = ['BN_EPS_TF_DEFAULT', 'BN_MOMENTUM_TF_DEFAULT', 'EfficientNetBuilder', 'decode_arch_def',
           'resolve_act_layer', 'resolve_bn_args', 'round_channels']

BN_MOMENTUM_TF_DEFAULT = 1 - 0.99
BN_EPS_TF_DEFAULT = 1e-3


def resolve_bn_args(kwargs):
    bn_args = {}
    if kwargs.pop('bn_tf', False):
        bn_args = dict(momentum=BN_MOMENTUM_TF_DEFAULT, eps=BN_EPS_TF_DEFAULT)
    bn_momentum = kwargs.pop('bn_momentum', None)
    if bn_momentum is not None:
        bn_args['momentum'] = bn_momentum
    bn_eps = kwargs.pop('bn_eps', None)
    if bn_eps is not None:
        bn_args['eps'] = bn_eps
    return bn_args


def resolve_act_layer(kwargs, default='relu'):
    return kwargs.pop('act_layer', default) or default


def round_channels(channels, multiplier: float = 1.0, divisor: int = 8, channel_min=None,
                   round_limit: float = 0.9):
    if not multiplier:
        return channels
    return make_divisible(channels * multiplier, divisor, channel_min, round_limit=round_limit)


def _parse_ksize(ss: str):
    if ss.isdigit():
        return int(ss)
    return [int(k) for k in ss.split('.')]  # mixed kernels (MixNet) stay a list


# activation abbreviations of the block strings
_ACT_ABBREV = {'re': 'relu', 'r6': 'relu6', 'hs': 'hard_swish', 'sw': 'swish', 'mi': 'mish',
               'ge': 'gelu', 'si': 'silu'}


def _decode_block_str(block_str: str):
    """One block string -> (its keyword arguments, its repeat count)."""
    assert isinstance(block_str, str)
    ops = block_str.split('_')
    block_type = ops[0]
    options: Dict[str, str] = {}
    skip = None
    for op in ops[1:]:
        if op == 'noskip':
            skip = False
        elif op == 'skip':
            skip = True
        elif op.startswith('n'):
            options['n'] = op[1:]
        else:
            splits = re.split(r'(\d.*)', op)
            if len(splits) >= 2:
                key, value = splits[:2]
                options[key] = value

    act_layer = options.get('n', None)
    if act_layer is not None:
        act_layer = _ACT_ABBREV.get(act_layer, act_layer)
    start_kwargs = dict(block_type=block_type, out_chs=int(options['c']),
                        stride=int(options.get('s', 1)), act_layer=act_layer)
    num_repeat = int(options.get('r', 1))

    if block_type == 'ir':
        start_kwargs.update(dict(
            dw_kernel_size=_parse_ksize(options['k']),
            exp_kernel_size=_parse_ksize(options.get('a', '1')),
            pw_kernel_size=_parse_ksize(options.get('p', '1')),
            exp_ratio=float(options.get('e', 1.0)),
            se_ratio=float(options.get('se', 0.0)),
            noskip=skip is False,
            s2d=int(options.get('d', 0)) > 0,
        ))
        if 'cc' in options:
            start_kwargs['num_experts'] = int(options['cc'])
    elif block_type in ('ds', 'dsa'):
        start_kwargs.update(dict(
            dw_kernel_size=_parse_ksize(options['k']),
            pw_kernel_size=_parse_ksize(options.get('p', '1')),
            se_ratio=float(options.get('se', 0.0)),
            pw_act=block_type == 'dsa',
            noskip=block_type == 'dsa' or skip is False,
            s2d=int(options.get('d', 0)) > 0,
        ))
    elif block_type == 'er':
        start_kwargs.update(dict(
            exp_kernel_size=_parse_ksize(options['k']),
            pw_kernel_size=_parse_ksize(options.get('p', '1')),
            exp_ratio=float(options.get('e', 1.0)),
            se_ratio=float(options.get('se', 0.0)),
            force_in_chs=int(options.get('fc', 0)),
            noskip=skip is False,
        ))
    elif block_type == 'cn':
        start_kwargs.update(dict(kernel_size=int(options['k']), skip=skip is True))
    elif block_type == 'uir':
        start_kwargs.update(dict(
            dw_kernel_size_start=_parse_ksize(options.get('a', '0')),
            dw_kernel_size_mid=_parse_ksize(options['k']),
            dw_kernel_size_end=_parse_ksize(options.get('p', '0')),
            exp_ratio=float(options.get('e', 1.0)),
            se_ratio=float(options.get('se', 0.0)),
            noskip=skip is False,
        ))
    elif block_type in ('mha', 'mqa'):
        kv_dim = int(options['d'])
        start_kwargs.update(dict(
            dw_kernel_size=_parse_ksize(options['k']), num_heads=int(options['h']),
            key_dim=kv_dim, value_dim=kv_dim, kv_stride=int(options.get('v', 1)),
            noskip=skip is False,
        ))
    else:
        raise AssertionError(f'Unknown block type ({block_type})')
    if 'gs' in options:
        start_kwargs['group_size'] = int(options['gs'])
    return start_kwargs, num_repeat


def _scale_stage_depth(stack_args, repeats, depth_multiplier=1.0, depth_trunc='ceil'):
    num_repeat = sum(repeats)
    if depth_trunc == 'round':
        num_repeat_scaled = max(1, round(num_repeat * depth_multiplier))
    else:
        num_repeat_scaled = int(math.ceil(num_repeat * depth_multiplier))
    repeats_scaled = []
    for r in repeats[::-1]:
        rs = max(1, round((r / num_repeat * num_repeat_scaled)))
        repeats_scaled.append(rs)
        num_repeat -= r
        num_repeat_scaled -= rs
    sa_scaled = []
    for ba, rep in zip(stack_args, repeats_scaled[::-1]):
        sa_scaled.extend([deepcopy(ba) for _ in range(rep)])
    return sa_scaled


def decode_arch_def(arch_def: List[List[str]], depth_multiplier: Union[float, tuple] = 1.0,
                    depth_trunc: str = 'ceil', experts_multiplier: int = 1,
                    fix_first_last: bool = False, group_size=None):
    arch_args = []
    if isinstance(depth_multiplier, tuple):
        assert len(depth_multiplier) == len(arch_def)
    else:
        depth_multiplier = (depth_multiplier,) * len(arch_def)
    for stack_idx, (block_strings, multiplier) in enumerate(zip(arch_def, depth_multiplier)):
        assert isinstance(block_strings, list)
        stack_args, repeats = [], []
        for block_str in block_strings:
            ba, rep = _decode_block_str(block_str)
            if ba.get('num_experts', 0) > 0 and experts_multiplier > 1:
                ba['num_experts'] *= experts_multiplier
            if group_size is not None:
                ba.setdefault('group_size', group_size)
            stack_args.append(ba)
            repeats.append(rep)
        if fix_first_last and (stack_idx == 0 or stack_idx == len(arch_def) - 1):
            arch_args.append(_scale_stage_depth(stack_args, repeats, 1.0, depth_trunc))
        else:
            arch_args.append(_scale_stage_depth(stack_args, repeats, multiplier, depth_trunc))
    return arch_args


class EfficientNetBuilder:
    """Builds the stages (``nn.Sequential`` of blocks) from decoded args."""

    def __init__(self, output_stride: int = 32, pad_type: str = '',
                 round_chs_fn: Callable = round_channels, se_from_exp: bool = False,
                 act_layer: Union[str, Callable] = 'relu', norm_layer: Callable = BatchNormAct2d,
                 aa_layer: Optional[Callable] = None, se_layer: Callable = SqueezeExcite,
                 drop_path_rate: float = 0.0, layer_scale_init_value: Optional[float] = None,
                 feature_location: str = '', dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        self.output_stride = output_stride
        self.pad_type = pad_type
        self.round_chs_fn = round_chs_fn
        self.se_from_exp = se_from_exp
        self.act_layer = act_layer
        self.norm_layer = norm_layer
        _no_aa(aa_layer)  # the blocks' anti-aliased strides are not ported
        self.aa_layer = get_aa_layer(aa_layer)
        self.se_layer = se_layer
        se_base = se_layer.func if isinstance(se_layer, partial) else se_layer
        try:
            se_params = inspect.signature(se_base.__init__).parameters
        except (TypeError, ValueError):
            se_params = {}
        se_bound = getattr(se_layer, 'keywords', {}) or {}
        self.se_has_ratio = 'rd_ratio' in se_params or 'rd_ratio' in se_bound
        self.se_plain_round = 'rd_round_fn' in se_params and 'rd_round_fn' not in se_bound
        self.drop_path_rate = drop_path_rate
        self.layer_scale_init_value = layer_scale_init_value
        self.dtype = dtype
        self.generator = generator
        self.in_chs = None
        self.features = []

    def _make_block(self, ba: Dict, block_idx: int, block_count: int) -> nn.Module:
        drop_path_rate = self.drop_path_rate * block_idx / block_count
        bt = ba.pop('block_type')
        ba['in_chs'] = self.in_chs
        ba['out_chs'] = self.round_chs_fn(ba['out_chs'])
        s2d = ba.get('s2d', 0)
        if s2d > 0:
            ba['out_chs'] *= 4  # the space-to-depth region's width
        if ba.get('force_in_chs'):
            ba['force_in_chs'] = self.round_chs_fn(ba['force_in_chs'])
        ba['pad_type'] = self.pad_type
        ba['act_layer'] = ba.pop('act_layer', None) or self.act_layer
        ba['norm_layer'] = self.norm_layer
        se_ratio = ba.pop('se_ratio', 0.0)
        se_layer = None
        if se_ratio > 0.0 and self.se_layer is not None:
            if not self.se_from_exp:
                se_ratio /= ba.get('exp_ratio', 1.0)
            if s2d == 1:
                se_ratio /= 4
            if self.se_plain_round:
                # the EfficientNet family's SE rounds plainly
                se_layer = partial(self.se_layer, rd_ratio=se_ratio, rd_round_fn=round)
            elif self.se_has_ratio:
                se_layer = partial(self.se_layer, rd_ratio=se_ratio)
            else:
                se_layer = self.se_layer
        common = dict(dtype=self.dtype, generator=self.generator)
        if bt == 'ir':
            ba.setdefault('s2d', 0)
            cls = CondConvResidual if ba.get('num_experts', 0) else InvertedResidual
            if not ba.get('num_experts', 0):
                ba.pop('num_experts', None)
            block = cls(drop_path_rate=drop_path_rate, se_layer=se_layer, **ba, **common)
        elif bt in ('ds', 'dsa'):
            ba.pop('exp_ratio', None)
            ba.pop('exp_kernel_size', None)
            block = DepthwiseSeparableConv(drop_path_rate=drop_path_rate, se_layer=se_layer, **ba,
                                           **common)
        elif bt == 'er':
            block = EdgeResidual(drop_path_rate=drop_path_rate, se_layer=se_layer, **ba, **common)
        elif bt == 'cn':
            block = ConvBnAct(drop_path_rate=drop_path_rate, **ba, **common)
        elif bt == 'uir':
            block = UniversalInvertedResidual()
        elif bt in ('mqa', 'mha'):
            block = MobileAttention()
        else:
            raise AssertionError(f'Unknown block type ({bt})')
        self.in_chs = ba['out_chs']
        return block

    def __call__(self, in_chs: int, model_block_args: List[List[Dict]]) -> List[nn.Sequential]:
        self.in_chs = in_chs
        total_block_count = sum(len(s) for s in model_block_args)
        block_idx = 0
        current_stride = 2  # after the stem
        current_dilation = 1
        stages = []
        self.features = []
        space2depth = 0
        for stack_idx, stack_args in enumerate(model_block_args):
            blocks = []
            for i, ba in enumerate(stack_args):
                ba = deepcopy(ba)
                if i > 0:
                    ba['stride'] = 1
                # the space-to-depth region's state machine
                if not space2depth and ba.pop('s2d', False):
                    assert ba.get('stride', 1) == 1
                    space2depth = 1
                if space2depth > 0:
                    if space2depth == 2 and ba.get('stride', 1) == 2:
                        ba['stride'] = 1
                        ba['exp_ratio'] /= 4  # the region ends: expansion relative to its input
                        space2depth = 0
                    else:
                        ba['s2d'] = space2depth
                # stride becomes dilation past the output stride
                next_dilation = current_dilation
                if ba.get('stride', 1) > 1:
                    next_output_stride = current_stride * ba['stride']
                    if next_output_stride > self.output_stride:
                        next_dilation = current_dilation * ba['stride']
                        ba['stride'] = 1
                    else:
                        current_stride = next_output_stride
                ba['dilation'] = current_dilation
                current_dilation = next_dilation
                blocks.append(self._make_block(ba, block_idx, total_block_count))
                block_idx += 1
                if space2depth == 1:
                    space2depth = 2
            stages.append(nn.Sequential(*blocks))
            self.features.append(dict(num_chs=self.in_chs, reduction=current_stride,
                                      module=f'blocks.{stack_idx}'))
        return stages
