"""Data config resolution (copy of timm_tpu/data/config.py), read from a
model's ``PretrainedCfg`` (models/_pretrained.py)."""
from __future__ import annotations

import logging

from .constants import (
    DEFAULT_CROP_MODE, DEFAULT_CROP_PCT, IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD,
)

_logger = logging.getLogger(__name__)

__all__ = ['resolve_data_config', 'resolve_model_data_config']


def resolve_data_config(
        args=None,
        pretrained_cfg=None,
        model=None,
        use_test_size: bool = False,
        verbose: bool = False,
):
    """Merge CLI args > model pretrained_cfg > defaults (reference config.py:8)."""
    args = args or {}
    pretrained_cfg = pretrained_cfg or {}
    if not pretrained_cfg and model is not None and hasattr(model, 'pretrained_cfg'):
        pc = model.pretrained_cfg
        pretrained_cfg = pc.to_dict() if hasattr(pc, 'to_dict') else dict(pc)

    data_config = {}

    # input size
    in_chans = 3
    if args.get('in_chans') is not None:
        in_chans = args['in_chans']
    elif args.get('chans') is not None:
        in_chans = args['chans']
    input_size = (in_chans, 224, 224)
    if args.get('input_size') is not None:
        assert len(args['input_size']) == 3
        input_size = tuple(args['input_size'])
        in_chans = input_size[0]
    elif args.get('img_size') is not None:
        assert isinstance(args['img_size'], int)
        input_size = (in_chans, args['img_size'], args['img_size'])
    else:
        if use_test_size and pretrained_cfg.get('test_input_size'):
            input_size = pretrained_cfg['test_input_size']
        elif pretrained_cfg.get('input_size'):
            input_size = pretrained_cfg['input_size']
    data_config['input_size'] = tuple(input_size)

    # interpolation / mean / std
    data_config['interpolation'] = args.get('interpolation') or pretrained_cfg.get('interpolation', 'bicubic')
    data_config['mean'] = tuple(args.get('mean') or pretrained_cfg.get('mean', IMAGENET_DEFAULT_MEAN))
    data_config['std'] = tuple(args.get('std') or pretrained_cfg.get('std', IMAGENET_DEFAULT_STD))
    if args.get('mean') is not None:
        mean = tuple(args['mean'])
        if len(mean) == 1:
            mean = mean * in_chans
        data_config['mean'] = mean
    if args.get('std') is not None:
        std = tuple(args['std'])
        if len(std) == 1:
            std = std * in_chans
        data_config['std'] = std

    # crop
    crop_pct = DEFAULT_CROP_PCT
    if args.get('crop_pct'):
        crop_pct = args['crop_pct']
    else:
        if use_test_size and pretrained_cfg.get('test_crop_pct'):
            crop_pct = pretrained_cfg['test_crop_pct']
        elif pretrained_cfg.get('crop_pct'):
            crop_pct = pretrained_cfg['crop_pct']
    data_config['crop_pct'] = crop_pct
    data_config['crop_mode'] = args.get('crop_mode') or pretrained_cfg.get('crop_mode', DEFAULT_CROP_MODE)

    if verbose:
        _logger.info('Data processing configuration for current model + dataset:')
        for n, v in data_config.items():
            _logger.info(f'\t{n}: {str(v)}')
    return data_config


def resolve_model_data_config(model, args=None, pretrained_cfg=None, use_test_size=False, verbose=False):
    return resolve_data_config(
        args=args, pretrained_cfg=pretrained_cfg, model=model,
        use_test_size=use_test_size, verbose=verbose)
