"""Model construction from an entrypoint and its cfg (counterpart of
timm_tpu/models/_builder.py, reduced to what the ported models need).

Weights are drawn on the CPU from a ``torch.Generator`` seeded with ``seed``
and then moved to ``device``, so one seed gives the same weights on every
device. The drop-path and dropout masks of training mode draw from a second
generator on ``device``, seeded with ``seed`` too. ``device`` defaults to
``cuda``; ``device='meta'`` builds the module tree with shapes and no
storage (no draws, no drop generator), for callers that need shapes only.

``features_only=True`` wraps the model in ``FeatureGetterNet`` over its
``forward_intermediates`` (``_features.py``), with the entrypoint's
``feature_cfg`` (``out_indices``; a caller's ``out_indices`` and
``feature_cls`` override it), as the JAX builder does, for every family.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .._device import resolve_device
from ..layers.drop import set_drop_generator
from ._features import FeatureGetterNet
from ._pretrained import PretrainedCfg
from ._registry import get_pretrained_cfg

__all__ = ['build_model_with_cfg', 'resolve_pretrained_cfg']


def resolve_pretrained_cfg(variant: str, pretrained_cfg=None, pretrained_cfg_overlay=None) -> PretrainedCfg:
    model_with_tag = variant
    if isinstance(pretrained_cfg, dict):
        pretrained_cfg = PretrainedCfg(**pretrained_cfg)
    elif isinstance(pretrained_cfg, str):
        model_with_tag = '.'.join([variant, pretrained_cfg])
        pretrained_cfg = None
    if not pretrained_cfg:
        pretrained_cfg = get_pretrained_cfg(model_with_tag) or PretrainedCfg()
    overlay = dict(pretrained_cfg_overlay or {})
    if not pretrained_cfg.architecture:
        overlay.setdefault('architecture', variant)
    return dataclasses.replace(pretrained_cfg, **overlay)


def _update_default_model_kwargs(cfg: PretrainedCfg, kwargs: Dict) -> None:
    """Push cfg defaults (classes, channels, fixed input size) into the model kwargs."""
    if cfg.num_classes is not None:
        kwargs.setdefault('num_classes', cfg.num_classes)
    if cfg.input_size is not None:
        kwargs.setdefault('in_chans', cfg.input_size[0])
        if cfg.fixed_input_size:
            kwargs.setdefault('img_size', tuple(cfg.input_size[-2:]))


def build_model_with_cfg(
        model_cls: Callable,
        variant: str,
        pretrained: bool = False,
        pretrained_cfg=None,
        pretrained_cfg_overlay: Optional[Dict] = None,
        feature_cfg: Optional[Dict] = None,
        seed: int = 0,
        device=None,
        **kwargs,
):
    if pretrained:
        raise NotImplementedError(
            'the port has no hub: build the model, then carry weights from the JAX '
            'package with timm_tpu_torch.models.load_jax_state_dict')
    dev = resolve_device(device)
    cfg = resolve_pretrained_cfg(variant, pretrained_cfg, pretrained_cfg_overlay)
    _update_default_model_kwargs(cfg, kwargs)
    feature_cfg = dict(feature_cfg or {})
    features = kwargs.pop('features_only', False)
    if features:
        feature_cfg.setdefault('out_indices', (0, 1, 2, 3, 4))
        if 'out_indices' in kwargs:
            feature_cfg['out_indices'] = kwargs.pop('out_indices')
        if 'feature_cls' in kwargs:
            feature_cfg['feature_cls'] = kwargs.pop('feature_cls')
    if dev.type == 'meta':
        # shapes only (the counterpart of nnx.eval_shape): no storage, no draws
        with torch.device('meta'):
            model = model_cls(**kwargs)
    else:
        model = model_cls(generator=torch.Generator().manual_seed(int(seed)), **kwargs)
    model.pretrained_cfg = cfg
    model.default_cfg = cfg.to_dict()
    if features:
        model = FeatureGetterNet(model, **feature_cfg)
    if dev.type == 'meta':
        return model
    model = model.to(dev)
    return set_drop_generator(model, torch.Generator(device=dev).manual_seed(int(seed)))
