"""Model registry (counterpart of timm_tpu/models/_registry.py).

``@register_model`` on entrypoint functions, ``arch.tag`` pretrained tags and
fnmatch-based ``list_models``, as in the JAX package.
"""
from __future__ import annotations

import fnmatch
import re
import sys
from collections import defaultdict
from copy import deepcopy
from dataclasses import replace
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple, Union

from ._pretrained import DefaultCfg, PretrainedCfg

__all__ = [
    'register_model', 'generate_default_cfgs', 'list_models', 'is_model',
    'model_entrypoint', 'get_pretrained_cfg', 'split_model_name_tag', 'get_arch_name',
]

_module_to_models: Dict[str, Set[str]] = defaultdict(set)
_model_to_module: Dict[str, str] = {}
_model_entrypoints: Dict[str, Callable[..., Any]] = {}
_model_has_pretrained: Set[str] = set()
_model_default_cfgs: Dict[str, DefaultCfg] = {}
_model_pretrained_cfgs: Dict[str, PretrainedCfg] = {}
_model_with_tags: Dict[str, List[str]] = defaultdict(list)


def split_model_name_tag(model_name: str, no_tag: str = '') -> Tuple[str, str]:
    model_name, *tag_list = model_name.split('.', 1)
    tag = tag_list[0] if tag_list else no_tag
    return model_name, tag


def get_arch_name(model_name: str) -> str:
    return split_model_name_tag(model_name)[0]


def generate_default_cfgs(cfgs: Dict[str, Union[Dict[str, Any], PretrainedCfg]]) -> Dict[str, DefaultCfg]:
    out = defaultdict(DefaultCfg)
    default_set = set()  # archs with a default (first or explicitly-starred) tag

    for k, v in cfgs.items():
        if isinstance(v, dict):
            v = PretrainedCfg(**v)
        has_weights = v.has_weights
        model, tag = split_model_name_tag(k)
        is_default_set = model in default_set
        priority = (has_weights and not tag) or (tag.endswith('*') and not is_default_set)
        tag = tag.strip('*')
        default_cfg = out[model]
        if priority:
            default_cfg.tags.insert(0, tag)
            default_set.add(model)
        elif has_weights and not default_cfg.is_pretrained:
            default_cfg.tags.insert(0, tag)
        else:
            default_cfg.tags.append(tag)
        if has_weights:
            default_cfg.is_pretrained = True
        default_cfg.cfgs[tag] = v

    return dict(out)


def register_model(fn: Callable) -> Callable:
    mod = sys.modules[fn.__module__]
    module_name = fn.__module__.split('.')[-1]
    model_name = fn.__name__

    if hasattr(mod, '__all__'):
        mod.__all__.append(model_name)
    else:
        mod.__all__ = [model_name]

    _model_entrypoints[model_name] = fn
    _model_to_module[model_name] = module_name
    _module_to_models[module_name].add(model_name)

    default_cfg = getattr(mod, 'default_cfgs', {}).get(model_name, None)
    if default_cfg is not None:
        if not isinstance(default_cfg, DefaultCfg):
            default_cfg = DefaultCfg(tags=[''], cfgs={'': PretrainedCfg(**default_cfg)})
        for tag_idx, tag in enumerate(default_cfg.tags):
            is_default = tag_idx == 0
            pretrained_cfg = default_cfg.cfgs[tag]
            model_name_tag = '.'.join([model_name, tag]) if tag else model_name
            pretrained_cfg = replace(pretrained_cfg, architecture=model_name, tag=tag if tag else None)
            if is_default:
                _model_pretrained_cfgs[model_name] = pretrained_cfg
                if pretrained_cfg.has_weights:
                    _model_has_pretrained.add(model_name)
            if tag:
                _model_pretrained_cfgs[model_name_tag] = pretrained_cfg
                if pretrained_cfg.has_weights:
                    _model_has_pretrained.add(model_name_tag)
                _model_with_tags[model_name].append(model_name_tag)
            else:
                _model_with_tags[model_name].append(model_name)
        _model_default_cfgs[model_name] = default_cfg
    return fn


def _natural_key(string_: str) -> List[Union[int, str]]:
    return [int(s) if s.isdigit() else s for s in re.split(r'(\d+)', string_.lower())]


def _expand_filter(filter_: str) -> List[str]:
    filter_base, filter_tag = split_model_name_tag(filter_)
    if not filter_tag:
        return ['.'.join([filter_base, '*']), filter_]
    return [filter_]


def list_models(
        filter: Union[str, List[str]] = '',
        module: Union[str, List[str]] = '',
        pretrained: bool = False,
        exclude_filters: Union[str, List[str]] = '',
        include_tags: Optional[bool] = None,
) -> List[str]:
    include_filters = (filter if isinstance(filter, (tuple, list)) else [filter]) if filter else []
    include_tags = pretrained if include_tags is None else include_tags

    if not module:
        all_models: Iterable[str] = _model_entrypoints.keys()
    else:
        selected: Set[str] = set()
        for m in ([module] if isinstance(module, str) else module):
            selected.update(_module_to_models[m])
        all_models = selected

    if include_tags:
        with_tags: Set[str] = set()
        for m in all_models:
            with_tags.update(_model_with_tags[m])
        all_models = list(with_tags)
        include_filters = [ef for f in include_filters for ef in _expand_filter(f)]
        if exclude_filters:
            excl = [exclude_filters] if isinstance(exclude_filters, str) else exclude_filters
            exclude_filters = [ef for f in excl for ef in _expand_filter(f)]

    if include_filters:
        models: Set[str] = set()
        for f in include_filters:
            models.update(fnmatch.filter(all_models, f))
    else:
        models = set(all_models)

    if exclude_filters:
        for xf in ([exclude_filters] if isinstance(exclude_filters, str) else exclude_filters):
            models = models.difference(fnmatch.filter(models, xf))

    if pretrained:
        models = _model_has_pretrained.intersection(models)
    return sorted(models, key=_natural_key)


def is_model(model_name: str) -> bool:
    return get_arch_name(model_name) in _model_entrypoints


def model_entrypoint(model_name: str) -> Callable[..., Any]:
    arch_name = get_arch_name(model_name)
    if arch_name not in _model_entrypoints:
        raise RuntimeError(f'Unknown model ({model_name})')
    return _model_entrypoints[arch_name]


def get_pretrained_cfg(model_name: str, allow_unregistered: bool = True) -> Optional[PretrainedCfg]:
    if model_name in _model_pretrained_cfgs:
        return deepcopy(_model_pretrained_cfgs[model_name])
    arch_name, tag = split_model_name_tag(model_name)
    if arch_name in _model_default_cfgs:
        raise RuntimeError(f'Invalid pretrained tag ({tag}) for {arch_name}.')
    if allow_unregistered:
        return None
    raise RuntimeError(f'Model architecture ({arch_name}) has no pretrained cfg registered.')
