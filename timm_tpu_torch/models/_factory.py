"""``create_model`` public entry (counterpart of timm_tpu/models/_factory.py)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

from ._pretrained import PretrainedCfg
from ._registry import is_model, model_entrypoint, split_model_name_tag

__all__ = ['create_model']


def create_model(
        model_name: str,
        pretrained: bool = False,
        pretrained_cfg: Optional[Union[str, Dict[str, Any], PretrainedCfg]] = None,
        pretrained_cfg_overlay: Optional[Dict[str, Any]] = None,
        **kwargs,
):
    """Create a model by registry name. ``device`` (default ``cuda``),
    ``dtype`` (compute dtype, default fp32) and ``seed`` (weight init) pass
    through to the model builder; other kwargs go to the model class."""
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    model_name, pretrained_tag = split_model_name_tag(model_name)
    if pretrained_tag and not pretrained_cfg:
        pretrained_cfg = pretrained_tag
    if not is_model(model_name):
        raise RuntimeError(f'Unknown model ({model_name})')
    return model_entrypoint(model_name)(
        pretrained=pretrained,
        pretrained_cfg=pretrained_cfg,
        pretrained_cfg_overlay=pretrained_cfg_overlay,
        **kwargs,
    )
