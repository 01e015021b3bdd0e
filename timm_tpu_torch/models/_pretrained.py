"""Pretrained weight/config metadata (copy of timm_tpu/models/_pretrained.py;
there is no hub in the port)."""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

__all__ = ['PretrainedCfg', 'DefaultCfg', 'filter_pretrained_cfg']


@dataclass
class PretrainedCfg:
    """Describes a pretrained weight source + input/preproc metadata."""
    # weight source
    url: Optional[Union[str, Tuple[str, str]]] = None
    file: Optional[str] = None
    state_dict: Optional[Dict[str, Any]] = None
    hf_hub_id: Optional[str] = None
    hf_hub_filename: Optional[str] = None

    source: Optional[str] = None
    architecture: Optional[str] = None
    tag: Optional[str] = None
    custom_load: bool = False

    # input / data config
    input_size: Tuple[int, int, int] = (3, 224, 224)
    test_input_size: Optional[Tuple[int, int, int]] = None
    min_input_size: Optional[Tuple[int, int, int]] = None
    fixed_input_size: bool = False
    interpolation: str = 'bicubic'
    crop_pct: float = 0.875
    test_crop_pct: Optional[float] = None
    crop_mode: str = 'center'
    mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    std: Tuple[float, ...] = (0.229, 0.224, 0.225)

    # head / arch metadata
    num_classes: int = 1000
    label_offset: Optional[int] = None
    label_names: Optional[Tuple[str]] = None
    label_descriptions: Optional[Dict[str, str]] = None
    pool_size: Optional[Tuple[int, ...]] = None
    test_pool_size: Optional[Tuple[int, ...]] = None
    first_conv: Optional[Union[str, Tuple[str, ...]]] = None
    classifier: Optional[Union[str, Tuple[str, ...]]] = None

    license: Optional[str] = None
    description: Optional[str] = None
    origin_url: Optional[str] = None
    paper_name: Optional[str] = None
    paper_ids: Optional[Union[str, Tuple[str]]] = None
    notes: Optional[Tuple[str]] = None

    @property
    def has_weights(self) -> bool:
        return bool(self.url or self.file or self.hf_hub_id or self.state_dict is not None)

    def to_dict(self, remove_source: bool = False, remove_null: bool = True) -> Dict[str, Any]:
        return filter_pretrained_cfg(asdict(self), remove_source=remove_source, remove_null=remove_null)


def filter_pretrained_cfg(cfg: Dict[str, Any], remove_source: bool = False, remove_null: bool = True):
    filtered = {}
    keep_null = {'pool_size', 'first_conv', 'classifier'}
    for k, v in cfg.items():
        if remove_source and k in {'url', 'file', 'hf_hub_id', 'hf_hub_filename', 'state_dict'}:
            continue
        if remove_null and v is None and k not in keep_null:
            continue
        filtered[k] = v
    return filtered


@dataclass
class DefaultCfg:
    """Tag-priority container; the first tag is the default."""
    tags: list = field(default_factory=list)
    cfgs: Dict[str, PretrainedCfg] = field(default_factory=dict)
    is_pretrained: bool = False

    @property
    def default(self) -> PretrainedCfg:
        return self.cfgs[self.tags[0]]

    @property
    def default_with_tag(self) -> Tuple[str, PretrainedCfg]:
        tag = self.tags[0]
        return tag, self.cfgs[tag]
