"""Dataset factory (counterpart of timm_tpu/data/dataset_factory.py) for
folders of class folders. Every other scheme (hfds/, wds/, tfds/, hfids/,
torch/, tar files) raises until its reader is ported (ROADMAP A.5)."""
from __future__ import annotations

import os
from typing import Optional

from .dataset import ImageDataset

__all__ = ['create_dataset']


def _search_split(root: str, split: str) -> str:
    split_name = split.split('[')[0]
    try_root = os.path.join(root, split_name)
    if os.path.exists(try_root):
        return try_root

    def _try(syn):
        p = os.path.join(root, syn)
        return p if os.path.exists(p) else None
    if split_name in ('validation', 'val'):
        for syn in ('val', 'validation', 'eval', 'test'):
            p = _try(syn)
            if p:
                return p
    if split_name == 'train':
        p = _try('training')
        if p:
            return p
    return root


def create_dataset(
        name: str = '',
        root: Optional[str] = None,
        split: str = 'validation',
        search_split: bool = True,
        class_map=None,
        is_training: bool = False,
        num_classes: Optional[int] = None,
        input_img_mode: str = 'RGB',
        **kwargs,
):
    """An ``ImageDataset`` over the folder ``root`` (its ``split``
    subfolder when there is one); ``name`` is '' or 'folder'."""
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    name = name or ''
    if name not in ('', 'folder') or (root and str(root).endswith('.tar')):
        raise NotImplementedError(
            f'dataset {name or root!r}: only folders of class folders are ported '
            '(the other readers wait, ROADMAP A.5)')
    if search_split and root and os.path.isdir(root):
        root = _search_split(root, split)
    return ImageDataset(
        root, split=split, class_map=class_map or '', input_img_mode=input_img_mode, **kwargs)
