"""Map-style image dataset and AugMix's split dataset (counterparts of
``ImageDataset`` and ``AugMixDataset`` in timm_tpu/data/dataset.py). The
iterable dataset waits with the streaming readers (ROADMAP A.5.4)."""
from __future__ import annotations

import logging
from typing import Callable, Optional

from PIL import Image

from .readers import create_reader

_logger = logging.getLogger(__name__)

__all__ = ['AugMixDataset', 'ImageDataset']


class ImageDataset:
    def __init__(
            self,
            root: str,
            reader=None,
            split: str = 'train',
            class_map='',
            input_img_mode: str = 'RGB',
            transform: Optional[Callable] = None,
            target_transform: Optional[Callable] = None,
            **kwargs,
    ):
        if reader is None or isinstance(reader, str):
            reader = create_reader(reader or '', root=root, split=split, class_map=class_map)
        self.reader = reader
        self.input_img_mode = input_img_mode
        self.transform = transform
        self.target_transform = target_transform
        self._consecutive_errors = 0

    def __getitem__(self, index: int):
        f, target = self.reader[index]
        try:
            with f:  # the reader opens the file; it is closed once decoded
                img = Image.open(f)
                img.load()
            self._consecutive_errors = 0
        except Exception as e:
            _logger.warning(f'Skipped sample (index {index}, file {self.reader.filename(index)}). {str(e)}')
            self._consecutive_errors += 1
            if self._consecutive_errors < 50:
                return self[(index + 1) % len(self.reader)]
            raise e
        if self.input_img_mode and img.mode != self.input_img_mode:
            img = img.convert(self.input_img_mode)
        if self.transform is not None:
            img = self.transform(img)
        if target is None:
            target = -1
        elif self.target_transform is not None:
            target = self.target_transform(target)
        return img, target

    def __len__(self):
        return len(self.reader)

    def filename(self, index, basename=False, absolute=False):
        return self.reader.filename(index, basename, absolute)

    def filenames(self, basename=False, absolute=False):
        return self.reader.filenames(basename, absolute)


class AugMixDataset:
    """(clean, aug1, ..., aug(N-1)) tuples of one sample for AugMix / JSD
    training: every split shares the dataset's primary transform; the
    secondary (the AugMix op) makes each augmented split, and the final
    transform ends every split. Set ``transform`` to the three pipelines of
    ``create_transform(..., separate=True)``."""

    def __init__(self, dataset: ImageDataset, num_splits: int = 2):
        self.dataset = dataset
        self.num_splits = num_splits
        self.augmentation = None
        self.normalize = None

    def _set_transforms(self, x):
        assert isinstance(x, (list, tuple)) and len(x) == 3
        self.dataset.transform = x[0]
        self.augmentation = x[1]
        self.normalize = x[2]

    @property
    def transform(self):
        return self.dataset.transform

    @transform.setter
    def transform(self, x):
        self._set_transforms(x)

    def _normalize(self, x):
        return x if self.normalize is None else self.normalize(x)

    def __getitem__(self, i):
        x, y = self.dataset[i]  # every split shares the primary transform's image
        x_list = [self._normalize(x)]
        for _ in range(self.num_splits - 1):
            x_list.append(self._normalize(self.augmentation(x)))
        return tuple(x_list), y

    def __len__(self):
        return len(self.dataset)
