"""Random Erasing on numpy batches (copy of timm_tpu/data/random_erasing.py).

``__call__`` erases a host batch (HWC float images) in place;
``sample_params`` draws only the rectangles (and 'rand' fills) that the
device augment stage applies. With a seed, the streams are the JAX
package's, so both packages draw the same rectangles.
"""
from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np

__all__ = ['RandomErasing']


class RandomErasing:
    def __init__(
            self,
            probability: float = 0.5,
            min_area: float = 0.02,
            max_area: float = 1 / 3,
            min_aspect: float = 0.3,
            max_aspect=None,
            mode: str = 'const',
            min_count: int = 1,
            max_count=None,
            num_splits: int = 0,
            mean=None,
            std=None,
            seed: Optional[int] = None,
    ):
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.min_count = min_count
        self.max_count = max_count or min_count
        self.num_splits = num_splits
        self.mode = mode.lower()
        assert self.mode in ('const', 'rand', 'pixel')
        # fills are expressed in *normalized* space (the reference erases after
        # on-device normalization); since this runs on [0,1] images before the
        # device normalize, map them back: x01 = mean + std * normalized
        self.mean = np.asarray(mean if mean is not None else (0.0, 0.0, 0.0), np.float32)
        self.std = np.asarray(std if std is not None else (1.0, 1.0, 1.0), np.float32)
        # seed=None keeps the legacy global random/np.random streams (not
        # resume-safe); with a seed, set_epoch(e) re-derives the stream so a
        # resumed run replays identical erase rectangles
        self.seed = seed
        self._rng = np.random.default_rng(seed) if seed is not None else None

    def set_epoch(self, epoch: int):
        if self.seed is not None:
            self._rng = np.random.default_rng((self.seed, epoch))

    def _random(self):
        return self._rng.random() if self._rng is not None else random.random()

    def _uniform(self, a, b):
        return self._rng.uniform(a, b) if self._rng is not None else random.uniform(a, b)

    def _randint(self, a, b):
        """Inclusive [a, b] like random.randint."""
        return int(self._rng.integers(a, b, endpoint=True)) if self._rng is not None \
            else random.randint(a, b)

    def _randn(self, *shape):
        return (self._rng.standard_normal(shape).astype(np.float32) if self._rng is not None
                else np.random.randn(*shape).astype(np.float32))

    def _erase_one(self, img):
        h, w, c = img.shape
        area = h * w
        count = self.min_count if self.min_count == self.max_count else \
            self._randint(self.min_count, self.max_count)
        for _ in range(count):
            for _ in range(10):
                target_area = self._uniform(self.min_area, self.max_area) * area / count
                aspect_ratio = math.exp(self._uniform(*self.log_aspect_ratio))
                eh = int(round(math.sqrt(target_area * aspect_ratio)))
                ew = int(round(math.sqrt(target_area / aspect_ratio)))
                if ew < w and eh < h:
                    top = self._randint(0, h - eh)
                    left = self._randint(0, w - ew)
                    if self.mode == 'pixel':
                        noise = self._randn(eh, ew, c)
                        img[top:top + eh, left:left + ew] = (self.mean + self.std * noise).astype(img.dtype)
                    elif self.mode == 'rand':
                        noise = self._randn(1, 1, c)
                        img[top:top + eh, left:left + ew] = (self.mean + self.std * noise).astype(img.dtype)
                    else:
                        img[top:top + eh, left:left + ew] = self.mean.astype(img.dtype)
                    break
        return img

    def __call__(self, batch):
        """batch: (B, H, W, C) float ndarray, modified in place."""
        batch_start = batch.shape[0] // self.num_splits if self.num_splits > 1 else 0
        for i in range(batch_start, batch.shape[0]):
            if self._random() <= self.probability:
                self._erase_one(batch[i])
        return batch

    def sample_params(self, batch_shape):
        """Device-augment split: draw erase rectangles (and 'rand'-mode fill
        colors) without touching pixels, consuming the RNG stream in the same
        order as __call__ so a seeded run is bit-identical either way — except
        'pixel' mode, whose per-pixel noise the JAX package draws on its
        device (the port's device stage does not run 'pixel' mode).

        Returns {'erase_box': (B, K, 4) i32 as (top, left, eh, ew)} plus, for
        mode='rand', {'erase_fill': (B, K, C) f32} ([0,1]-space fill colors).
        K = max_count; unused slots are all-zero boxes (eh=ew=0 → no-op), so
        the pytree riding the batch is shape-stable."""
        b, h, w, c = (int(d) for d in batch_shape)
        k = self.max_count
        boxes = np.zeros((b, k, 4), dtype=np.int32)
        fill = np.zeros((b, k, c), dtype=np.float32) if self.mode == 'rand' else None
        area = h * w
        batch_start = b // self.num_splits if self.num_splits > 1 else 0
        for i in range(batch_start, b):
            if self._random() > self.probability:
                continue
            count = self.min_count if self.min_count == self.max_count else \
                self._randint(self.min_count, self.max_count)
            slot = 0
            for _ in range(count):
                for _ in range(10):
                    target_area = self._uniform(self.min_area, self.max_area) * area / count
                    aspect_ratio = math.exp(self._uniform(*self.log_aspect_ratio))
                    eh = int(round(math.sqrt(target_area * aspect_ratio)))
                    ew = int(round(math.sqrt(target_area / aspect_ratio)))
                    if ew < w and eh < h:
                        top = self._randint(0, h - eh)
                        left = self._randint(0, w - ew)
                        boxes[i, slot] = (top, left, eh, ew)
                        if self.mode == 'rand':
                            fill[i, slot] = self.mean + self.std * self._randn(c)
                        slot += 1
                        break
        out = {'erase_box': boxes}
        if fill is not None:
            out['erase_fill'] = fill
        return out
