"""Mixup / CutMix on host batches (copy of timm_tpu/data/mixup.py).

Operates on numpy (B, H, W, C) batches + int targets, emitting mixed images
and soft-target matrices, or (``sample_params``) only the per-row parameters
that the device augment stage applies. With a seed, ``set_epoch(e)`` draws
from ``np.random.default_rng((seed, e))`` exactly as the JAX package does,
so the two packages draw the same parameters.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ['Mixup', 'FastCollateMixup', 'mixup_target', 'rand_bbox']


def _randint(low, high, size=None, rng=None):
    """Half-open [low, high) integer draw from `rng` (np.random.Generator) or
    the legacy global np.random state when rng is None."""
    if rng is None:
        return np.random.randint(low, high, size=size)
    return rng.integers(low, high, size=size)


def one_hot(x, num_classes, on_value=1.0, off_value=0.0):
    out = np.full((x.shape[0], num_classes), off_value, dtype=np.float32)
    out[np.arange(x.shape[0]), x] = on_value
    return out


def mixup_target(target, num_classes, lam=1.0, smoothing=0.0):
    off_value = smoothing / num_classes
    on_value = 1.0 - smoothing + off_value
    y1 = one_hot(target, num_classes, on_value, off_value)
    y2 = one_hot(target[::-1], num_classes, on_value, off_value)
    return y1 * lam + y2 * (1.0 - lam)


def rand_bbox(img_shape, lam, margin=0.0, count=None, rng=None):
    """(reference mixup.py:40). `rng` is an optional np.random.Generator; when
    None the legacy global np.random stream is used (not resume-safe)."""
    ratio = np.sqrt(1 - lam)
    img_h, img_w = img_shape[-3:-1]
    cut_h, cut_w = int(img_h * ratio), int(img_w * ratio)
    margin_y, margin_x = int(margin * cut_h), int(margin * cut_w)
    cy = _randint(0 + margin_y, img_h - margin_y, size=count, rng=rng)
    cx = _randint(0 + margin_x, img_w - margin_x, size=count, rng=rng)
    yl = np.clip(cy - cut_h // 2, 0, img_h)
    yh = np.clip(cy + cut_h // 2, 0, img_h)
    xl = np.clip(cx - cut_w // 2, 0, img_w)
    xh = np.clip(cx + cut_w // 2, 0, img_w)
    return yl, yh, xl, xh


def rand_bbox_minmax(img_shape, minmax, count=None, rng=None):
    assert len(minmax) == 2
    img_h, img_w = img_shape[-3:-1]
    cut_h = _randint(int(img_h * minmax[0]), int(img_h * minmax[1]), size=count, rng=rng)
    cut_w = _randint(int(img_w * minmax[0]), int(img_w * minmax[1]), size=count, rng=rng)
    yl = _randint(0, img_h - cut_h, size=count, rng=rng)
    xl = _randint(0, img_w - cut_w, size=count, rng=rng)
    return yl, yl + cut_h, xl, xl + cut_w


def cutmix_bbox_and_lam(img_shape, lam, ratio_minmax=None, correct_lam=True, count=None,
                        rng=None):
    if ratio_minmax is not None:
        yl, yu, xl, xu = rand_bbox_minmax(img_shape, ratio_minmax, count=count, rng=rng)
    else:
        yl, yu, xl, xu = rand_bbox(img_shape, lam, count=count, rng=rng)
    if correct_lam or ratio_minmax is not None:
        bbox_area = (yu - yl) * (xu - xl)
        lam = 1.0 - bbox_area / float(img_shape[-3] * img_shape[-2])
    return (yl, yu, xl, xu), lam


class Mixup:
    """(reference mixup.py:90) — batch/pair/elem modes."""

    def __init__(
            self,
            mixup_alpha: float = 1.0,
            cutmix_alpha: float = 0.0,
            cutmix_minmax=None,
            prob: float = 1.0,
            switch_prob: float = 0.5,
            mode: str = 'batch',
            correct_lam: bool = True,
            label_smoothing: float = 0.1,
            num_classes: int = 1000,
            seed: Optional[int] = None,
    ):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.cutmix_minmax = cutmix_minmax
        if self.cutmix_minmax is not None:
            assert len(self.cutmix_minmax) == 2
            self.cutmix_alpha = 1.0
        self.mix_prob = prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.mode = mode
        self.correct_lam = correct_lam
        self.mixup_enabled = True
        # seed=None keeps the legacy global np.random stream (not resume-safe);
        # with a seed, set_epoch(e) re-derives the stream so `--resume auto`
        # replays the exact mixup boxes of the original run
        self.seed = seed
        self._rng = np.random.default_rng(seed) if seed is not None else None

    def set_epoch(self, epoch: int):
        if self.seed is not None:
            self._rng = np.random.default_rng((self.seed, epoch))

    def _rand(self):
        return self._rng.random() if self._rng is not None else np.random.rand()

    def _beta(self, alpha):
        return (self._rng.beta(alpha, alpha) if self._rng is not None
                else np.random.beta(alpha, alpha))

    def _params_per_batch(self):
        lam = 1.0
        use_cutmix = False
        if self.mixup_enabled and self._rand() < self.mix_prob:
            if self.mixup_alpha > 0.0 and self.cutmix_alpha > 0.0:
                use_cutmix = self._rand() < self.switch_prob
                lam_mix = self._beta(self.cutmix_alpha) if use_cutmix else \
                    self._beta(self.mixup_alpha)
            elif self.mixup_alpha > 0.0:
                lam_mix = self._beta(self.mixup_alpha)
            elif self.cutmix_alpha > 0.0:
                use_cutmix = True
                lam_mix = self._beta(self.cutmix_alpha)
            else:
                raise ValueError('One of mixup_alpha > 0., cutmix_alpha > 0. required')
            lam = float(lam_mix)
        return lam, use_cutmix

    def _mix_batch(self, x):
        lam, use_cutmix = self._params_per_batch()
        if lam == 1.0:
            return x, 1.0
        x_flipped = x[::-1]
        if use_cutmix:
            (yl, yh, xl, xh), lam = cutmix_bbox_and_lam(
                x.shape, lam, ratio_minmax=self.cutmix_minmax, correct_lam=self.correct_lam,
                rng=self._rng)
            x = x.copy()
            x[:, yl:yh, xl:xh] = x_flipped[:, yl:yh, xl:xh]
        else:
            x = x * lam + x_flipped * (1.0 - lam)
        return x, lam

    def _mix_elem_or_pair(self, x, pair: bool):
        batch_size = x.shape[0]
        num_elem = batch_size // 2 if pair else batch_size
        lam_out = np.ones(batch_size, dtype=np.float32)
        x_orig = x  # read-only source; single copy below is mutated
        x = x.copy()
        for i in range(num_elem):
            j = batch_size - i - 1
            lam, use_cutmix = self._params_per_batch()
            if lam == 1.0:
                continue
            if use_cutmix:
                (yl, yh, xl, xh), lam = cutmix_bbox_and_lam(
                    x[i].shape, lam, ratio_minmax=self.cutmix_minmax, correct_lam=self.correct_lam,
                    rng=self._rng)
                x[i][yl:yh, xl:xh] = x_orig[j][yl:yh, xl:xh]
                if pair:
                    x[j][yl:yh, xl:xh] = x_orig[i][yl:yh, xl:xh]
            else:
                x[i] = x[i] * lam + x_orig[j] * (1 - lam)
                if pair:
                    x[j] = x[j] * lam + x_orig[i] * (1 - lam)
            lam_out[i] = lam
            if pair:
                lam_out[j] = lam
        return x, lam_out

    def sample_params(self, batch_shape):
        """Device-augment split: draw the *parameters* of a mix (per-row lam,
        cutmix flag, bbox) without touching pixels, consuming the RNG stream in
        the same order as __call__ so a seeded run is bit-identical either way.

        Returns {'lam': (B,) f32, 'use_cutmix': (B,) bool, 'bbox': (B, 4) i32
        as (yl, yh, xl, xh)}. Untouched rows encode identity in *values*
        (lam=1, zero bbox) so the pytree structure riding the batch is always
        the same whatever the draw."""
        batch_size = int(batch_shape[0])
        lam_out = np.ones(batch_size, dtype=np.float32)
        use_cut = np.zeros(batch_size, dtype=bool)
        bbox = np.zeros((batch_size, 4), dtype=np.int32)
        if self.mode == 'batch':
            lam, use_cutmix = self._params_per_batch()
            if lam != 1.0:
                if use_cutmix:
                    (yl, yh, xl, xh), lam = cutmix_bbox_and_lam(
                        tuple(batch_shape), lam, ratio_minmax=self.cutmix_minmax,
                        correct_lam=self.correct_lam, rng=self._rng)
                    bbox[:] = (yl, yh, xl, xh)
                    use_cut[:] = True
                lam_out[:] = lam
        else:
            pair = self.mode == 'pair'
            if pair:
                assert batch_size % 2 == 0, 'Batch size should be even for pair mixup'
            num_elem = batch_size // 2 if pair else batch_size
            for i in range(num_elem):
                j = batch_size - i - 1
                lam, use_cutmix = self._params_per_batch()
                if lam == 1.0:
                    continue
                if use_cutmix:
                    (yl, yh, xl, xh), lam = cutmix_bbox_and_lam(
                        tuple(batch_shape[1:]), lam, ratio_minmax=self.cutmix_minmax,
                        correct_lam=self.correct_lam, rng=self._rng)
                    bbox[i] = (yl, yh, xl, xh)
                    use_cut[i] = True
                    if pair:
                        bbox[j] = bbox[i]
                        use_cut[j] = True
                lam_out[i] = lam
                if pair:
                    lam_out[j] = lam
        return {'lam': lam_out, 'use_cutmix': use_cut, 'bbox': bbox}

    def __call__(self, x, target):
        if self.mode == 'batch':
            x, lam = self._mix_batch(x)
            target = mixup_target(target, self.num_classes, lam, self.label_smoothing)
        else:
            pair = self.mode == 'pair'
            if pair:
                assert x.shape[0] % 2 == 0, 'Batch size should be even for pair mixup'
            x, lam = self._mix_elem_or_pair(x, pair)
            off = self.label_smoothing / self.num_classes
            on = 1.0 - self.label_smoothing + off
            y1 = one_hot(target, self.num_classes, on, off)
            y2 = one_hot(target[::-1], self.num_classes, on, off)
            target = y1 * lam[:, None] + y2 * (1.0 - lam[:, None])
        return x, target


class FastCollateMixup(Mixup):
    """Collate-time variant — identical math on this host pipeline; kept for
    API parity with reference mixup.py:221."""

    def __call__(self, batch, _=None):
        xs = np.stack([b[0] for b in batch])
        ts = np.asarray([b[1] for b in batch])
        return super().__call__(xs, ts)
