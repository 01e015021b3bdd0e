"""On-device batch augmentation (counterpart of timm_tpu/data/device_augment.py).

Mixup/CutMix blending and soft targets, RandomErasing fills and the
normalize/dtype cast run on the device after the transfer, so the host only
decodes, resizes and collates uint8. Each transform is split in two:

  * host-side **parameter sampling**: ``Mixup.sample_params`` and
    ``RandomErasing.sample_params`` draw lam, cutmix boxes and erase
    rectangles as small arrays that ride the batch;
  * device-side **application**: the plain functions below, op for op the
    JAX package's, and for CUDA tensors the hand-written augment-epilogue
    kernel (``kernels/augment_epilogue.py``), which does the image part in
    one pass.

Identity is encoded in values (lam = 1, zero boxes). The kernel covers the
'const' erase mode: on CUDA tensors 'rand' raises ``NotImplementedError``
until a kernel covers it, and 'pixel', whose noise the JAX package draws
from its own generator, raises everywhere.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..kernels.augment_epilogue import augment_epilogue

__all__ = [
    'mixup_images', 'mixup_targets', 'erase_images', 'augment_images', 'augment_image_batch',
    'DeviceAugment', 'DeviceAugmentStage',
]

_ERASE_MODES = ('const', 'rand')


def _check_erase_mode(re_mode: str):
    if re_mode == 'pixel':
        raise NotImplementedError(
            "erase mode 'pixel' is not ported: its noise comes from the JAX package's own "
            'generator (ROADMAP A.3)')
    if re_mode not in _ERASE_MODES:
        raise ValueError(f'unknown erase mode {re_mode!r}')


def _grid(x):
    yy = torch.arange(x.shape[1], device=x.device)[None, :, None]
    xx = torch.arange(x.shape[2], device=x.device)[None, None, :]
    return yy, xx


def mixup_images(x, lam, use_cutmix, bbox):
    """Blend (B, H, W, C) float x with its batch flip: row i mixes with row
    B-1-i using lam[i]; cutmix rows paste the bbox[i] = (yl, yh, xl, xh)
    region of the flipped row instead."""
    x_flip = x.flip(0)
    lam_b = lam[:, None, None, None]
    mixed = x * lam_b + x_flip * (1.0 - lam_b)
    yy, xx = _grid(x)
    yl, yh, xl, xh = (bbox[:, i][:, None, None] for i in range(4))
    inside = (yy >= yl) & (yy < yh) & (xx >= xl) & (xx < xh)
    cut = torch.where(inside[..., None], x_flip, x)
    return torch.where(use_cutmix.bool()[:, None, None, None], cut, mixed)


def mixup_targets(target, lam, num_classes: int, smoothing: float = 0.0):
    """Per-row soft targets: the smoothed one-hot of target blended with the
    batch-flipped labels."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    target = target.long()
    y1 = F.one_hot(target, num_classes).float() * (on - off) + off
    y2 = F.one_hot(target.flip(0), num_classes).float() * (on - off) + off
    return y1 * lam[:, None] + y2 * (1.0 - lam[:, None])


def erase_images(x, erase_box, fill=None, *, mode: str = 'const', mean=(0.0, 0.0, 0.0)):
    """Fill K rectangles per row; erase_box is (B, K, 4) = (top, left, eh,
    ew) and zero boxes are no-ops. 'const' fills the channel colour
    ``mean``, 'rand' the per-box colours ``fill`` (B, K, C). Boxes apply in
    slot order."""
    _check_erase_mode(mode)
    yy, xx = _grid(x)
    mean_c = torch.as_tensor(np.asarray(mean, np.float32), device=x.device)
    for k in range(erase_box.shape[1]):
        top, left, eh, ew = (erase_box[:, k, j][:, None, None] for j in range(4))
        inside = (yy >= top) & (yy < top + eh) & (xx >= left) & (xx < left + ew)
        fill_k = fill[:, k][:, None, None, :] if mode == 'rand' else mean_c
        x = torch.where(inside[..., None], fill_k, x)
    return x


def augment_images(image, *, erase_box=None, erase_fill=None, lam=None, use_cutmix=None,
                   bbox=None, mean: Sequence[float], std: Sequence[float], re_mode: str = 'const',
                   re_mean: Optional[Sequence[float]] = None, out_dtype=torch.float32):
    """The image part of the device program: uint8 -> [0, 1] float -> erase
    -> mixup -> normalize -> cast. A step is skipped when its parameters
    are None. The divisions are true divisions, as in JAX (a Python scalar
    divisor would let torch's CUDA kernel multiply by its reciprocal)."""
    x = image.float() / torch.tensor(255.0, device=image.device)
    if erase_box is not None:
        x = erase_images(x, erase_box, erase_fill, mode=re_mode,
                         mean=re_mean if re_mean is not None else (0.0,) * len(mean))
    if lam is not None:
        x = mixup_images(x, lam, use_cutmix, bbox)
    x = (x - torch.as_tensor(np.asarray(mean, np.float32), device=x.device)) / \
        torch.as_tensor(np.asarray(std, np.float32), device=x.device)
    return x.to(out_dtype)


def augment_image_batch(batch, *, mean, std, re_mode='const', re_mean=(0.0, 0.0, 0.0),
                        num_classes=0, smoothing=0.0, out_dtype=torch.float32):
    """The plain device program on a batch dict: returns (input, target),
    the target a soft matrix when mixup parameters ride the batch."""
    _check_erase_mode(re_mode)
    x = augment_images(batch['image'], erase_box=batch.get('erase_box'),
                       erase_fill=batch.get('erase_fill'), lam=batch.get('lam'),
                       use_cutmix=batch.get('use_cutmix'), bbox=batch.get('bbox'),
                       mean=mean, std=std, re_mode=re_mode, re_mean=re_mean, out_dtype=out_dtype)
    if 'lam' in batch:
        y = mixup_targets(batch['target'], batch['lam'], num_classes, smoothing)
    else:
        y = batch['target']
    return x, y


class DeviceAugment:
    """The augment program for a batch dict of tensors. In 'const' mode the
    image epilogue goes through ``augment_epilogue``: the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors. 'rand' runs plain on
    the CPU and raises on CUDA; 'pixel' raises. The target math is tiny and
    stays plain torch on both, as in JAX."""

    def __init__(self, mean, std, re_mode='const', re_mean=None, num_classes=0, smoothing=0.0,
                 out_dtype=torch.float32):
        _check_erase_mode(re_mode)
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)
        self.re_mode = re_mode
        self.re_mean = tuple(float(m) for m in re_mean) if re_mean is not None \
            else (0.0,) * len(self.mean)
        self.num_classes = num_classes
        self.smoothing = smoothing
        self.out_dtype = out_dtype

    def __call__(self, batch):
        image = batch['image']
        if self.re_mode != 'const':
            if image.device.type != 'cpu':
                raise NotImplementedError(
                    f"erase mode {self.re_mode!r} has no kernel yet; on {image.device} only "
                    "'const' runs (ROADMAP A.3)")
            return augment_image_batch(
                batch, mean=self.mean, std=self.std, re_mode=self.re_mode, re_mean=self.re_mean,
                num_classes=self.num_classes, smoothing=self.smoothing, out_dtype=self.out_dtype)
        b, dev = image.shape[0], image.device
        has_mix = 'lam' in batch
        x = augment_epilogue(
            image,
            batch['lam'] if has_mix else torch.ones(b, dtype=torch.float32, device=dev),
            batch['use_cutmix'] if has_mix else torch.zeros(b, dtype=torch.int32, device=dev),
            batch['bbox'] if has_mix else torch.zeros(b, 4, dtype=torch.int32, device=dev),
            batch.get('erase_box', torch.zeros(b, 0, 4, dtype=torch.int32, device=dev)),
            mean=self.mean, std=self.std, re_mean=self.re_mean, out_dtype=self.out_dtype)
        if has_mix:
            y = mixup_targets(batch['target'], batch['lam'], self.num_classes, self.smoothing)
        else:
            y = batch['target']
        return x, y


def _on_device(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device, non_blocking=True)


class DeviceAugmentStage:
    """Iterable stage: consumes uint8 (image, target) batches from a loader
    (or a DevicePrefetcher wrapping one), samples the augmentation
    parameters on the host (erasing first, then mixup, as in JAX), moves
    them to ``device`` and yields the (input, target) tensors of the augment
    program, soft targets when a Mixup sampler is attached. The uint8 batch
    is freed when the stage drops its last reference to it."""

    def __init__(self, loader, mean, std, mixup=None, random_erasing=None, re_mode='const',
                 out_dtype=torch.float32, device=None):
        self.loader = loader
        self.mixup = mixup
        self.random_erasing = random_erasing
        self.device = resolve_device(device)
        self._augment = DeviceAugment(
            mean, std, re_mode=re_mode, re_mean=getattr(random_erasing, 'mean', None),
            num_classes=getattr(mixup, 'num_classes', 0),
            smoothing=getattr(mixup, 'label_smoothing', 0.0), out_dtype=out_dtype)

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, 'set_epoch'):
            self.loader.set_epoch(epoch)
        if self.mixup is not None:
            self.mixup.set_epoch(epoch)
        if self.random_erasing is not None:
            self.random_erasing.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def _device_batch(self, x, t):
        params = {}
        if self.random_erasing is not None:
            params.update(self.random_erasing.sample_params(x.shape))
        if self.mixup is not None:
            params.update(self.mixup.sample_params(x.shape))
        batch = {k: _on_device(v, self.device) for k, v in params.items()}
        batch['image'] = _on_device(x, self.device)
        batch['target'] = _on_device(t, self.device)
        return batch

    def __iter__(self):
        it = iter(self.loader)
        try:
            for x, t in it:
                batch = self._device_batch(x, t)
                del x, t
                out = self._augment(batch)
                del batch
                yield out
        finally:
            # an early stop closes the loader's iteration (and its threads)
            # now, not when the iterator is collected
            close = getattr(it, 'close', None)
            if close is not None:
                close()
