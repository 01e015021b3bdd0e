"""Host-side image transforms on PIL images / numpy arrays (copy of
timm_tpu/data/transforms.py).

Transforms compose PIL→PIL; the terminal ToNumpy yields float32 HWC in [0,1],
or raw uint8 for the device augment path. Normalization happens on the
device, so the host pipeline stays uint8/float32-cheap. This module,
data/auto_augment.py and data/dataset.py are the only ones of the port that
import PIL.

Random transforms draw from ``sample_rng()`` (data/sample_rng.py): the
loader's per-sample stream, else Python's global ``random``.
"""
from __future__ import annotations

import math
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image

from .sample_rng import sample_rng

__all__ = [
    'Compose', 'ToNumpy', 'RandomResizedCropAndInterpolation', 'CenterCropOrPad',
    'ResizeKeepRatio', 'RandomHorizontalFlip', 'RandomVerticalFlip', 'ColorJitter',
    'Resize', 'CenterCrop', 'str_to_pil_interp',
]

_PIL_INTERP = {
    'nearest': Image.NEAREST,
    'bilinear': Image.BILINEAR,
    'bicubic': Image.BICUBIC,
    'lanczos': Image.LANCZOS,
    'hamming': Image.HAMMING,
    'box': Image.BOX,
}
_RANDOM_INTERPOLATION = (Image.BILINEAR, Image.BICUBIC)


def str_to_pil_interp(mode_str: str):
    return _PIL_INTERP.get(mode_str, Image.BICUBIC)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img

    def __repr__(self):
        return 'Compose(' + ', '.join(repr(t) for t in self.transforms) + ')'


class ToNumpy:
    """PIL → float32 HWC ndarray in [0,1] (normalization is on-device).

    With dtype=np.uint8 the raw bytes pass through untouched — the
    device-augment path transfers uint8 and does the /255 + float math on
    the device (see data/device_augment.py)."""

    def __init__(self, dtype=np.float32):
        self.dtype = dtype

    def __call__(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.dtype == np.uint8:
            return arr.astype(np.uint8)
        if arr.dtype == np.uint8:
            arr = arr.astype(self.dtype) / 255.0
        return arr.astype(self.dtype)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img):
        if sample_rng().random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img):
        if sample_rng().random() < self.p:
            return img.transpose(Image.FLIP_TOP_BOTTOM)
        return img


class Resize:
    def __init__(self, size, interpolation='bilinear'):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        interp = str_to_pil_interp(self.interpolation) if isinstance(self.interpolation, str) else self.interpolation
        if isinstance(self.size, int):
            w, h = img.size
            short, long = (w, h) if w <= h else (h, w)
            if short == self.size:
                return img
            new_short = self.size
            new_long = int(self.size * long / short)
            new_w, new_h = (new_short, new_long) if w <= h else (new_long, new_short)
            return img.resize((new_w, new_h), interp)
        return img.resize(self.size[::-1], interp)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        w, h = img.size
        th, tw = self.size
        left = int(round((w - tw) / 2.0))
        top = int(round((h - th) / 2.0))
        return img.crop((left, top, left + tw, top + th))


class CenterCropOrPad:
    """Center crop w/ padding when image is smaller (reference transforms.py:314)."""

    def __init__(self, size, fill=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.fill = fill

    def __call__(self, img):
        w, h = img.size
        th, tw = self.size
        if w < tw or h < th:
            new = Image.new(img.mode, (max(w, tw), max(h, th)),
                            tuple([self.fill] * len(img.getbands())) if img.getbands() else self.fill)
            new.paste(img, ((max(w, tw) - w) // 2, (max(h, th) - h) // 2))
            img = new
            w, h = img.size
        left = int(round((w - tw) / 2.0))
        top = int(round((h - th) / 2.0))
        return img.crop((left, top, left + tw, top + th))


class ResizeKeepRatio:
    """Resize keeping aspect ratio, longest or shortest criteria
    (reference transforms.py:~430)."""

    def __init__(self, size, longest: float = 0.0, interpolation='bilinear', fill=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.longest = longest
        self.interpolation = interpolation

    def __call__(self, img):
        w, h = img.size
        target_h, target_w = self.size
        ratio_h, ratio_w = h / target_h, w / target_w
        ratio = max(ratio_h, ratio_w) * self.longest + min(ratio_h, ratio_w) * (1.0 - self.longest)
        new_w, new_h = int(round(w / ratio)), int(round(h / ratio))
        interp = str_to_pil_interp(self.interpolation) if isinstance(self.interpolation, str) else self.interpolation
        return img.resize((new_w, new_h), interp)


class RandomApply:
    def __init__(self, transform, p: float = 0.5):
        self.transform = transform
        self.p = p

    def __call__(self, img):
        if sample_rng().random() < self.p:
            return self.transform(img)
        return img


class RandomGrayscale:
    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, img):
        if sample_rng().random() < self.p:
            return img.convert('L').convert(img.mode)
        return img


class RandomGaussianBlur:
    def __init__(self, p: float = 0.1, radius_range=(0.1, 2.0)):
        self.p = p
        self.radius_range = radius_range

    def __call__(self, img):
        if sample_rng().random() < self.p:
            from PIL import ImageFilter
            return img.filter(ImageFilter.GaussianBlur(radius=sample_rng().uniform(*self.radius_range)))
        return img


class TrimBorder:
    """Crop `border_size` pixels from every edge (reference transforms.py TrimBorder)."""

    def __init__(self, border_size: int):
        self.border_size = border_size

    def __call__(self, img):
        w, h = img.size
        b = self.border_size
        if b <= 0 or w <= 2 * b or h <= 2 * b:
            return img
        return img.crop((b, b, w - b, h - b))


class RandomResizedCropAndInterpolation:
    """RRC w/ random interpolation choice (reference transforms.py:166)."""

    def __init__(
            self,
            size,
            scale: Tuple[float, float] = (0.08, 1.0),
            ratio: Tuple[float, float] = (3. / 4., 4. / 3.),
            interpolation: Union[str, Sequence] = 'bilinear',
    ):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        if scale[0] > scale[1] or ratio[0] > ratio[1]:
            warnings.warn('range should be of kind (min, max)')
        self.scale = scale
        self.ratio = ratio
        if interpolation == 'random':
            self.interpolation = _RANDOM_INTERPOLATION
        else:
            self.interpolation = str_to_pil_interp(interpolation) if isinstance(interpolation, str) else interpolation

    @staticmethod
    def get_params(img, scale, ratio):
        w, h = img.size
        area = w * h
        for _ in range(10):
            target_area = sample_rng().uniform(*scale) * area
            log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
            aspect_ratio = math.exp(sample_rng().uniform(*log_ratio))
            tw = int(round(math.sqrt(target_area * aspect_ratio)))
            th = int(round(math.sqrt(target_area / aspect_ratio)))
            if tw <= w and th <= h:
                left = sample_rng().randint(0, w - tw)
                top = sample_rng().randint(0, h - th)
                return top, left, th, tw
        # fallback: center crop to in-range aspect
        in_ratio = w / h
        if in_ratio < min(ratio):
            tw = w
            th = int(round(tw / min(ratio)))
        elif in_ratio > max(ratio):
            th = h
            tw = int(round(th * max(ratio)))
        else:
            tw, th = w, h
        left = (w - tw) // 2
        top = (h - th) // 2
        return top, left, th, tw

    def __call__(self, img):
        top, left, th, tw = self.get_params(img, self.scale, self.ratio)
        if isinstance(self.interpolation, (tuple, list)):
            interp = sample_rng().choice(self.interpolation)
        else:
            interp = self.interpolation
        img = img.crop((left, top, left + tw, top + th))
        return img.resize(self.size[::-1], interp)


class ColorJitter:
    """Brightness/contrast/saturation(/hue) jitter on PIL images."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = self._range(brightness)
        self.contrast = self._range(contrast)
        self.saturation = self._range(saturation)
        self.hue = self._range(hue, center=0.0, bound=0.5, clip_first=False)

    @staticmethod
    def _range(value, center=1.0, bound=float('inf'), clip_first=True):
        if isinstance(value, (tuple, list)):
            return tuple(value) if value[0] != value[1] or value[0] != center else None
        if value == 0:
            return None
        lo = center - value
        if clip_first:
            lo = max(lo, 0.0)
        return (max(lo, -bound), min(center + value, bound))

    def __call__(self, img):
        from PIL import ImageEnhance
        ops = []
        if self.brightness:
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(sample_rng().uniform(*self.brightness)))
        if self.contrast:
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(sample_rng().uniform(*self.contrast)))
        if self.saturation:
            ops.append(lambda im: ImageEnhance.Color(im).enhance(sample_rng().uniform(*self.saturation)))
        if self.hue:
            def hue_op(im):
                f = sample_rng().uniform(*self.hue)
                hsv = im.convert('HSV')
                arr = np.array(hsv)
                arr[..., 0] = (arr[..., 0].astype(np.int16) + int(f * 255)) % 256
                return Image.fromarray(arr, 'HSV').convert(im.mode)
            ops.append(hue_op)
        sample_rng().shuffle(ops)
        for op in ops:
            img = op(img)
        return img
