"""AutoAugment, RandAugment and AugMix on PIL images (copy of
timm_tpu/data/auto_augment.py, itself after timm/data/auto_augment.py).

The ops, their magnitude conventions and the config-string grammar
('rand-m9-mstd0.5-inc1', 'original-mstd0.5', 'v0', 'augmix-m3-w3') are the
JAX package's, table for table. Python's draws go to ``sample_rng()`` and
numpy's (RandAugment's op choice; AugMix's mixing weights, blend, depths and
op choices) to ``sample_np_rng()`` (data/sample_rng.py), in the JAX
package's order: inside a loader worker each sample has streams of its own,
and outside one, with Python's and numpy's globals seeded alike, the port
gives the JAX package's image bit for bit.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from .sample_rng import sample_np_rng, sample_rng

__all__ = [
    'auto_augment_transform', 'rand_augment_transform', 'augment_and_mix_transform',
    'AutoAugment', 'RandAugment', 'AugMixAugment',
]

_LEVEL_DENOM = 10.0
_FILL = (128, 128, 128)


# ---- PIL ops ---------------------------------------------------------------

def _interpolation(kwargs):
    interp = kwargs.pop('resample', Image.BILINEAR)
    if isinstance(interp, (list, tuple)):
        return sample_rng().choice(interp)
    return interp


def shear_x(img, factor, **kwargs):
    return img.transform(img.size, Image.AFFINE, (1, factor, 0, 0, 1, 0),
                         resample=_interpolation(kwargs), fillcolor=kwargs.get('fillcolor', _FILL))


def shear_y(img, factor, **kwargs):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, factor, 1, 0),
                         resample=_interpolation(kwargs), fillcolor=kwargs.get('fillcolor', _FILL))


def translate_x_rel(img, pct, **kwargs):
    pixels = pct * img.size[0]
    return img.transform(img.size, Image.AFFINE, (1, 0, pixels, 0, 1, 0),
                         resample=_interpolation(kwargs), fillcolor=kwargs.get('fillcolor', _FILL))


def translate_y_rel(img, pct, **kwargs):
    pixels = pct * img.size[1]
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, pixels),
                         resample=_interpolation(kwargs), fillcolor=kwargs.get('fillcolor', _FILL))


def translate_x_abs(img, pixels, **kwargs):
    return img.transform(img.size, Image.AFFINE, (1, 0, pixels, 0, 1, 0),
                         resample=_interpolation(kwargs), fillcolor=kwargs.get('fillcolor', _FILL))


def translate_y_abs(img, pixels, **kwargs):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, pixels),
                         resample=_interpolation(kwargs), fillcolor=kwargs.get('fillcolor', _FILL))


def rotate(img, degrees, **kwargs):
    return img.rotate(degrees, resample=_interpolation(kwargs), fillcolor=kwargs.get('fillcolor', _FILL))


def auto_contrast(img, **kwargs):
    return ImageOps.autocontrast(img)


def invert(img, **kwargs):
    return ImageOps.invert(img)


def equalize(img, **kwargs):
    return ImageOps.equalize(img)


def solarize(img, thresh, **kwargs):
    return ImageOps.solarize(img, thresh)


def solarize_add(img, add, thresh=128, **kwargs):
    lut = [min(255, i + add) if i < thresh else i for i in range(256)]
    if img.mode in ('L', 'RGB'):
        if img.mode == 'RGB':
            lut = lut + lut + lut
        return img.point(lut)
    return img


def posterize(img, bits, **kwargs):
    if bits >= 8:
        return img
    return ImageOps.posterize(img, bits)


def contrast(img, factor, **kwargs):
    return ImageEnhance.Contrast(img).enhance(factor)


def color(img, factor, **kwargs):
    return ImageEnhance.Color(img).enhance(factor)


def brightness(img, factor, **kwargs):
    return ImageEnhance.Brightness(img).enhance(factor)


def sharpness(img, factor, **kwargs):
    return ImageEnhance.Sharpness(img).enhance(factor)


def gaussian_blur(img, factor, **kwargs):
    return img.filter(ImageFilter.GaussianBlur(radius=factor))


def desaturate(img, factor, **kwargs):
    return ImageEnhance.Color(img).enhance(min(1.0, factor))


# ---- magnitude → op-arg conversion -----------------------------------------

def _randomly_negate(v):
    return -v if sample_rng().random() > 0.5 else v


def _rotate_level(level, _hparams):
    return (_randomly_negate((level / _LEVEL_DENOM) * 30.0),)


def _enhance_level(level, _hparams):
    return ((level / _LEVEL_DENOM) * 1.8 + 0.1,)


def _enhance_increasing_level(level, _hparams):
    return (max(0.1, 1.0 + _randomly_negate((level / _LEVEL_DENOM) * 0.9)),)


def _shear_level(level, _hparams):
    return (_randomly_negate((level / _LEVEL_DENOM) * 0.3),)


def _translate_abs_level(level, hparams):
    translate_const = hparams.get('translate_const', 250)
    return (_randomly_negate((level / _LEVEL_DENOM) * translate_const),)


def _translate_rel_level(level, hparams):
    translate_pct = hparams.get('translate_pct', 0.45)
    return (_randomly_negate((level / _LEVEL_DENOM) * translate_pct),)


def _posterize_level(level, _hparams):
    return (int((level / _LEVEL_DENOM) * 4),)


def _posterize_increasing_level(level, _hparams):
    return (4 - int((level / _LEVEL_DENOM) * 4),)


def _posterize_original_level(level, _hparams):
    return (int((level / _LEVEL_DENOM) * 4) + 4,)


def _solarize_level(level, _hparams):
    return (min(256, int((level / _LEVEL_DENOM) * 256)),)


def _solarize_increasing_level(level, _hparams):
    return (256 - _solarize_level(level, _hparams)[0],)


def _solarize_add_level(level, _hparams):
    return (min(128, int((level / _LEVEL_DENOM) * 110)),)


def _gaussian_blur_level(level, _hparams):
    return (0.1 + (level / _LEVEL_DENOM) * 1.9,)


def _desaturate_level(level, _hparams):
    return (min(1.0, 0.1 + (level / _LEVEL_DENOM) * 0.9),)


def _none_level(level, _hparams):
    return ()


LEVEL_TO_ARG = {
    'AutoContrast': _none_level,
    'Equalize': _none_level,
    'Invert': _none_level,
    'Rotate': _rotate_level,
    'Posterize': _posterize_level,
    'PosterizeIncreasing': _posterize_increasing_level,
    'PosterizeOriginal': _posterize_original_level,
    'Solarize': _solarize_level,
    'SolarizeIncreasing': _solarize_increasing_level,
    'SolarizeAdd': _solarize_add_level,
    'Color': _enhance_level,
    'ColorIncreasing': _enhance_increasing_level,
    'Contrast': _enhance_level,
    'ContrastIncreasing': _enhance_increasing_level,
    'Brightness': _enhance_level,
    'BrightnessIncreasing': _enhance_increasing_level,
    'Sharpness': _enhance_level,
    'SharpnessIncreasing': _enhance_increasing_level,
    'ShearX': _shear_level,
    'ShearY': _shear_level,
    'TranslateX': _translate_abs_level,
    'TranslateY': _translate_abs_level,
    'TranslateXRel': _translate_rel_level,
    'TranslateYRel': _translate_rel_level,
    'GaussianBlur': _gaussian_blur_level,
    'Desaturate': _desaturate_level,
}

NAME_TO_OP = {
    'AutoContrast': auto_contrast,
    'Equalize': equalize,
    'Invert': invert,
    'Rotate': rotate,
    'Posterize': posterize,
    'PosterizeIncreasing': posterize,
    'PosterizeOriginal': posterize,
    'Solarize': solarize,
    'SolarizeIncreasing': solarize,
    'SolarizeAdd': solarize_add,
    'Color': color,
    'ColorIncreasing': color,
    'Contrast': contrast,
    'ContrastIncreasing': contrast,
    'Brightness': brightness,
    'BrightnessIncreasing': brightness,
    'Sharpness': sharpness,
    'SharpnessIncreasing': sharpness,
    'ShearX': shear_x,
    'ShearY': shear_y,
    'TranslateX': translate_x_abs,
    'TranslateY': translate_y_abs,
    'TranslateXRel': translate_x_rel,
    'TranslateYRel': translate_y_rel,
    'GaussianBlur': gaussian_blur,
    'Desaturate': desaturate,
}


class AugmentOp:
    def __init__(self, name: str, prob: float = 0.5, magnitude: float = 10, hparams: Optional[Dict] = None):
        hparams = hparams or {}
        self.name = name
        self.aug_fn = NAME_TO_OP[name]
        self.level_fn = LEVEL_TO_ARG[name]
        self.prob = prob
        self.magnitude = magnitude
        self.hparams = hparams.copy()
        self.kwargs = dict(
            fillcolor=hparams.get('img_mean', _FILL),
            resample=hparams.get('interpolation', (Image.BILINEAR, Image.BICUBIC)),
        )
        # magnitude noise: gaussian std / uniform range around magnitude
        self.magnitude_std = self.hparams.get('magnitude_std', 0)
        self.magnitude_max = self.hparams.get('magnitude_max', None)

    def __call__(self, img):
        if self.prob < 1.0 and sample_rng().random() > self.prob:
            return img
        magnitude = self.magnitude
        if self.magnitude_std > 0:
            if self.magnitude_std == float('inf'):
                magnitude = sample_rng().uniform(0, magnitude)
            else:
                magnitude = sample_rng().gauss(magnitude, self.magnitude_std)
        upper = self.magnitude_max or _LEVEL_DENOM
        magnitude = max(0.0, min(magnitude, upper))
        level_args = self.level_fn(magnitude, self.hparams)
        return self.aug_fn(img, *level_args, **self.kwargs)

    def __repr__(self):
        return f'{self.__class__.__name__}(name={self.name}, p={self.prob}, m={self.magnitude})'


# ---- AutoAugment policies ---------------------------------------------------

def _policy_v0(hparams):
    policy = [
        [('Equalize', 0.8, 1), ('ShearY', 0.8, 4)],
        [('Color', 0.4, 9), ('Equalize', 0.6, 3)],
        [('Color', 0.4, 1), ('Rotate', 0.6, 8)],
        [('Solarize', 0.8, 3), ('Equalize', 0.4, 7)],
        [('Solarize', 0.4, 2), ('Solarize', 0.6, 2)],
        [('Color', 0.2, 0), ('Equalize', 0.8, 8)],
        [('Equalize', 0.4, 8), ('SolarizeAdd', 0.8, 3)],
        [('ShearX', 0.2, 9), ('Rotate', 0.6, 8)],
        [('Color', 0.6, 1), ('Equalize', 1.0, 2)],
        [('Invert', 0.4, 9), ('Rotate', 0.6, 0)],
        [('Equalize', 1.0, 9), ('ShearY', 0.6, 3)],
        [('Color', 0.4, 7), ('Equalize', 0.6, 0)],
        [('Posterize', 0.4, 6), ('AutoContrast', 0.4, 7)],
        [('Solarize', 0.6, 8), ('Color', 0.6, 9)],
        [('Solarize', 0.2, 4), ('Rotate', 0.8, 9)],
        [('Rotate', 1.0, 7), ('TranslateYRel', 0.8, 9)],
        [('ShearX', 0.0, 0), ('Solarize', 0.8, 4)],
        [('ShearY', 0.8, 0), ('Color', 0.6, 4)],
        [('Color', 1.0, 0), ('Rotate', 0.6, 2)],
        [('Equalize', 0.8, 4), ('Equalize', 0.0, 8)],
        [('Equalize', 1.0, 4), ('AutoContrast', 0.6, 2)],
        [('ShearY', 0.4, 7), ('SolarizeAdd', 0.6, 7)],
        [('Posterize', 0.8, 2), ('Solarize', 0.6, 10)],
        [('Solarize', 0.6, 8), ('Equalize', 0.6, 1)],
        [('Color', 0.8, 6), ('Rotate', 0.4, 5)],
    ]
    return [[AugmentOp(*a, hparams=hparams) for a in sp] for sp in policy]


def _policy_original(hparams):
    policy = [
        [('PosterizeOriginal', 0.4, 8), ('Rotate', 0.6, 9)],
        [('Solarize', 0.6, 5), ('AutoContrast', 0.6, 5)],
        [('Equalize', 0.8, 8), ('Equalize', 0.6, 3)],
        [('PosterizeOriginal', 0.6, 7), ('PosterizeOriginal', 0.6, 6)],
        [('Equalize', 0.4, 7), ('Solarize', 0.2, 4)],
        [('Equalize', 0.4, 4), ('Rotate', 0.8, 8)],
        [('Solarize', 0.6, 3), ('Equalize', 0.6, 7)],
        [('PosterizeOriginal', 0.8, 5), ('Equalize', 1.0, 2)],
        [('Rotate', 0.2, 3), ('Solarize', 0.6, 8)],
        [('Equalize', 0.6, 8), ('PosterizeOriginal', 0.4, 6)],
        [('Rotate', 0.8, 8), ('Color', 0.4, 0)],
        [('Rotate', 0.4, 9), ('Equalize', 0.6, 2)],
        [('Equalize', 0.0, 7), ('Equalize', 0.8, 8)],
        [('Invert', 0.6, 4), ('Equalize', 1.0, 8)],
        [('Color', 0.6, 4), ('Contrast', 1.0, 8)],
        [('Rotate', 0.8, 8), ('Color', 1.0, 2)],
        [('Color', 0.8, 8), ('Solarize', 0.8, 7)],
        [('Sharpness', 0.4, 7), ('Invert', 0.6, 8)],
        [('ShearX', 0.6, 5), ('Equalize', 1.0, 9)],
        [('Color', 0.4, 0), ('Equalize', 0.6, 3)],
        [('Equalize', 0.4, 7), ('Solarize', 0.2, 4)],
        [('Solarize', 0.6, 5), ('AutoContrast', 0.6, 5)],
        [('Invert', 0.6, 4), ('Equalize', 1.0, 8)],
        [('Color', 0.6, 4), ('Contrast', 1.0, 8)],
        [('Equalize', 0.8, 8), ('Equalize', 0.6, 3)],
    ]
    return [[AugmentOp(*a, hparams=hparams) for a in sp] for sp in policy]


def _policy_3a(hparams):
    policy = [
        [('Solarize', 1.0, 5)],
        [('Desaturate', 1.0, 10)],
        [('GaussianBlur', 1.0, 10)],
    ]
    return [[AugmentOp(*a, hparams=hparams) for a in sp] for sp in policy]


class AutoAugment:
    def __init__(self, policy):
        self.policy = policy

    def __call__(self, img):
        sub_policy = sample_rng().choice(self.policy)
        for op in sub_policy:
            img = op(img)
        return img


def auto_augment_policy(name: str = 'v0', hparams: Optional[Dict] = None):
    hparams = hparams or {}
    if name == 'original':
        return _policy_original(hparams)
    if name in ('v0', 'v0r'):
        return _policy_v0(hparams)
    if name == '3a':
        return _policy_3a(hparams)
    raise ValueError(f'Unknown AA policy {name}')


def auto_augment_transform(config_str: str, hparams: Optional[Dict] = None):
    """'original-mstd0.5' → AutoAugment (reference auto_augment.py:565)."""
    config = config_str.split('-')
    policy_name = config[0]
    hparams = dict(hparams or {})
    for c in config[1:]:
        cs = re.split(r'(\d.*)', c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == 'mstd':
            hparams['magnitude_std'] = float(val)
    return AutoAugment(auto_augment_policy(policy_name, hparams))


# ---- RandAugment ------------------------------------------------------------

_RAND_TRANSFORMS = [
    'AutoContrast', 'Equalize', 'Invert', 'Rotate', 'Posterize', 'Solarize',
    'SolarizeAdd', 'Color', 'Contrast', 'Brightness', 'Sharpness',
    'ShearX', 'ShearY', 'TranslateXRel', 'TranslateYRel',
]

_RAND_INCREASING_TRANSFORMS = [
    'AutoContrast', 'Equalize', 'Invert', 'Rotate', 'PosterizeIncreasing',
    'SolarizeIncreasing', 'SolarizeAdd', 'ColorIncreasing', 'ContrastIncreasing',
    'BrightnessIncreasing', 'SharpnessIncreasing', 'ShearX', 'ShearY',
    'TranslateXRel', 'TranslateYRel',
]


class RandAugment:
    def __init__(self, ops, num_layers: int = 2, choice_weights=None):
        self.ops = ops
        self.num_layers = num_layers
        self.choice_weights = choice_weights

    def __call__(self, img):
        ops = sample_np_rng().choice(
            self.ops, self.num_layers,
            replace=self.choice_weights is None, p=self.choice_weights)
        for op in ops:
            img = op(img)
        return img


def rand_augment_transform(config_str: str, hparams: Optional[Dict] = None, transforms=None):
    """Parse 'rand-m9-mstd0.5-inc1' etc. (reference auto_augment.py:762)."""
    magnitude = _LEVEL_DENOM
    num_layers = 2
    hparams = dict(hparams or {})
    transforms = transforms or _RAND_TRANSFORMS
    config = config_str.split('-')
    assert config[0] == 'rand'
    for c in config[1:]:
        if c.startswith('t_'):
            continue
        cs = re.split(r'(\d.*)', c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == 'mstd':
            mstd = float(val)
            if mstd > 100:
                mstd = float('inf')
            hparams['magnitude_std'] = mstd
        elif key == 'mmax':
            hparams['magnitude_max'] = int(val)
        elif key == 'inc':
            if bool(int(val)):
                transforms = _RAND_INCREASING_TRANSFORMS
        elif key == 'm':
            magnitude = int(val)
        elif key == 'n':
            num_layers = int(val)
        elif key == 'p':
            hparams['prob'] = float(val)
    prob = hparams.pop('prob', 0.5)
    ra_ops = [AugmentOp(name, prob=prob, magnitude=magnitude, hparams=hparams) for name in transforms]
    return RandAugment(ra_ops, num_layers)


# ---- AugMix -----------------------------------------------------------------

_AUGMIX_TRANSFORMS = [
    'AutoContrast', 'ColorIncreasing', 'ContrastIncreasing', 'BrightnessIncreasing',
    'SharpnessIncreasing', 'Equalize', 'Rotate', 'PosterizeIncreasing',
    'SolarizeIncreasing', 'ShearX', 'ShearY', 'TranslateXRel', 'TranslateYRel',
]


class AugMixAugment:
    """(reference auto_augment.py:878)."""

    def __init__(self, ops, alpha: float = 1.0, width: int = 3, depth: int = -1, blended: bool = False):
        self.ops = ops
        self.alpha = alpha
        self.width = width
        self.depth = depth

    def __call__(self, img):
        mixing_weights = np.float32(sample_np_rng().dirichlet([self.alpha] * self.width))
        m = np.float32(sample_np_rng().beta(self.alpha, self.alpha))
        mixed = np.zeros(np.asarray(img).shape, dtype=np.float32)
        for mw in mixing_weights:
            depth = self.depth if self.depth > 0 else sample_np_rng().randint(1, 4)
            ops = sample_np_rng().choice(self.ops, depth, replace=True)
            img_aug = img
            for op in ops:
                img_aug = op(img_aug)
            mixed += mw * np.asarray(img_aug, dtype=np.float32)
        mixed = (1.0 - m) * np.asarray(img, dtype=np.float32) + m * mixed
        return Image.fromarray(np.clip(mixed, 0, 255).astype(np.uint8))


def augment_and_mix_transform(config_str: str, hparams: Optional[Dict] = None):
    """Parse 'augmix-m5-w4-d2' (reference auto_augment.py:~960)."""
    magnitude = 3
    width = 3
    depth = -1
    alpha = 1.0
    hparams = dict(hparams or {})
    config = config_str.split('-')
    assert config[0] == 'augmix'
    for c in config[1:]:
        cs = re.split(r'(\d.*)', c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == 'mstd':
            hparams['magnitude_std'] = float(val)
        elif key == 'm':
            magnitude = int(val)
        elif key == 'w':
            width = int(val)
        elif key == 'd':
            depth = int(val)
        elif key == 'a':
            alpha = float(val)
    hparams.setdefault('magnitude_std', float('inf'))
    ops = [AugmentOp(name, prob=1.0, magnitude=magnitude, hparams=hparams) for name in _AUGMIX_TRANSFORMS]
    return AugMixAugment(ops, alpha=alpha, width=width, depth=depth)
