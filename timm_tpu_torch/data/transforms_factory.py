"""Transform pipeline factory (counterpart of
timm_tpu/data/transforms_factory.py): the noaug, train and eval pipelines,
``auto_augment`` (RandAugment, AugMix, AutoAugment in place of colour
jitter), ``separate=True`` for AugMix's split datasets (the primary,
secondary and final pipelines apart), ``output_dtype=np.uint8`` for the
device augment path."""
from __future__ import annotations

from typing import Optional, Tuple, Union

from .auto_augment import augment_and_mix_transform, auto_augment_transform, rand_augment_transform
from .constants import DEFAULT_CROP_PCT, IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from .transforms import (
    CenterCrop, CenterCropOrPad, ColorJitter, Compose, RandomApply,
    RandomGaussianBlur, RandomGrayscale, RandomHorizontalFlip,
    RandomResizedCropAndInterpolation, RandomVerticalFlip, Resize, ResizeKeepRatio,
    ToNumpy, TrimBorder, str_to_pil_interp,
)

__all__ = ['create_transform', 'transforms_imagenet_train', 'transforms_imagenet_eval', 'transforms_noaug_train']


def transforms_noaug_train(
        img_size=224,
        interpolation='bilinear',
        output_dtype=None,
        **kwargs,
):
    if interpolation == 'random':
        interpolation = 'bilinear'
    return Compose([
        Resize(img_size if isinstance(img_size, int) else max(img_size), interpolation=interpolation),
        CenterCrop(img_size),
        ToNumpy(output_dtype) if output_dtype is not None else ToNumpy(),
    ])


def transforms_imagenet_train(
        img_size=224,
        scale=None,
        ratio=None,
        train_crop_mode=None,
        hflip: float = 0.5,
        vflip: float = 0.0,
        color_jitter: Union[float, Tuple] = 0.4,
        color_jitter_prob: Optional[float] = None,
        grayscale_prob: float = 0.0,
        gaussian_blur_prob: float = 0.0,
        auto_augment: Optional[str] = None,
        interpolation: str = 'random',
        mean=IMAGENET_DEFAULT_MEAN,
        re_prob: float = 0.0,
        re_mode: str = 'const',
        re_count: int = 1,
        re_num_splits: int = 0,
        separate: bool = False,
        output_dtype=None,
        **kwargs,
):
    """Train pipeline (reference transforms_factory.py:65). `output_dtype`
    overrides the ToNumpy dtype — np.uint8 keeps raw bytes for the
    device-augment path."""
    scale = tuple(scale or (0.08, 1.0))
    ratio = tuple(ratio or (3. / 4., 4. / 3.))
    primary_tfl = [RandomResizedCropAndInterpolation(img_size, scale=scale, ratio=ratio, interpolation=interpolation)]
    if hflip > 0.0:
        primary_tfl.append(RandomHorizontalFlip(p=hflip))
    if vflip > 0.0:
        primary_tfl.append(RandomVerticalFlip(p=vflip))

    secondary_tfl = []
    if auto_augment:
        assert isinstance(auto_augment, str)
        img_size_min = img_size if isinstance(img_size, int) else min(img_size)
        aa_params = dict(
            translate_const=int(img_size_min * 0.45),
            img_mean=tuple(int(round(255 * x)) for x in mean),
        )
        if interpolation and interpolation != 'random':
            aa_params['interpolation'] = str_to_pil_interp(interpolation)
        if auto_augment.startswith('rand'):
            secondary_tfl.append(rand_augment_transform(auto_augment, aa_params))
        elif auto_augment.startswith('augmix'):
            secondary_tfl.append(augment_and_mix_transform(auto_augment, aa_params))
        else:
            secondary_tfl.append(auto_augment_transform(auto_augment, aa_params))
    elif color_jitter is not None and color_jitter != 0:
        if isinstance(color_jitter, (list, tuple)):
            assert len(color_jitter) in (3, 4)
        else:
            color_jitter = (float(color_jitter),) * 3
        jitter = ColorJitter(*color_jitter)
        secondary_tfl.append(
            RandomApply(jitter, p=color_jitter_prob) if color_jitter_prob is not None else jitter)
    if grayscale_prob:
        secondary_tfl.append(RandomGrayscale(p=grayscale_prob))
    if gaussian_blur_prob:
        secondary_tfl.append(RandomGaussianBlur(p=gaussian_blur_prob))

    final_tfl = [ToNumpy(output_dtype) if output_dtype is not None else ToNumpy()]
    # NOTE: RandomErasing runs post-collate on the batch (see loader.py) to
    # mirror the reference's device-side erasing placement.
    if separate:
        return (Compose(primary_tfl), Compose(secondary_tfl), Compose(final_tfl))
    return Compose(primary_tfl + secondary_tfl + final_tfl)


def transforms_imagenet_eval(
        img_size=224,
        crop_pct: Optional[float] = None,
        crop_mode: Optional[str] = None,
        crop_border_pixels: Optional[int] = None,
        interpolation: str = 'bilinear',
        output_dtype=None,
        **kwargs,
):
    """Eval pipeline w/ crop modes (reference transforms_factory.py:273)."""
    crop_pct = crop_pct or DEFAULT_CROP_PCT
    if isinstance(img_size, (tuple, list)):
        assert len(img_size) == 2
        scale_size = tuple(int(x / crop_pct) for x in img_size)
    else:
        scale_size = int(img_size / crop_pct)
    if interpolation == 'random':
        interpolation = 'bilinear'

    crop_mode = crop_mode or 'center'
    tfl = []
    if crop_border_pixels:
        tfl.append(TrimBorder(crop_border_pixels))
    if crop_mode == 'squash':
        size = (img_size, img_size) if isinstance(img_size, int) else img_size
        ss = (scale_size, scale_size) if isinstance(scale_size, int) else scale_size
        tfl += [Resize(ss, interpolation=interpolation), CenterCrop(img_size)]
    elif crop_mode == 'border':
        tfl += [ResizeKeepRatio(img_size, longest=1.0, interpolation=interpolation), CenterCropOrPad(img_size)]
    else:  # center
        tfl += [Resize(scale_size, interpolation=interpolation), CenterCrop(img_size)]
    tfl.append(ToNumpy(output_dtype) if output_dtype is not None else ToNumpy())
    return Compose(tfl)


def create_transform(
        input_size=224,
        is_training: bool = False,
        no_aug: bool = False,
        train_crop_mode=None,
        scale=None,
        ratio=None,
        hflip: float = 0.5,
        vflip: float = 0.0,
        color_jitter=0.4,
        color_jitter_prob=None,
        grayscale_prob=0.0,
        gaussian_blur_prob=0.0,
        auto_augment=None,
        interpolation: str = 'bilinear',
        mean=IMAGENET_DEFAULT_MEAN,
        std=IMAGENET_DEFAULT_STD,
        re_prob: float = 0.0,
        re_mode: str = 'const',
        re_count: int = 1,
        re_num_splits: int = 0,
        crop_pct=None,
        crop_mode=None,
        crop_border_pixels=None,
        separate: bool = False,
        output_dtype=None,
        **kwargs,
):
    """(reference transforms_factory.py:379)."""
    if isinstance(input_size, (tuple, list)):
        img_size = input_size[-2:]
        if img_size[0] == img_size[1]:
            img_size = img_size[0]
    else:
        img_size = input_size

    if is_training and no_aug:
        return transforms_noaug_train(img_size, interpolation=interpolation,
                                      output_dtype=output_dtype)
    if is_training:
        return transforms_imagenet_train(
            img_size,
            scale=scale,
            ratio=ratio,
            train_crop_mode=train_crop_mode,
            hflip=hflip,
            vflip=vflip,
            color_jitter=color_jitter,
            color_jitter_prob=color_jitter_prob,
            grayscale_prob=grayscale_prob,
            gaussian_blur_prob=gaussian_blur_prob,
            auto_augment=auto_augment,
            interpolation=interpolation,
            mean=mean,
            re_prob=re_prob,
            re_mode=re_mode,
            re_count=re_count,
            re_num_splits=re_num_splits,
            separate=separate,
            output_dtype=output_dtype,
        )
    return transforms_imagenet_eval(
        img_size,
        crop_pct=crop_pct,
        crop_mode=crop_mode,
        crop_border_pixels=crop_border_pixels,
        interpolation=interpolation,
        output_dtype=output_dtype,
    )
