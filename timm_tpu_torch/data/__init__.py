"""The input path of training (counterpart of timm_tpu/data): dataset,
threaded loader, CUDA-stream device prefetcher, host sampling of mixup,
cutmix and erasing parameters, and the device augment stage.

Importing this package does not import PIL: the modules that need it
(``dataset``, ``dataset_factory``, ``transforms``, ``transforms_factory``)
are imported by name, and ``create_loader`` imports ``create_transform``
when it is called.
"""
from .config import resolve_data_config, resolve_model_data_config
from .constants import (
    DEFAULT_CROP_MODE, DEFAULT_CROP_PCT, IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD,
    IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD, OPENAI_CLIP_MEAN, OPENAI_CLIP_STD,
)
from .device_augment import (
    DeviceAugment, DeviceAugmentStage, augment_image_batch, augment_images, erase_images,
    mixup_images, mixup_targets,
)
from .loader import DevicePrefetcher, ThreadedLoader, create_loader
from .mixup import FastCollateMixup, Mixup, mixup_target
from .random_erasing import RandomErasing
from .readers import ReaderImageFolder, create_reader
