"""One-pass device augment epilogue: a CUDA kernel written by hand for
Hopper, and its plain PyTorch version.

Port of ``timm_tpu/kernels/augment_epilogue.py``. The kernel
(``csrc/augment_epilogue.cu``) replaces the Pallas ``_epilogue_kernel``
(its ``pallas_call`` at :109) and computes the image part of the device
augment program with 'const' erasing: uint8 -> /255 -> erase K boxes ->
mixup blend or cutmix paste with the batch-flipped row (which is erased with
its own boxes) -> (x - mean) / std -> cast, reading the uint8 batch once and
writing the output once. Its header says how it keeps JAX's rounding points.

``augment_epilogue`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises ``NotImplementedError`` outside the
kernel's contract: contiguous (B, H, W, C) uint8 with C <= 4, K >= 0 boxes,
``lam`` fp32, ``use_cutmix`` int32 or bool, ``bbox`` and ``erase_box`` int32,
all on the image's device, fp32, fp16 or bf16 out. There is no fallback.
Each launch adds one to ``augment_epilogue.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ._build import load_library

__all__ = ['augment_epilogue', 'augment_epilogue_reference']

_OUT_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_CHANNELS = 4
_MAX_ELEMENTS = 1 << 30  # the kernel indexes in int32


def augment_epilogue_reference(image, lam, use_cutmix, bbox, erase_box, *, mean: Sequence[float],
                               std: Sequence[float], re_mean: Optional[Sequence[float]] = None,
                               out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's plain version: the image part of
    ``data.device_augment.augment_image_batch`` with 'const' erasing."""
    from ..data.device_augment import augment_images
    return augment_images(image, erase_box=erase_box, lam=lam, use_cutmix=use_cutmix, bbox=bbox,
                          mean=mean, std=std, re_mean=re_mean, out_dtype=out_dtype)


@functools.cache
def _library():
    lib = load_library('augment_epilogue').lib
    p, i = ctypes.c_void_p, ctypes.c_int
    floats = ctypes.POINTER(ctypes.c_float)
    lib.timm_augment_epilogue.argtypes = (
        [p, p, i, p, p, i, p, p] + [i] * 5 + [floats] * 3 + [i, p])
    lib.timm_augment_epilogue.restype = ctypes.c_int
    lib.timm_augment_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.timm_augment_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def _check_contract(image, lam, use_cutmix, bbox, erase_box, channel_vectors, out_dtype):
    named = dict(image=image, lam=lam, use_cutmix=use_cutmix, bbox=bbox, erase_box=erase_box)
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise NotImplementedError(
            f'augment_epilogue kernel: tensors on more than one device: {sorted(map(str, devices))}')
    if image.dtype != torch.uint8 or image.ndim != 4 or not image.is_contiguous():
        raise NotImplementedError(
            f'augment_epilogue kernel takes a contiguous (B, H, W, C) uint8 image; got '
            f'{image.dtype} of shape {tuple(image.shape)} and strides {image.stride()}')
    b, h, w, c = image.shape
    if not 1 <= c <= _MAX_CHANNELS:
        raise NotImplementedError(f'augment_epilogue kernel takes 1 to 4 channels; got {c}')
    if image.numel() > _MAX_ELEMENTS:
        raise NotImplementedError(
            f'augment_epilogue kernel takes at most {_MAX_ELEMENTS} elements; got {image.numel()}')
    if out_dtype not in _OUT_DTYPES:
        raise NotImplementedError(
            f'augment_epilogue kernel writes fp32, fp16 or bf16; asked for {out_dtype}')
    want = {'lam': ((b,), (torch.float32,)), 'use_cutmix': ((b,), (torch.int32, torch.bool)),
            'bbox': ((b, 4), (torch.int32,))}
    for k, (shape, dtypes) in want.items():
        t = named[k]
        if tuple(t.shape) != shape or t.dtype not in dtypes or not t.is_contiguous():
            raise NotImplementedError(
                f'augment_epilogue kernel: {k} must be contiguous {shape} of {dtypes}; '
                f'got {t.dtype} of shape {tuple(t.shape)}')
    if (erase_box.ndim != 3 or erase_box.shape[0] != b or erase_box.shape[2] != 4
            or erase_box.dtype != torch.int32 or not erase_box.is_contiguous()):
        raise NotImplementedError(
            f'augment_epilogue kernel: erase_box must be contiguous (B, K, 4) int32; got '
            f'{erase_box.dtype} of shape {tuple(erase_box.shape)}')
    for k, v in channel_vectors.items():
        if len(v) != c:
            raise NotImplementedError(f'augment_epilogue kernel: {k} has {len(v)} values for {c} channels')


def _check_devices_cpu(image, *tensors):
    if any(t.device.type != 'cpu' for t in tensors):
        raise NotImplementedError('augment_epilogue: the image is on the CPU and a parameter is not')


def _floats(values):
    # fp32 rounding of the Python floats, as jnp.asarray(values, float32)
    return (ctypes.c_float * _MAX_CHANNELS)(*[float(np.float32(v)) for v in values])


def augment_epilogue(image: torch.Tensor, lam: torch.Tensor, use_cutmix: torch.Tensor,
                     bbox: torch.Tensor, erase_box: torch.Tensor, *, mean: Sequence[float],
                     std: Sequence[float], re_mean: Optional[Sequence[float]] = None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """The augmented, normalised (B, H, W, C) batch in ``out_dtype``.
    Per-image parameters: ``lam`` (B,), ``use_cutmix`` (B,), ``bbox`` (B, 4)
    as (yl, yh, xl, xh) and ``erase_box`` (B, K, 4) as (top, left, eh, ew);
    lam = 1, use_cutmix = 0 and zero boxes are identities."""
    re_mean = tuple(re_mean) if re_mean is not None else (0.0,) * len(mean)
    if image.device.type == 'cpu':
        _check_devices_cpu(image, lam, use_cutmix, bbox, erase_box)
        return augment_epilogue_reference(image, lam, use_cutmix, bbox, erase_box, mean=mean,
                                          std=std, re_mean=re_mean, out_dtype=out_dtype)
    if image.device.type != 'cuda':
        raise NotImplementedError(f'augment_epilogue runs on cuda or cpu tensors; got {image.device}')
    _check_contract(image, lam, use_cutmix, bbox, erase_box,
                    dict(mean=mean, std=std, re_mean=re_mean), out_dtype)
    b, h, w, c = image.shape
    k = erase_box.shape[1]
    out = torch.empty(image.shape, dtype=out_dtype, device=image.device)
    if out.numel() == 0:
        return out
    vec = 4 if (h * w * c) % 4 == 0 and image.data_ptr() % 4 == 0 else 1
    lib = _library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = lib.timm_augment_epilogue(
            image.data_ptr(), out.data_ptr(), _OUT_DTYPES[out_dtype], lam.data_ptr(),
            use_cutmix.data_ptr(), int(use_cutmix.dtype == torch.bool), bbox.data_ptr(),
            erase_box.data_ptr() if k else None, b, h, w, c, k,
            _floats(mean), _floats(std), _floats(re_mean), vec, stream)
    if rc != 0:
        reason = 'bad arguments' if rc < 0 else lib.timm_augment_epilogue_error_string(rc).decode()
        raise RuntimeError(f'augment_epilogue kernel launch failed ({rc}): {reason}')
    augment_epilogue.launches += 1
    return out


augment_epilogue.launches = 0
