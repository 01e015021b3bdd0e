"""One-pass device augment epilogue: a CUDA kernel written by hand for
Hopper, and its plain PyTorch version.

Port of ``timm_tpu/kernels/augment_epilogue.py``. The kernel
(``csrc/augment_epilogue.cu``) replaces the Pallas ``_epilogue_kernel``
(its ``pallas_call`` at :109) and computes the image part of the device
augment program with 'const' erasing: uint8 -> /255 -> erase K boxes ->
mixup blend or cutmix paste with the batch-flipped row (which is erased with
its own boxes) -> (x - mean) / std -> cast, reading the uint8 batch once and
writing the output once. It keeps JAX's rounding points (true divisions by
255 and by std, two products and a sum for the blend) and equals the plain
version bit for bit.

What bounds it on an H100 is device memory (5 bytes an element for fp32
out), with about 45 thread instructions an element to spend at that rate;
divisions and per-element branches took most of them. So the kernel looks
k / 255 up in a per-block table of the division's own results, keeps one
division by std per element, reads per-channel constants and the erase
boxes from shared memory by index, runs one grid row of blocks per image,
and moves 16 bytes a thread when H*W*C is a multiple of 16 (else 4, else 1)
with every load and store of a warp contiguous; its header has the
details.

``augment_epilogue`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises ``NotImplementedError`` outside the
kernel's contract: contiguous (B, H, W, C) uint8 with C <= 4 and B <= 65535,
0 <= K <= 1024 boxes, ``lam`` fp32, ``use_cutmix`` int32 or bool, ``bbox`` and
``erase_box`` int32, all on the image's device, fp32, fp16 or bf16 out.
There is no fallback. Each launch adds one to ``augment_epilogue.launches``.
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
_MAX_BATCH = 65535  # one grid row of blocks per image
_MAX_BOXES = 1024  # erase boxes of an image and its partner in shared memory


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
    if b > _MAX_BATCH:
        raise NotImplementedError(f'augment_epilogue kernel takes at most {_MAX_BATCH} images; got {b}')
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
    if erase_box.ndim == 3 and erase_box.shape[1] > _MAX_BOXES:
        raise NotImplementedError(
            f'augment_epilogue kernel takes at most {_MAX_BOXES} erase boxes an image; '
            f'got {erase_box.shape[1]}')
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


def _access_width(image: torch.Tensor) -> int:
    """Bytes a kernel thread reads: 16 or 4 when the image's element count
    per image and its address are multiples of it, else 1."""
    _, h, w, c = image.shape
    return next(n for n in (16, 4, 1) if (h * w * c) % n == 0 and image.data_ptr() % n == 0)


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
    vec = _access_width(image)
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


# ---------------------------------------------------------------------------
# registry entry: the JAX registry's cases, then the input path's shapes

_STATICS = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                re_mean=(0.485, 0.456, 0.406))


def _registry_inputs(seed: int = 0, device='cuda', batch: int = 8, size: int = 32,
                     width: Optional[int] = None, erase_k: int = 1, with_mix: bool = True,
                     with_erase: bool = True, num_classes: int = 10):
    """The JAX registry's batch, drawn from one numpy generator in its order
    (image, target, erase boxes, then lam, cutmix flags and boxes), as the
    kernel takes it: without mixup the identity values lam = 1, no cutmix
    and zero boxes, without erasing K = 0. ``width`` makes the image
    ``size`` x ``width`` (the JAX registry's are square)."""
    rng = np.random.default_rng(seed)
    b, h, w = batch, size, width or size
    image = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    rng.integers(0, num_classes, (b,))  # the target: drawn to keep the JAX registry's stream
    boxes = np.zeros((b, erase_k if with_erase else 0, 4), np.int32)
    for i in range(boxes.shape[0]):
        for kk in range(boxes.shape[1]):
            eh, ew = rng.integers(4, h // 2, 2) if width is None else \
                rng.integers(4, np.array([h // 2, w // 2]))
            boxes[i, kk] = (rng.integers(0, h - eh), rng.integers(0, w - ew), eh, ew)
    if with_mix:
        yl, xl = rng.integers(0, h // 2, (b,)), rng.integers(0, w // 2, (b,))
        lam = rng.uniform(0.2, 1.0, (b,)).astype(np.float32)
        cut = rng.integers(0, 2, (b,)).astype(bool)
        bbox = np.stack([yl, yl + h // 4, xl, xl + w // 4], 1).astype(np.int32)
    else:
        lam, cut, bbox = np.ones(b, np.float32), np.zeros(b, np.int32), np.zeros((b, 4), np.int32)
    return {k: torch.from_numpy(a).to(device) for k, a in
            dict(image=image, lam=lam, use_cutmix=cut, bbox=bbox, erase_box=boxes).items()}


def _registry_flops(image, **_):
    """About 20 fp32 operations an element (two divisions, the box tests,
    the blend and the normalise)."""
    return 20 * image.numel(), 'float32'


def _register():
    from .registry import KernelCase, KernelSpec, register
    register(KernelSpec(
        name='augment_epilogue',
        module=__name__,
        regime="the device augment stage's 'const'-erase epilogue at loader batch shapes "
               '(64 or 128 x 224 x 224 x 3 uint8): one read of the image and its mixup '
               'partner, one normalised write',
        gate='beat the plain augment program at every declared case on the card, or be '
             'deleted',
        parity_tol=1e-6,
        kernel_fn=augment_epilogue,
        reference_fn=augment_epilogue_reference,
        make_inputs=_registry_inputs,
        flops=_registry_flops,
        cases=(
            KernelCase(name='mix_erase',
                       dry=dict(batch=8, size=32, erase_k=1),
                       live=dict(batch=128, size=224, erase_k=1), statics=dict(_STATICS),
                       desc='mixup/cutmix + const erase + normalize (JAX registry)'),
            KernelCase(name='no_mix',
                       dry=dict(batch=8, size=32, with_mix=False),
                       live=dict(batch=128, size=224, with_mix=False), statics=dict(_STATICS),
                       desc='identity mix: erase + normalize only (JAX registry)'),
            KernelCase(name='mix_erase_b64',
                       dry=dict(batch=8, size=32, erase_k=1),
                       live=dict(batch=64, size=224, erase_k=1), statics=dict(_STATICS),
                       desc="the input path's batch of 64, the main path"),
            KernelCase(name='edge_odd_b',
                       dry=dict(batch=7, size=24, width=21, erase_k=3),
                       live=dict(batch=63, size=224, width=221, erase_k=3),
                       statics=dict(_STATICS),
                       desc='odd batch, W*C not a multiple of 4, 3 boxes'),
            KernelCase(name='edge_odd_hwc',
                       dry=dict(batch=7, size=23, width=21, erase_k=3),
                       live=dict(batch=63, size=223, width=221, erase_k=3),
                       statics=dict(_STATICS),
                       desc='H*W*C odd: one byte a thread'),
        ),
    ))


_register()
