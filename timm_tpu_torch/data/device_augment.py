"""On-device batch augmentation (counterpart of timm_tpu/data/device_augment.py).

Mixup/CutMix blending and soft targets, RandomErasing fills and the
normalize/dtype cast run on the device after the transfer, so the host only
decodes, resizes and collates uint8. Each transform is split in two:

  * host-side **parameter sampling**: ``Mixup.sample_params`` and
    ``RandomErasing.sample_params`` draw lam, cutmix boxes, erase
    rectangles and 'rand' fills as small arrays that ride the batch;
  * device-side **application**: the plain functions below, op for op the
    JAX package's, and for 'const' erasing the hand-written
    augment-epilogue kernel (``kernels/augment_epilogue.py``), which does
    the image part in one pass.

Identity is encoded in values (lam = 1, zero boxes). The route follows the
JAX package's ``augment_epilogue_supported``: 'const' erasing goes to the
kernel, 'rand' and 'pixel' to the torch program below (JAX sends them to
its XLA program); ``DeviceAugment`` picks it from the mode when it is built.

'pixel' noise is ``re_mean + re_std * N(0, 1)`` in [0, 1] space, drawn on
the device from a ``torch.Generator`` seeded by (noise seed, epoch, step)
(``noise_generator_seed``), so it is a pure function of those three, as
JAX's key is. JAX's threefry stream cannot be reproduced: the noise is the
same distribution, not the same numbers; ``erase_images`` takes the canvas
as an argument, so JAX's can be fed in.

``DeviceAugment`` is the augment program, one CUDA graph per batch
signature (names, shapes, dtypes and the mode; ``utils/cuda_graph.py``), the
counterpart of JAX's jit of the program per batch shape; on the CPU it runs
eagerly.

NaFlex batches (packed (B, L, P*P*C) patches in [0, 1]) have their own
program, ``augment_naflex_batch``: normalize with the channel constants
tiled over the patch dim, then fill the erased tokens in normalized space,
0 for 'const' and N(0, 1) noise for 'pixel', drawn as above from a
generator seeded by (noise seed, epoch, step). ``NaFlexDeviceAugment``
runs it as one CUDA graph per bucket shape and erase mode.
"""
from __future__ import annotations

import hashlib
import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.augment_epilogue import augment_epilogue
from ..utils.cuda_graph import StepGraphs

_logger = logging.getLogger(__name__)

__all__ = [
    'mixup_images', 'mixup_targets', 'erase_images', 'augment_images', 'augment_image_batch',
    'noise_generator_seed', 'pixel_noise', 'DeviceAugment', 'DeviceAugmentStage',
    'augment_naflex_batch', 'NaFlexDeviceAugment',
]

_ERASE_MODES = ('const', 'rand', 'pixel')


def _check_erase_mode(re_mode: str):
    if re_mode not in _ERASE_MODES:
        raise ValueError(f'unknown erase mode {re_mode!r}')


def _grid(x):
    yy = torch.arange(x.shape[1], device=x.device)[None, :, None]
    xx = torch.arange(x.shape[2], device=x.device)[None, None, :]
    return yy, xx


def _vec(values, device) -> torch.Tensor:
    """Per-channel constants as an fp32 tensor on ``device``; a tensor
    passes through (the graphed program passes tensors made before any
    capture: a host-to-device copy cannot be captured)."""
    if isinstance(values, torch.Tensor):
        return values
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def noise_generator_seed(noise_seed: int, epoch: int, step: int) -> int:
    """The generator seed of one batch's 'pixel' noise, from (noise seed,
    epoch, step in the epoch): the first 63 bits of their SHA-256."""
    digest = hashlib.sha256(f'{int(noise_seed)}/{int(epoch)}/{int(step)}'.encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> 1


def pixel_noise(shape, generator: torch.Generator, mean, std) -> torch.Tensor:
    """The 'pixel'-mode fill canvas: mean + std * N(0, 1), fp32, drawn from
    ``generator`` on its device."""
    noise = torch.randn(tuple(shape), generator=generator, device=generator.device,
                        dtype=torch.float32)
    return _vec(mean, noise.device) + _vec(std, noise.device) * noise


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
    # one-hot as a comparison, as jax.nn.one_hot computes it: F.one_hot
    # reads the labels' range back to the host on the CPU
    classes = torch.arange(num_classes, device=target.device)
    y1 = (target.long()[:, None] == classes).float() * (on - off) + off
    y2 = (target.long().flip(0)[:, None] == classes).float() * (on - off) + off
    return y1 * lam[:, None] + y2 * (1.0 - lam[:, None])


def erase_images(x, erase_box, fill=None, *, mode: str = 'const', mean=(0.0, 0.0, 0.0),
                 noise=None):
    """Fill K rectangles per row; erase_box is (B, K, 4) = (top, left, eh,
    ew) and zero boxes are no-ops. 'const' fills the channel colour
    ``mean``, 'rand' the per-box colours ``fill`` (B, K, C), 'pixel' the
    ``noise`` canvas (B, H, W, C). Boxes apply in slot order."""
    _check_erase_mode(mode)
    if mode == 'pixel' and noise is None:
        raise ValueError("erase mode 'pixel' needs its noise canvas (pixel_noise)")
    yy, xx = _grid(x)
    mean_c = _vec(mean, x.device)
    for k in range(erase_box.shape[1]):
        top, left, eh, ew = (erase_box[:, k, j][:, None, None] for j in range(4))
        inside = (yy >= top) & (yy < top + eh) & (xx >= left) & (xx < left + ew)
        if mode == 'pixel':
            fill_k = noise
        elif mode == 'rand':
            fill_k = fill[:, k][:, None, None, :]
        else:
            fill_k = mean_c
        x = torch.where(inside[..., None], fill_k, x)
    return x


def augment_images(image, *, erase_box=None, erase_fill=None, noise=None, lam=None,
                   use_cutmix=None, bbox=None, mean: Sequence[float], std: Sequence[float],
                   re_mode: str = 'const', re_mean: Optional[Sequence[float]] = None,
                   out_dtype=torch.float32):
    """The image part of the device program: uint8 -> [0, 1] float -> erase
    -> mixup -> normalize -> cast. A step is skipped when its parameters
    are None. The divisions are true divisions, as in JAX (a Python scalar
    divisor would let torch's CUDA kernel multiply by its reciprocal)."""
    x = image.float() / torch.full((), 255.0, dtype=torch.float32, device=image.device)
    if erase_box is not None:
        x = erase_images(x, erase_box, erase_fill, mode=re_mode, noise=noise,
                         mean=re_mean if re_mean is not None else (0.0,) * x.shape[-1])
    if lam is not None:
        x = mixup_images(x, lam, use_cutmix, bbox)
    x = (x - _vec(mean, x.device)) / _vec(std, x.device)
    return x.to(out_dtype)


def augment_image_batch(batch, *, mean, std, re_mode='const', re_mean=(0.0, 0.0, 0.0),
                        noise=None, num_classes=0, smoothing=0.0, out_dtype=torch.float32):
    """The plain device program on a batch dict: returns (input, target),
    the target a soft matrix when mixup parameters ride the batch. 'pixel'
    erasing fills from ``noise``, the (B, H, W, C) canvas of
    ``pixel_noise``."""
    _check_erase_mode(re_mode)
    x = augment_images(batch['image'], erase_box=batch.get('erase_box'),
                       erase_fill=batch.get('erase_fill'), noise=noise, lam=batch.get('lam'),
                       use_cutmix=batch.get('use_cutmix'), bbox=batch.get('bbox'),
                       mean=mean, std=std, re_mode=re_mode, re_mean=re_mean, out_dtype=out_dtype)
    if 'lam' in batch:
        y = mixup_targets(batch['target'], batch['lam'], num_classes, smoothing)
    else:
        y = batch['target']
    return x, y


class DeviceAugment:
    """The augment program for a batch dict. The route is fixed by the erase
    mode when the program is built: 'const' sends the image part to
    ``augment_epilogue`` (the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors); 'rand' and 'pixel' run the torch program
    ``augment_image_batch``, 'pixel' with its noise drawn on the device from
    the program's generator, seeded by ``noise_generator_seed(noise_seed,
    epoch, step)`` before each call. The target math is tiny and stays
    plain torch, as in JAX.

    On CUDA the program is one CUDA graph per batch signature (names,
    shapes, dtypes, the mode): a signature's first call runs it eagerly,
    the second captures and replays it, later calls replay it; the
    generator is registered with each graph, so every replay draws the
    noise of its own (epoch, step). A capture that fails raises. On the CPU
    the program runs eagerly. ``graphs`` gives ``captures``, ``replays``
    and ``pool_bytes()``."""

    def __init__(self, mean, std, re_mode='const', re_mean=None, re_std=None, num_classes=0,
                 smoothing=0.0, noise_seed=42, out_dtype=torch.float32, device=None):
        _check_erase_mode(re_mode)
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)
        self.re_mode = re_mode
        self.re_mean = tuple(float(m) for m in re_mean) if re_mean is not None \
            else (0.0,) * len(self.mean)
        self.re_std = tuple(float(s) for s in re_std) if re_std is not None \
            else (1.0,) * len(self.std)
        self.num_classes = num_classes
        self.smoothing = smoothing
        self.noise_seed = int(noise_seed)
        self.out_dtype = out_dtype
        self.device = torch.device(device) if device is not None else None
        self.route = 'augment_epilogue kernel' if re_mode == 'const' else 'torch program'
        self.graphs: Optional[StepGraphs] = None
        self.generator: Optional[torch.Generator] = None
        self._consts: Dict[str, torch.Tensor] = {}
        _logger.info(f'device augment: erase mode {re_mode!r} runs the {self.route}')

    def _setup(self, device: torch.device) -> None:
        """Constants, generator and graphs on the program's device, made at
        its first call: before any capture."""
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        if self.graphs is not None:
            if device != self.graphs.device:
                raise ValueError(f'the augment program runs on {self.graphs.device}; got a batch '
                                 f'for {device}')
            return
        self._consts = {k: _vec(getattr(self, k), device)
                        for k in ('mean', 'std', 're_mean', 're_std')}
        if self.re_mode == 'pixel':
            self.generator = torch.Generator(device=device)
        self.graphs = StepGraphs(self._program, device, generators=self._generators)

    def _generators(self):
        return [self.generator]

    def __call__(self, batch, epoch: int = 0, step: int = 0):
        """(input, target) of the batch dict; ``epoch`` and ``step`` (the
        batch's index in its epoch) key the 'pixel' noise."""
        device = self.device if self.device is not None else torch.as_tensor(batch['image']).device
        self._setup(device)
        if self.generator is not None:
            self.generator.manual_seed(noise_generator_seed(self.noise_seed, epoch, step))
        return self.graphs(batch, self.re_mode)

    def _program(self, batch, re_mode: str):
        """The program a graph captures: it reads nothing back to the host."""
        image = batch['image']
        has_mix = 'lam' in batch
        if re_mode == 'const':
            b, dev = image.shape[0], image.device
            x = augment_epilogue(
                image,
                batch['lam'] if has_mix else torch.ones(b, dtype=torch.float32, device=dev),
                batch['use_cutmix'] if has_mix else torch.zeros(b, dtype=torch.int32, device=dev),
                batch['bbox'] if has_mix else torch.zeros(b, 4, dtype=torch.int32, device=dev),
                batch.get('erase_box', torch.zeros(b, 0, 4, dtype=torch.int32, device=dev)),
                mean=self.mean, std=self.std, re_mean=self.re_mean, out_dtype=self.out_dtype)
        else:
            c = self._consts
            noise = None
            if re_mode == 'pixel' and 'erase_box' in batch:
                noise = pixel_noise(image.shape, self.generator, c['re_mean'], c['re_std'])
            x = augment_images(
                image, erase_box=batch.get('erase_box'), erase_fill=batch.get('erase_fill'),
                noise=noise, lam=batch.get('lam'), use_cutmix=batch.get('use_cutmix'),
                bbox=batch.get('bbox'), mean=c['mean'], std=c['std'], re_mode=re_mode,
                re_mean=c['re_mean'], out_dtype=self.out_dtype)
        if has_mix:
            y = mixup_targets(batch['target'], batch['lam'], self.num_classes, self.smoothing)
        else:
            y = batch['target']
        return x, y


class DeviceAugmentStage:
    """Iterable stage: consumes uint8 (image, target) batches from a loader
    (or a DevicePrefetcher wrapping one), samples the augmentation
    parameters on the host (erasing first, then mixup, as in JAX) and
    yields the (input, target) tensors of the augment program on
    ``device``, soft targets when a Mixup sampler is attached. The
    parameters reach the program's graph through pinned memory; the uint8
    batch is freed when the stage drops its last reference to it. A batch's
    'pixel' noise is keyed by (``noise_seed``, the epoch ``set_epoch`` set,
    the batch's index in the epoch), as in JAX."""

    def __init__(self, loader, mean, std, mixup=None, random_erasing=None, re_mode='const',
                 noise_seed=42, out_dtype=torch.float32, device=None):
        self.loader = loader
        self.mixup = mixup
        self.random_erasing = random_erasing
        self.device = resolve_device(device)
        self._epoch = 0
        self._augment = DeviceAugment(
            mean, std, re_mode=re_mode, re_mean=getattr(random_erasing, 'mean', None),
            re_std=getattr(random_erasing, 'std', None),
            num_classes=getattr(mixup, 'num_classes', 0),
            smoothing=getattr(mixup, 'label_smoothing', 0.0), noise_seed=noise_seed,
            out_dtype=out_dtype, device=self.device)

    @property
    def augment(self) -> DeviceAugment:
        return self._augment

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)
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

    def _batch(self, x, t):
        batch = {}
        if self.random_erasing is not None:
            batch.update(self.random_erasing.sample_params(tuple(x.shape)))
        if self.mixup is not None:
            batch.update(self.mixup.sample_params(tuple(x.shape)))
        batch['image'] = x
        batch['target'] = t
        return batch

    def __iter__(self):
        it = iter(self.loader)
        try:
            for step, (x, t) in enumerate(it):
                batch = self._batch(x, t)
                del x, t
                out = self._augment(batch, epoch=self._epoch, step=step)
                del batch
                yield out
        finally:
            # an early stop closes the loader's iteration (and its threads)
            # now, not when the iterator is collected
            close = getattr(it, 'close', None)
            if close is not None:
                close()


_NAFLEX_PARAM_KEYS = ('erase_mask',)


def augment_naflex_batch(batch, *, mean, std, re_mode='const', noise=None):
    """The NaFlex device program: (B, L, D) patches normalized with ``mean``
    and ``std`` tiled to the (P*P*C,) patch dim (channel fastest), then the
    tokens of ``erase_mask`` filled in normalized space: 0 for 'const',
    ``noise`` (N(0, 1) of the patches' shape) for 'pixel'. The mask is
    consumed; every other entry passes through."""
    p = batch['patches'].float()
    reps = p.shape[-1] // len(mean)
    p = (p - _vec(mean, p.device).repeat(reps)) / _vec(std, p.device).repeat(reps)
    if 'erase_mask' in batch:
        if re_mode == 'pixel':
            if noise is None:
                raise ValueError("NaFlex erase mode 'pixel' needs its noise (N(0, 1) of the "
                                 "patches' shape)")
            fill = noise
        else:
            fill = torch.zeros((), dtype=torch.float32, device=p.device)
        p = torch.where(batch['erase_mask'][..., None], fill, p)
    out = {k: v for k, v in batch.items() if k not in _NAFLEX_PARAM_KEYS}
    out['patches'] = p
    return out


class NaFlexDeviceAugment:
    """Iterable stage over NaFlex dict batches: the normalize and the token
    erase fill run on the device (``device``, else the batch's), one CUDA
    graph per bucket shape and erase mode. The host scalars ('seq_len',
    'patch_size') stay out of the program and ride the yielded batch. A
    batch's 'pixel' noise is keyed by (``noise_seed``, the epoch
    ``set_epoch`` set, the batch's index in the epoch)."""

    _HOST_KEYS = ('seq_len', 'patch_size')

    def __init__(self, loader, mean, std, re_mode='const', noise_seed=42, device=None):
        if re_mode not in ('const', 'pixel'):
            raise ValueError(f"NaFlex erase mode must be 'pixel' or 'const', got {re_mode!r}")
        self.loader = loader
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)
        self.re_mode = re_mode
        self.noise_seed = int(noise_seed)
        self.device = resolve_device(device)
        self._epoch = 0
        self.graphs: Optional[StepGraphs] = None
        self.generator: Optional[torch.Generator] = None
        self._consts: Dict[str, torch.Tensor] = {}

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)
        if hasattr(self.loader, 'set_epoch'):
            self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def _setup(self) -> None:
        """Constants, generator and graphs, made before any capture."""
        if self.graphs is not None:
            return
        device = self.device
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        self._consts = {k: _vec(getattr(self, k), device) for k in ('mean', 'std')}
        if self.re_mode == 'pixel':
            self.generator = torch.Generator(device=device)
        self.graphs = StepGraphs(self._program, device, generators=self._generators)

    def _generators(self):
        return [self.generator]

    def _program(self, batch, re_mode: str):
        """The program a graph captures: it reads nothing back to the host."""
        noise = None
        if re_mode == 'pixel' and 'erase_mask' in batch:
            noise = torch.randn(tuple(batch['patches'].shape), generator=self.generator,
                                device=self.generator.device, dtype=torch.float32)
        return augment_naflex_batch(batch, mean=self._consts['mean'], std=self._consts['std'],
                                    re_mode=re_mode, noise=noise)

    def __call__(self, batch, epoch: int = 0, step: int = 0):
        """The augmented dict batch; ``epoch`` and ``step`` key the noise."""
        self._setup()
        host_meta = {k: batch[k] for k in self._HOST_KEYS if k in batch}
        dev = {k: v for k, v in batch.items() if k not in host_meta}
        if self.generator is not None:
            self.generator.manual_seed(noise_generator_seed(self.noise_seed, epoch, step))
        out = self.graphs(dev, self.re_mode)
        out.update(host_meta)
        return out

    def __iter__(self):
        it = iter(self.loader)
        try:
            for step, batch in enumerate(it):
                yield self(batch, epoch=self._epoch, step=step)
        finally:
            close = getattr(it, 'close', None)
            if close is not None:
                close()
