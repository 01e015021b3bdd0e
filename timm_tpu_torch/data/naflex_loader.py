"""NaFlex data pipeline: variable-resolution images -> padded token batches
(counterpart of timm_tpu/data/naflex_loader.py; plain Python, numpy and PIL
on the host).

A fixed ladder of sequence-length buckets, each with a batch size from a
token budget, so batch shapes are static per bucket and the train step is
one CUDA graph per bucket. Batches are dicts: {patches (B, L, P*P*C),
patch_coord (B, L, 2), patch_valid (B, L), seq_len, target (B,)}, plus
``patch_size`` with patch-size choices, ``target_b`` and ``lam`` after
mixup, and ``erase_mask`` (B, L) when the erase fill runs on the device.

The batches equal the JAX loader's bit for bit given the same random
streams: the same PIL resizes, the same draws in the same order from the
per-epoch ``random.Random`` of the schedule (seed + epoch) and of mixup
(seed * 31 + epoch), and from erasing's (seed * 7919 + 13). Two streams
differ in where they live, so that every epoch is a function of (seed,
epoch) and a run resumed mid-epoch, which regenerates the epoch's skipped
batches, sees the batches of the uninterrupted run in any epoch: JAX's
horizontal flip draws from Python's global ``random``, the port's from a
``random.Random`` seeded by ``hflip_seed(epoch)`` at the start of each
epoch (with the global stream seeded by that value the JAX loader draws the
same flips); and JAX makes erasing's stream once, so its epoch 1 goes on
where epoch 0 ended, while the port reseeds it with seed * 7919 + 13 +
epoch at the start of each epoch (the same stream in epoch 0).
"""
from __future__ import annotations

import logging
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from .constants import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from .loader import _process_index_count
from .transforms import str_to_pil_interp

__all__ = ['NaFlexCollator', 'NaFlexLoader', 'NaFlexRandomErasing', 'calculate_naflex_batch_size',
           'create_naflex_loader', 'patchify_np', 'resize_to_seq_len']

_logger = logging.getLogger(__name__)


def calculate_naflex_batch_size(
        tokens_per_batch: int,
        seq_len: int,
        max_size: Optional[int] = None,
        divisor: int = 1,
        rounding: str = 'floor',
) -> int:
    """Token budget -> batch size at ``seq_len``."""
    batch_size = tokens_per_batch / seq_len
    if rounding == 'floor':
        batch_size = int(math.floor(batch_size / divisor) * divisor)
    elif rounding == 'ceil':
        batch_size = int(math.ceil(batch_size / divisor) * divisor)
    else:
        batch_size = int(round(batch_size / divisor) * divisor)
    batch_size = max(divisor, batch_size)
    if max_size is not None:
        batch_size = min(batch_size, max_size)
    return batch_size


def resize_to_seq_len(img: Image.Image, seq_len: int, patch_size: int, interpolation='bicubic'):
    """Resize keeping the aspect ratio so that grid_h * grid_w <= seq_len."""
    w, h = img.size
    p = patch_size
    aspect = w / h
    gh = max(1, int(math.floor(math.sqrt(seq_len / aspect))))
    gw = max(1, int(math.floor(gh * aspect)))
    while gh * gw > seq_len:
        if gw >= gh:
            gw -= 1
        else:
            gh -= 1
    while (gh + 1) * gw <= seq_len and (gh + 1) * p <= h * 4:
        gh += 1
    while gh * (gw + 1) <= seq_len and (gw + 1) * p <= w * 4:
        gw += 1
    interp = str_to_pil_interp(interpolation) if isinstance(interpolation, str) else interpolation
    return img.resize((gw * p, gh * p), interp)


def patchify_np(arr: np.ndarray, patch_size: int):
    """HWC float array -> (N, P*P*C) patches and (N, 2) coords."""
    H, W, C = arr.shape
    P = patch_size
    gh, gw = H // P, W // P
    arr = arr[:gh * P, :gw * P]
    patches = arr.reshape(gh, P, gw, P, C).transpose(0, 2, 1, 3, 4).reshape(gh * gw, P * P * C)
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing='ij')
    coord = np.stack([yy, xx], axis=-1).reshape(gh * gw, 2)
    return patches, coord


class NaFlexRandomErasing:
    """Token-space random erasing: a random rectangle of patches by grid
    coords, after patchify, so it composes with any patch size and
    sequence length."""

    def __init__(self, probability: float = 0.5, min_area: float = 0.02, max_area: float = 1 / 3,
                 mode: str = 'pixel', rng: Optional[random.Random] = None):
        if mode not in ('pixel', 'const'):
            raise ValueError(f"NaFlex erase mode must be 'pixel' or 'const', got {mode!r}")
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        self.mode = mode
        self.rng = rng or random.Random()

    def sample_mask(self, coord: np.ndarray) -> Optional[np.ndarray]:
        """The erase rectangle only, as an (N,) token mask (None when the
        probability gate fails); the device program fills it."""
        if self.rng.random() > self.probability:
            return None
        gh = int(coord[:, 0].max()) + 1
        gw = int(coord[:, 1].max()) + 1
        area = gh * gw
        target_area = self.rng.uniform(self.min_area, self.max_area) * area
        eh = max(1, min(gh, int(round(math.sqrt(target_area)))))
        ew = max(1, min(gw, int(round(target_area / eh))))
        top = self.rng.randint(0, gh - eh)
        left = self.rng.randint(0, gw - ew)
        return ((coord[:, 0] >= top) & (coord[:, 0] < top + eh) &
                (coord[:, 1] >= left) & (coord[:, 1] < left + ew))

    def __call__(self, patches: np.ndarray, coord: np.ndarray):
        mask = self.sample_mask(coord)
        if mask is None:
            return patches
        patches = patches.copy()
        if self.mode == 'pixel':
            nrng = np.random.RandomState(self.rng.randrange(2 ** 31))
            patches[mask] = nrng.randn(int(mask.sum()), patches.shape[1]).astype(patches.dtype)
        else:
            patches[mask] = 0.0
        return patches


class NaFlexCollator:
    """Pad a list of (patches, coord, target[, target_b, lam]) samples to
    ``seq_len``."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3):
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.patch_dim = patch_size * patch_size * in_chans

    def __call__(self, samples: List[Tuple], seq_len: int, patch_size: Optional[int] = None,
                 erase_masks: Optional[List[Optional[np.ndarray]]] = None) -> Dict:
        B = len(samples)
        p_size = patch_size or self.patch_size
        patch_dim = p_size * p_size * self.in_chans
        patches = np.zeros((B, seq_len, patch_dim), np.float32)
        coord = np.zeros((B, seq_len, 2), np.int32)
        valid = np.zeros((B, seq_len), bool)
        targets = np.zeros((B,), np.int64)
        targets_b = np.zeros((B,), np.int64)
        lam = np.ones((B,), np.float32)
        has_mix = False
        for i, s in enumerate(samples):
            p, c, t = s[0], s[1], s[2]
            n = min(len(p), seq_len)
            patches[i, :n] = p[:n]
            coord[i, :n] = c[:n]
            valid[i, :n] = True
            targets[i] = t
            if len(s) > 3:
                targets_b[i] = s[3]
                lam[i] = s[4]
                has_mix = True
            else:
                targets_b[i] = t
        out = {
            'patches': patches,
            'patch_coord': coord,
            'patch_valid': valid,
            'seq_len': seq_len,
            'target': targets,
        }
        if patch_size is not None:
            out['patch_size'] = p_size
        if has_mix:
            out['target_b'] = targets_b
            out['lam'] = lam
        if erase_masks is not None:
            em = np.zeros((B, seq_len), bool)
            for i, m in enumerate(erase_masks):
                if m is not None:
                    n = min(len(m), seq_len)
                    em[i, :n] = m[:n]
            out['erase_mask'] = em
        return out


class NaFlexLoader:
    """Iterable over token-budget batches with a per-epoch schedule of
    (seq_len, patch size, batch) groups ('budget' mode), or each image in
    the smallest bucket holding its native grid ('native' mode)."""

    def __init__(
            self,
            dataset,
            tokens_per_batch: int = 576 * 64,
            seq_lens: Sequence[int] = (128, 256, 576, 784, 1024),
            patch_size: int = 16,
            patch_size_choices: Optional[Sequence[int]] = None,
            patch_size_choice_probs: Optional[Sequence[float]] = None,
            is_training: bool = False,
            mean=IMAGENET_DEFAULT_MEAN,
            std=IMAGENET_DEFAULT_STD,
            interpolation: str = 'bicubic',
            hflip: float = 0.5,
            mixup_alpha: float = 0.0,
            cutmix_alpha: float = 0.0,
            mixup_prob: float = 1.0,
            mixup_switch_prob: float = 0.5,
            re_prob: float = 0.0,
            re_mode: str = 'pixel',
            seed: int = 42,
            process_index: int = 0,
            process_count: int = 1,
            batch_divisor: int = 1,
            device_augment: bool = False,
            bucket_mode: str = 'budget',
    ):
        if bucket_mode not in ('budget', 'native'):
            raise ValueError(f"bucket_mode must be 'budget' or 'native', got {bucket_mode!r}")
        if bucket_mode == 'native':
            if process_count > 1:
                raise ValueError(
                    'bucket_mode="native" assigns batches from per-image sizes, which is '
                    'data-dependent and cannot keep multi-process steps in lockstep; '
                    'use bucket_mode="budget" for multi-process training')
            if patch_size_choices:
                raise ValueError(
                    'bucket_mode="native" uses a fixed patch_size (bucket assignment '
                    'depends on it); patch_size_choices is only supported in budget mode')
        self.dataset = dataset
        self.tokens_per_batch = tokens_per_batch
        self.seq_lens = tuple(sorted(seq_lens))
        self.patch_size = patch_size
        self.patch_size_choices = tuple(patch_size_choices) if patch_size_choices else None
        if self.patch_size_choices and patch_size_choice_probs:
            if len(patch_size_choice_probs) != len(self.patch_size_choices):
                raise ValueError('one probability per patch size choice')
            self.patch_size_choice_probs = tuple(patch_size_choice_probs)
        elif self.patch_size_choices:
            self.patch_size_choice_probs = (1.0 / len(self.patch_size_choices),) * len(self.patch_size_choices)
        else:
            self.patch_size_choice_probs = None
        self.is_training = is_training
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.interpolation = interpolation
        self.hflip = hflip if is_training and hflip > 0 else 0.0
        self.mixup_alpha = mixup_alpha if is_training else 0.0
        self.cutmix_alpha = cutmix_alpha if is_training else 0.0
        self.mixup_prob = mixup_prob
        self.mixup_switch_prob = mixup_switch_prob
        self.random_erasing = NaFlexRandomErasing(
            re_prob, mode=re_mode, rng=random.Random(seed * 7919 + 13)) \
            if re_prob > 0 and is_training else None
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.batch_divisor = max(1, batch_divisor)
        self.device_augment = device_augment
        self.bucket_mode = bucket_mode
        self._native_len = None  # exact batch count, known after one native epoch
        self.collator = NaFlexCollator(patch_size)
        # the dataset must yield PIL images
        if getattr(dataset, 'transform', None) is not None:
            _logger.warning(
                'NaFlexLoader clearing existing dataset.transform: the NaFlex pipeline does its '
                'own resize and patchify; do not share this dataset instance with a tensor loader')
            dataset.transform = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def hflip_seed(self, epoch: int) -> int:
        """The seed of the horizontal-flip stream of ``epoch``."""
        return self.seed * 1000003 + 17 + int(epoch)

    def _schedule(self) -> List[Tuple[int, int, int, List[int]]]:
        """This epoch's (seq_len, patch size, local batch size, indices)
        groups, computed over the global index list with batch sizes
        divisible by the process count: every process sees the same batch
        count and shapes, and takes its slice of each batch."""
        rng = random.Random(self.seed + self.epoch)
        n = len(self.dataset)
        indices = list(range(n))
        if self.is_training:
            rng.shuffle(indices)
        batches = []
        pos = 0
        divisor = self.process_count * self.batch_divisor
        while pos < len(indices):
            seq_len = rng.choice(self.seq_lens) if self.is_training else self.seq_lens[-1]
            if self.is_training and self.patch_size_choices:
                patch_size = rng.choices(self.patch_size_choices, self.patch_size_choice_probs)[0]
            else:
                patch_size = self.patch_size
            bs = calculate_naflex_batch_size(self.tokens_per_batch, seq_len, divisor=divisor)
            group = indices[pos:pos + bs]
            pos += bs
            if len(group) < bs:
                if self.is_training:
                    break  # the ragged trailing batch is dropped in training
                group = group + indices[:bs - len(group)]  # eval: wrap to a full batch
            local = group[self.process_index::self.process_count]
            batches.append((seq_len, patch_size, bs // self.process_count, local))
        return batches

    def __len__(self):
        if self.bucket_mode == 'native':
            if self._native_len is not None:
                return self._native_len
            # an estimate before the first epoch; exact after one full pass
            divisor = self.process_count * self.batch_divisor
            bs = calculate_naflex_batch_size(self.tokens_per_batch, self.seq_lens[-1], divisor=divisor)
            return max(1, len(self.dataset) // bs)
        return len(self._schedule())

    def _load(self, idx: int, flip_rng: random.Random):
        img, target = self.dataset[idx]
        if self.hflip and flip_rng.random() < self.hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img, target

    def _load_array(self, img) -> np.ndarray:
        arr = np.asarray(img, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if not self.device_augment:
            # with the device augment the patches stay in [0, 1]: the device
            # program normalizes (mixup commutes with the affine normalize)
            arr = (arr - self.mean) / self.std
        return arr

    def _make_samples(self, arrays, targets, patch_size, mix_rng):
        """Mixup, patchify and erase for one batch group: (samples,
        erase_masks), erase_masks None unless the fill runs on the device."""
        do_mix = ((self.mixup_alpha > 0 or self.cutmix_alpha > 0) and len(arrays) > 1
                  and mix_rng.random() < self.mixup_prob)
        if do_mix:
            from .naflex_mixup import mix_batch_variable_size
            arrays, lams, pair_to = mix_batch_variable_size(
                arrays, mixup_alpha=self.mixup_alpha, cutmix_alpha=self.cutmix_alpha,
                switch_prob=self.mixup_switch_prob, rng=mix_rng)
        sample_masks = self.device_augment and self.random_erasing is not None
        erase_masks = [] if sample_masks else None
        samples = []
        for i, arr in enumerate(arrays):
            p, c = patchify_np(arr, patch_size)
            if sample_masks:
                erase_masks.append(self.random_erasing.sample_mask(c))
            elif self.random_erasing is not None:
                p = self.random_erasing(p, c)
            if do_mix:
                t_b = targets[pair_to[i]] if i in pair_to else targets[i]
                samples.append((p, c, targets[i], t_b, lams[i]))
            else:
                samples.append((p, c, targets[i]))
        return samples, erase_masks

    def _epoch_streams(self):
        """(mixup's, the flip's) streams of this epoch; erasing's reseeded."""
        if self.random_erasing is not None:
            self.random_erasing.rng = random.Random(self.seed * 7919 + 13 + self.epoch)
        return random.Random(self.seed * 31 + self.epoch), random.Random(self.hflip_seed(self.epoch))

    def _iter_budget(self):
        mix_rng, flip_rng = self._epoch_streams()
        for seq_len, patch_size, bs, group in self._schedule():
            arrays, targets = [], []
            for idx in group:
                img, target = self._load(idx, flip_rng)
                img = resize_to_seq_len(img, seq_len, patch_size, self.interpolation)
                arrays.append(self._load_array(img))
                targets.append(target)
            samples, erase_masks = self._make_samples(arrays, targets, patch_size, mix_rng)
            yield self.collator(
                samples, seq_len,
                patch_size=patch_size if self.patch_size_choices else None,
                erase_masks=erase_masks)

    def _iter_native(self):
        """Each image goes to the smallest bucket holding its native grid's
        token count; a batch is emitted when a bucket's buffer fills.
        Training drops the leftovers, evaluation wraps them to full
        batches."""
        from ..serve.bucketing import select_bucket
        mix_rng, flip_rng = self._epoch_streams()
        rng = random.Random(self.seed + self.epoch)
        indices = list(range(len(self.dataset)))
        if self.is_training:
            rng.shuffle(indices)
        p = self.patch_size
        divisor = self.process_count * self.batch_divisor
        bucket_bs = {s: calculate_naflex_batch_size(self.tokens_per_batch, s, divisor=divisor)
                     for s in self.seq_lens}
        buffers = {s: [] for s in self.seq_lens}
        max_bucket = self.seq_lens[-1]
        count = 0

        def emit(seq_len, buf):
            arrays = [a for a, _ in buf]
            targets = [t for _, t in buf]
            samples, erase_masks = self._make_samples(arrays, targets, p, mix_rng)
            return self.collator(samples, seq_len, erase_masks=erase_masks)

        for idx in indices:
            img, target = self._load(idx, flip_rng)
            w, h = img.size
            tokens = max(1, round(h / p)) * max(1, round(w / p))
            bucket = select_bucket(min(tokens, max_bucket), self.seq_lens)
            img = resize_to_seq_len(img, bucket, p, self.interpolation)
            buffers[bucket].append((self._load_array(img), target))
            if len(buffers[bucket]) == bucket_bs[bucket]:
                yield emit(bucket, buffers[bucket])
                buffers[bucket] = []
                count += 1
        if not self.is_training:
            for s in self.seq_lens:
                buf = buffers[s]
                if buf:
                    reps = -(-bucket_bs[s] // len(buf))
                    yield emit(s, (buf * reps)[:bucket_bs[s]])
                    count += 1
        self._native_len = count

    def __iter__(self):
        if self.bucket_mode == 'native':
            return self._iter_native()
        return self._iter_budget()


def create_naflex_loader(
        dataset,
        patch_size: int = 16,
        patch_size_choices: Optional[Sequence[int]] = None,
        patch_size_choice_probs: Optional[Sequence[float]] = None,
        train_seq_lens: Sequence[int] = (128, 256, 576, 784, 1024),
        max_seq_len: int = 576,
        batch_size: int = 32,  # batch size at max_seq_len: the token budget
        is_training: bool = False,
        mean=IMAGENET_DEFAULT_MEAN,
        std=IMAGENET_DEFAULT_STD,
        interpolation: str = 'bicubic',
        hflip: float = 0.5,
        mixup_alpha: float = 0.0,
        cutmix_alpha: float = 0.0,
        mixup_prob: float = 1.0,
        mixup_switch_prob: float = 0.5,
        re_prob: float = 0.0,
        re_mode: str = 'pixel',
        seed: int = 42,
        grad_accum_steps: int = 1,
        device_augment: bool = False,
        bucket_mode: str = 'budget',
        device_prefetch: int = 0,
        device=None,
        **kwargs,
):
    """The NaFlex loader, as the JAX package's ``create_naflex_loader``.

    With gradient accumulation the token budget scales by the accumulation
    steps, so each microbatch of the step is ``batch_size`` at
    ``max_seq_len``. ``device_augment=True`` moves the normalize and the
    erase fill into the augment program on ``device`` (one CUDA graph per
    bucket shape); the host ships [0, 1] patches and erase-token masks.
    ``device_prefetch > 0`` copies batches to ``device`` ahead of the step
    on a side stream."""
    process_index, process_count = _process_index_count()
    tokens_per_batch = batch_size * max(1, grad_accum_steps) * max_seq_len
    seq_lens = train_seq_lens if is_training else (max_seq_len,)
    loader = NaFlexLoader(
        dataset,
        tokens_per_batch=tokens_per_batch,
        seq_lens=seq_lens,
        patch_size=patch_size,
        patch_size_choices=patch_size_choices,
        patch_size_choice_probs=patch_size_choice_probs,
        is_training=is_training,
        mean=mean,
        std=std,
        interpolation=interpolation,
        hflip=hflip,
        mixup_alpha=mixup_alpha,
        cutmix_alpha=cutmix_alpha,
        mixup_prob=mixup_prob,
        mixup_switch_prob=mixup_switch_prob,
        re_prob=re_prob,
        re_mode=re_mode,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
        batch_divisor=max(1, grad_accum_steps),
        device_augment=device_augment,
        bucket_mode=bucket_mode,
    )
    if device_prefetch:
        from .loader import DevicePrefetcher
        loader = DevicePrefetcher(loader, size=device_prefetch, device=device)
    if device_augment:
        from .device_augment import NaFlexDeviceAugment
        loader = NaFlexDeviceAugment(loader, mean=mean, std=std, re_mode=re_mode, noise_seed=seed,
                                     device=device)
    return loader
