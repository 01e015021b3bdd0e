"""Batch loader with threaded decode and a CUDA-stream device prefetcher
(counterpart of timm_tpu/data/loader.py).

  * ``ThreadedLoader``: worker threads decode and transform samples (PIL
    releases the GIL in its codecs), a bounded queue pipelines them, and a
    collator thread stacks numpy batches; the index order, the drop_last
    rule and the poison-sample budget are the JAX package's. Unlike the JAX
    loader, which collates training batches in arrival order and lets its
    random transforms draw from the global ``random`` and ``np.random`` in
    whichever thread runs first, each sample's transforms draw from streams
    keyed by seed, process, epoch and position (data/sample_rng.py) and
    batches collate in epoch order: an epoch is the same whatever the worker
    count and thread timing, so a resumed run sees the images an
    uninterrupted one saw. AugMix's tuple samples collate split-major.
    Worker threads never touch CUDA.
  * ``DevicePrefetcher``: pins each host batch and copies it to the card on
    a side stream, keeping up to ``size`` batches in flight, so the copy of
    batch k+1 overlaps the step on batch k.
  * ``create_loader``: the pipeline derived from the loader arguments, with
    the device augment stage (``device_augment=True``) at its end.

``StreamingLoader`` (iterable datasets) and fault injection wait (ROADMAP A.5).
"""
from __future__ import annotations

import collections
import math
import queue
import threading
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..resilience import SkipBudget, TooManyBadSamples, retry_io
from .constants import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from .device_augment import DeviceAugmentStage
from .mixup import FastCollateMixup
from .random_erasing import RandomErasing
from .sample_rng import set_sample_key

__all__ = ['create_loader', 'DevicePrefetcher', 'ThreadedLoader']

# marker a worker emits for a sample dropped against the poison budget, so the
# collator keeps its consumed-count bookkeeping without padding the batch
_SKIPPED = object()


class DevicePrefetcher:
    """Double-buffer device-prefetch stage over any (image, target) numpy
    batch iterable.

    Each host batch is pinned (``pin_memory``) and copied with
    ``non_blocking=True`` on the prefetcher's own ``torch.cuda.Stream``;
    up to ``size`` batches are in flight. Before a batch is yielded the
    consumer's current stream waits for that batch's copies (an event
    recorded after them, so it does not also wait for the copies of later
    batches), and each tensor is ``record_stream``-ed on the consumer's
    stream so the allocator keeps its memory until the consumer is done.
    On ``device='cpu'`` batches become CPU tensors.

    Drain/stop semantics: early termination of the consumer (``break``,
    an exception) closes the inner iterator through the generator's
    ``finally`` (worker threads observe their stop event and exit), and
    prefetched-but-unyielded batches are dropped. Attribute access
    (``len()``, ``mean``/``std``, ``set_epoch``...) delegates to the
    wrapped loader.
    """

    def __init__(self, loader, size: int = 2, device=None):
        self.loader = loader
        self.size = max(1, int(size))
        self.device = resolve_device(device)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return len(self.loader)

    def _copy(self, batch, stream):
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
        if stream is None:
            return tensors, None
        with torch.cuda.stream(stream):
            tensors = [t.pin_memory().to(self.device, non_blocking=True) for t in tensors]
            done = torch.cuda.Event()
            done.record(stream)
        return tensors, done

    def __iter__(self):
        stream = torch.cuda.Stream(self.device) if self.device.type == 'cuda' else None
        buf = collections.deque()
        it = iter(self.loader)
        try:
            while len(buf) < self.size:
                try:
                    buf.append(self._copy(next(it), stream))
                except StopIteration:
                    break
            while buf:
                tensors, done = buf.popleft()
                try:
                    buf.append(self._copy(next(it), stream))
                except StopIteration:
                    pass
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    for t in tensors:
                        t.record_stream(consumer)
                yield tuple(tensors)
        finally:
            buf.clear()
            close = getattr(it, 'close', None)
            if close is not None:
                close()


def _collate_arrays(imgs, targets):
    """Stack a list of samples; AugMix tuple samples (clean, aug1, ...) are
    concatenated split-major along the batch, their targets tiled per
    split."""
    if isinstance(imgs[0], (tuple, list)):
        n_splits = len(imgs[0])
        x = np.concatenate([np.stack([im[j] for im in imgs]) for j in range(n_splits)])
        return x, np.tile(np.asarray(targets), n_splits)
    return np.stack(imgs), np.asarray(targets)


class ThreadedLoader:
    def __init__(
            self,
            dataset,
            batch_size: int,
            is_training: bool = False,
            num_workers: int = 4,
            drop_last: Optional[bool] = None,
            shuffle: Optional[bool] = None,
            seed: int = 42,
            num_aug_repeats: int = 0,
            prefetch: int = 4,
            re_prob: float = 0.0,
            re_mode: str = 'const',
            re_count: int = 1,
            re_num_splits: int = 0,
            mean=IMAGENET_DEFAULT_MEAN,
            std=IMAGENET_DEFAULT_STD,
            process_index: int = 0,
            process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.is_training = is_training
        self.num_workers = max(1, num_workers)
        self.drop_last = is_training if drop_last is None else drop_last
        self.shuffle = is_training if shuffle is None else shuffle
        self.seed = seed
        self.epoch = 0
        self.prefetch = prefetch
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.random_erasing = RandomErasing(
            probability=re_prob, mode=re_mode, min_count=re_count,
            num_splits=re_num_splits, mean=self.mean, std=self.std,
            seed=seed) if re_prob > 0 and is_training else None
        self.process_index = process_index
        self.process_count = process_count
        self.num_aug_repeats = num_aug_repeats if is_training else 0

        self._local_indices = self._shard_indices(shuffled=False)

    def _repeat_aug_indices(self, rng) -> np.ndarray:
        """Repeated-augmentation sampling (reference distributed_sampler.py:54
        RepeatAugSampler): each sample appears `num_repeats` times adjacent in
        the shuffled order, replicas take interleaved slices, and each replica
        truncates to ~len(dataset)/replicas samples per epoch."""
        n = len(self.dataset)
        reps = self.num_aug_repeats
        world = max(1, self.process_count)
        indices = np.arange(n)
        if self.shuffle:
            rng.shuffle(indices)
        indices = np.repeat(indices, reps)
        num_samples = int(math.ceil(n * reps / world))
        total = num_samples * world
        indices = np.concatenate([indices, indices[:total - len(indices)]])
        local = indices[self.process_index::world]
        # selected_round=256, selected_ratio=world (reference defaults)
        num_selected = int(math.floor(n // 256 * 256 / world)) if n >= 256 \
            else int(math.ceil(n / world))
        return local[:num_selected]

    def _shard_indices(self, shuffled: bool):
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.num_aug_repeats:
            return self._repeat_aug_indices(rng)
        n = len(self.dataset)
        indices = np.arange(n)
        if shuffled:
            rng.shuffle(indices)
        if self.process_count > 1:
            # pad to equal per-process length (reference OrderedDistributedSampler)
            per_host = -(-n // self.process_count)
            padded = np.concatenate([indices, indices[:per_host * self.process_count - n]])
            indices = padded[self.process_index::self.process_count]
        return indices

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if self.random_erasing is not None:
            self.random_erasing.set_epoch(epoch)  # resume-reproducible stream

    def __len__(self):
        n = len(self._local_indices)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        indices = self._shard_indices(shuffled=self.shuffle)
        num_batches = len(indices) // self.batch_size if self.drop_last \
            else -(-len(indices) // self.batch_size)

        sample_q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch * self.batch_size)
        batch_q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(q, item) -> bool:
            # put that stays responsive to shutdown (early-terminated iteration)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        skip_budget = SkipBudget()

        def load(pos, idx):
            set_sample_key(f'{self.seed}/{self.process_index}/{self.epoch}/{pos}')
            return self.dataset[idx]

        def worker(worker_jobs):
            for pos, idx in worker_jobs:
                if stop.is_set():
                    return
                idx = int(idx)
                try:
                    # transient I/O faults (OSError) ride through jittered
                    # exponential backoff; anything still failing is poison
                    sample = retry_io(lambda: load(pos, idx), retries=3, base_delay=0.05,
                                      desc=f'sample {idx}')
                except Exception as e:
                    try:
                        skip_budget.record(e, f'sample index {int(idx)}')
                        sample = _SKIPPED
                    except TooManyBadSamples as fatal:
                        sample = fatal  # budget exhausted: fail the epoch loudly
                if not _put(sample_q, (pos, sample)):
                    return

        used = indices[:num_batches * self.batch_size] if self.drop_last else indices
        jobs = list(enumerate(used))
        threads = [threading.Thread(target=worker, args=(jobs[w::self.num_workers],), daemon=True)
                   for w in range(self.num_workers)]

        def collator():
            # samples collate in epoch order, by position (repeated
            # augmentation repeats indices, never positions)
            pending = {}
            n_used = len(used)
            pos = 0
            consumed = 0
            batch_imgs, batch_targets = [], []

            def emit(force_last: bool):
                nonlocal batch_imgs, batch_targets
                if len(batch_imgs) == self.batch_size or (force_last and batch_imgs and not self.drop_last):
                    x, t = _collate_arrays(batch_imgs, batch_targets)
                    if self.random_erasing is not None:
                        x = self.random_erasing(x)
                    ok = _put(batch_q, (x, t))
                    batch_imgs, batch_targets = [], []
                    return ok
                return True

            try:
                while consumed < n_used and not stop.is_set():
                    try:
                        at, sample = sample_q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    consumed += 1
                    if isinstance(sample, Exception):
                        raise sample
                    pending[at] = sample
                    while pos in pending:
                        s = pending.pop(pos)
                        pos += 1
                        if s is not _SKIPPED:
                            img, target = s
                            batch_imgs.append(img)
                            batch_targets.append(target)
                        if not emit(force_last=pos == n_used):
                            return
            except Exception as e:
                _put(batch_q, e)
            finally:
                _put(batch_q, None)

        threads.append(threading.Thread(target=collator, daemon=True))
        for t in threads:
            t.start()

        try:
            while True:
                item = batch_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so blocked threads can observe stop and exit; a worker
            # finishes the sample it is reading first, so none outlives the
            # iteration (and the files it reads)
            try:
                while True:
                    batch_q.get_nowait()
            except queue.Empty:
                pass
            for t in threads:
                t.join(timeout=5.0)

    @property
    def sampler(self):
        return self  # set_epoch lives here; parity shim


def _process_index_count():
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def create_loader(
        dataset,
        input_size,
        batch_size: int,
        is_training: bool = False,
        no_aug: bool = False,
        re_prob: float = 0.0,
        re_mode: str = 'const',
        re_count: int = 1,
        re_split: bool = False,
        train_crop_mode=None,
        scale=None,
        ratio=None,
        hflip: float = 0.5,
        vflip: float = 0.0,
        color_jitter: float = 0.4,
        color_jitter_prob=None,
        grayscale_prob: float = 0.0,
        gaussian_blur_prob: float = 0.0,
        auto_augment=None,
        num_aug_repeats: int = 0,
        num_aug_splits: int = 0,
        interpolation: str = 'bilinear',
        mean=IMAGENET_DEFAULT_MEAN,
        std=IMAGENET_DEFAULT_STD,
        num_workers: int = 4,
        crop_pct: Optional[float] = None,
        crop_mode: Optional[str] = None,
        crop_border_pixels: Optional[int] = None,
        collate_fn=None,
        fp16: bool = False,
        drop_last: Optional[bool] = None,
        seed: int = 42,
        device_prefetch: int = 0,
        device_augment: bool = False,
        mixup=None,
        device=None,
        **kwargs,
):
    """(reference loader.py:205). Returns a ThreadedLoader yielding
    (images NHWC float32 [0,1], targets int) numpy batches.

    ``device_prefetch=N`` (default 0 = off) appends a DevicePrefetcher that
    keeps up to N batches in flight on ``device`` (default ``cuda``).

    ``device_augment=True`` moves RandomErasing, Mixup/CutMix (pass the
    Mixup sampler via ``mixup=``) and normalize off the host: batches
    collate as raw uint8, the host samples only the augmentation
    parameters, and the device augment stage (one CUDA graph per batch
    shape on the card: the augment-epilogue kernel for 'const' erasing,
    the torch program for 'rand' and 'pixel') does the float math on
    ``device``. The loader then yields
    (input, target) tensors, soft targets when mixup is active.

    ``num_aug_splits=N`` (with an ``AugMixDataset`` of N splits) builds the
    split pipelines and collates each batch of B samples as N * B images,
    split-major, with the targets tiled."""
    if not hasattr(dataset, '__getitem__'):
        raise NotImplementedError(
            'iterable datasets need StreamingLoader, which is not ported yet (ROADMAP A.5)')
    if device_augment:
        if isinstance(collate_fn, FastCollateMixup) or isinstance(mixup, FastCollateMixup):
            raise ValueError(
                'device_augment=True already applies mixup on device; a host-side '
                'FastCollateMixup collate would double-apply it. Pass a plain '
                'Mixup instance via mixup= (parameter sampling only) instead.')
        if not is_training:
            raise ValueError('device_augment=True is a train-path stage '
                             '(eval batches are not augmented)')
    if collate_fn is not None:
        raise NotImplementedError('custom collate_fn is not supported by ThreadedLoader')
    if device_prefetch or device_augment:
        device = resolve_device(device)

    re_num_splits = (num_aug_splits or 2) if re_split else 0

    # create_loader owns the dataset transform (reference loader.py:205 does
    # the same — the pipeline is derived from loader args); imported here so
    # that importing the package does not import PIL
    from .transforms_factory import create_transform
    dataset.transform = create_transform(
        input_size,
        is_training=is_training,
        no_aug=no_aug,
        train_crop_mode=train_crop_mode,
        scale=scale,
        ratio=ratio,
        hflip=hflip,
        vflip=vflip,
        color_jitter=color_jitter,
        color_jitter_prob=color_jitter_prob,
        grayscale_prob=grayscale_prob,
        gaussian_blur_prob=gaussian_blur_prob,
        auto_augment=auto_augment,
        interpolation=interpolation,
        mean=mean,
        std=std,
        crop_pct=crop_pct,
        crop_mode=crop_mode,
        crop_border_pixels=crop_border_pixels,
        re_prob=0.0,  # RE applied post-collate by the loader
        separate=num_aug_splits > 0,
        output_dtype=np.uint8 if device_augment else None,
    )

    process_index, process_count = _process_index_count()
    loader = ThreadedLoader(
        dataset,
        batch_size=batch_size,
        is_training=is_training,
        num_workers=num_workers,
        drop_last=drop_last,
        seed=seed,
        num_aug_repeats=num_aug_repeats,
        # device_augment: host collates raw uint8 and samples erase params
        # only — the DeviceAugmentStage below owns erase application
        re_prob=0.0 if device_augment else re_prob,
        re_mode=re_mode,
        re_count=re_count,
        re_num_splits=re_num_splits,
        mean=mean,
        std=std,
        process_index=process_index,
        process_count=process_count,
    )
    if device_prefetch:
        loader = DevicePrefetcher(loader, size=device_prefetch, device=device)
    if device_augment:
        re_sampler = RandomErasing(
            probability=re_prob, mode=re_mode, min_count=re_count,
            num_splits=re_num_splits, mean=np.asarray(mean, np.float32),
            std=np.asarray(std, np.float32), seed=seed) if re_prob > 0 else None
        loader = DeviceAugmentStage(
            loader, mean=mean, std=std, mixup=mixup, random_erasing=re_sampler,
            re_mode=re_mode, noise_seed=seed,
            out_dtype=torch.float16 if fp16 else torch.float32, device=device)
    return loader
