"""Bucketed batch shapes for serving (a copy of timm_tpu/serve/bucketing.py,
kept by the port so that it imports nothing of the JAX package).

The serving engine declares a SMALL fixed set of batch buckets up front
(e.g. 1/4/16/64/256), warms exactly those shapes at startup, and pads every
admitted run up to the smallest fitting bucket with masked slots whose
outputs are stripped on the host. No shape outside the declared set is ever
dispatched, so the kernels see a fixed family of shapes.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = [
    'DEFAULT_BUCKETS', 'validate_buckets', 'select_bucket', 'batch_bucket',
    'pad_rows', 'strip_rows',
]

# powers-of-4 ladder: at most ~4x padded waste per admitted run, 5 programs
# to AOT-compile per model at startup
DEFAULT_BUCKETS = (1, 4, 16, 64, 256)


def validate_buckets(buckets: Sequence[int], divisor: int = 1) -> Tuple[int, ...]:
    """Normalize a declared bucket set: unique positive ints, ascending.

    ``divisor`` is the mesh batch-shard count — every bucket must divide over
    it or the padded batch could never be sharded (shard_batch would raise at
    serve time; failing at engine construction names the problem instead).
    """
    if not buckets:
        raise ValueError('declared bucket set is empty; serving needs at least one batch bucket')
    out = sorted({int(b) for b in buckets})
    if out[0] <= 0:
        raise ValueError(f'batch buckets must be positive, got {tuple(buckets)}')
    if divisor > 1:
        bad = [b for b in out if b % divisor != 0]
        if bad:
            raise ValueError(
                f'bucket(s) {bad} are not divisible by the mesh batch-shard count '
                f'{divisor}: every bucket shape is sharded over the product of ALL '
                f'mesh axes. Declare buckets that are multiples of {divisor} '
                f'(e.g. {[max(b // divisor, 1) * divisor for b in bad]}).')
    return tuple(out)


def select_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest declared bucket that fits ``n`` requests.

    The queue never admits more than the largest bucket in one run, so an
    oversized ``n`` here is a scheduling bug — refused loudly rather than
    silently handed to the compiler as a novel shape.
    """
    if n <= 0:
        raise ValueError(f'cannot bucket a batch of {n} requests')
    for b in buckets:
        if n <= b:
            return int(b)
    raise ValueError(
        f'{n} requests exceed the largest declared bucket {max(buckets)}; '
        f'the admission queue must split runs to at most the largest bucket')


def batch_bucket(batch_size: int, divisor: int = 1) -> int:
    """The single padded batch shape for a fixed-batch-size eval loop:
    ``batch_size`` rounded up to the mesh batch-shard count, so every batch —
    including the final partial one — runs through ONE compiled executable."""
    divisor = max(1, int(divisor))
    return -(-int(batch_size) // divisor) * divisor


def pad_rows(x: np.ndarray, bucket: int, *more) -> Tuple:
    """Pad arrays up to ``bucket`` rows with masked slots.

    Slots are filled by repeating row 0 (finite, in-distribution values — a
    zero image would be the only all-black sample the model ever sees, and
    NaN-poisoned padding would trip the non-finite sentinel in shared code
    paths). Returns ``(x_padded, *more_padded, valid)`` where ``valid`` is a
    bool mask marking real rows; consumers drop padded-slot outputs with
    ``strip_rows`` (or fold ``valid`` into their reduction like validate.py).
    Torch tensors pad on their own device (``valid`` stays numpy).
    """
    arrays = (x,) + more
    n = int(arrays[0].shape[0])
    if n > bucket:
        raise ValueError(f'batch of {n} rows does not fit bucket {bucket}')
    for a in arrays[1:]:
        if int(a.shape[0]) != n:
            raise ValueError(f'row-count mismatch: {n} vs {a.shape[0]}')
    valid = np.zeros(bucket, bool)
    valid[:n] = True
    if n == bucket:
        return arrays + (valid,)
    out = []
    for a in arrays:
        if hasattr(a, 'expand') and hasattr(a, 'device'):  # a torch tensor
            import torch
            out.append(torch.cat([a, a[:1].expand(bucket - n, *a.shape[1:])]))
            continue
        a = np.asarray(a)
        out.append(np.concatenate([a, np.repeat(a[:1], bucket - n, axis=0)]))
    return tuple(out) + (valid,)


def strip_rows(out, n: int):
    """Drop padded-slot rows from a step output: an array or tensor, or a
    dict, list or tuple of them."""
    if isinstance(out, dict):
        return {k: strip_rows(v, n) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(strip_rows(v, n) for v in out)
    return out[:n]
