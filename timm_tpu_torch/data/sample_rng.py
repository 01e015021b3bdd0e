"""The streams a sample's random transforms draw from.

The loader's worker thread sets, before it decodes and transforms a
sample, a ``random.Random`` and a ``np.random.RandomState`` keyed by the
loader's seed, the epoch and the sample's position in the epoch
(``set_sample_key``); the transforms draw Python's draws from
``sample_rng()`` and numpy's (RandAugment's op choice, AugMix's weights and
depths) from ``sample_np_rng()``. So the images of an epoch do not depend on
how the worker threads interleave, and a resumed run sees the same images
as an uninterrupted one. Outside a worker (nothing set on the thread) the
transforms draw from Python's global ``random`` and numpy's global
``np.random``, as the JAX package's do.
"""
from __future__ import annotations

import hashlib
import random
import threading
from typing import Optional

import numpy as np

__all__ = ['sample_np_rng', 'sample_rng', 'set_sample_key', 'set_sample_rng']

_sample = threading.local()


def sample_rng():
    """This thread's Python stream: the one ``set_sample_rng`` set, else the
    global ``random`` module."""
    return getattr(_sample, 'rng', None) or random


def sample_np_rng():
    """This thread's numpy stream: the ``RandomState`` ``set_sample_rng``
    set, else the global ``np.random`` module."""
    return getattr(_sample, 'np_rng', None) or np.random


def set_sample_rng(rng: Optional[random.Random],
                   np_rng: Optional[np.random.RandomState] = None) -> None:
    """Set (or, with None, clear) this thread's two streams."""
    _sample.rng = rng
    _sample.np_rng = np_rng


def set_sample_key(key: str) -> None:
    """Both streams of this thread from one key: ``random.Random(key)`` and
    a ``RandomState`` seeded by the key's SHA-256."""
    words = np.frombuffer(hashlib.sha256(key.encode()).digest(), dtype=np.uint32)
    set_sample_rng(random.Random(key), np.random.RandomState(words))
