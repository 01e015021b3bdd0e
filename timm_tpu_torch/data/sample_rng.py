"""The stream a sample's random transforms draw from.

The loader's worker thread sets, before it decodes and transforms a
sample, a ``random.Random`` keyed by the loader's seed, the epoch and the
sample's position in the epoch; the transforms draw from ``sample_rng()``.
So the images of an epoch do not depend on how the worker threads
interleave, and a resumed run sees the same images as an uninterrupted one.
Outside a worker (``set_sample_rng`` never called on the thread) the
transforms draw from Python's global ``random``, as the JAX package's do.
"""
from __future__ import annotations

import random
import threading
from typing import Optional

__all__ = ['sample_rng', 'set_sample_rng']

_sample = threading.local()


def sample_rng():
    """This thread's stream: the one ``set_sample_rng`` set, else the
    global ``random`` module."""
    return getattr(_sample, 'rng', None) or random


def set_sample_rng(rng: Optional[random.Random]) -> None:
    _sample.rng = rng
