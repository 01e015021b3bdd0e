"""Host RNG streams for step-granular (mid-epoch) resume (counterpart of
timm_tpu/resilience/hoststate.py, the same ``_resume.`` keys).

numpy's global MT19937 and Python's ``random`` must continue from the exact
preemption point for ``--resume auto`` to be bit-identical to an
uninterrupted run. So must the ``torch.Generator`` the drop-path and
dropout masks draw from: JAX keys its dropout streams by step and needs no
capture, but the port's generator is stateful, so its state rides in every
checkpoint of a training task (``capture_drop_rng``). All values are plain
arrays, stored in the same .npz under the ``_resume.`` prefix.
"""
from __future__ import annotations

import logging
import random as _pyrandom
from typing import Dict, Optional

import numpy as np
import torch

_logger = logging.getLogger(__name__)

__all__ = ['RESUME_PREFIX', 'DROP_RNG_KEY', 'capture_host_rng', 'restore_host_rng',
           'capture_drop_rng', 'restore_drop_rng']

RESUME_PREFIX = '_resume.'
DROP_RNG_KEY = RESUME_PREFIX + 'drop_rng_state'


def capture_host_rng() -> Dict[str, np.ndarray]:
    name, keys, pos, has_gauss, cached = np.random.get_state()
    out = {
        RESUME_PREFIX + 'np_rng_keys': np.asarray(keys, np.uint32),
        RESUME_PREFIX + 'np_rng_meta': np.asarray([pos, has_gauss], np.int64),
        RESUME_PREFIX + 'np_rng_gauss': np.asarray(cached, np.float64),
    }
    version, internal, gauss_next = _pyrandom.getstate()
    if version == 3:
        out[RESUME_PREFIX + 'py_rng_state'] = np.asarray(internal, np.uint64)
        out[RESUME_PREFIX + 'py_rng_gauss'] = np.asarray(
            [1.0, gauss_next] if gauss_next is not None else [0.0, 0.0], np.float64)
    return out


def restore_host_rng(state: Dict[str, np.ndarray]) -> bool:
    """Restore streams captured by ``capture_host_rng``; True if anything
    was restored. Missing keys (end-of-epoch checkpoints do not carry them)
    are a no-op."""
    restored = False
    if '_resume.np_rng_keys' in state:
        meta = np.asarray(state['_resume.np_rng_meta'])
        np.random.set_state((
            'MT19937',
            np.asarray(state['_resume.np_rng_keys'], np.uint32),
            int(meta[0]), int(meta[1]),
            float(np.asarray(state['_resume.np_rng_gauss'])),
        ))
        restored = True
    if '_resume.py_rng_state' in state:
        gauss = np.asarray(state['_resume.py_rng_gauss'])
        _pyrandom.setstate((
            3,
            tuple(int(x) for x in np.asarray(state['_resume.py_rng_state'])),
            float(gauss[1]) if gauss[0] else None,
        ))
        restored = True
    if restored:
        _logger.info('Restored host RNG streams from recovery checkpoint')
    return restored


def capture_drop_rng(generator: Optional[torch.Generator]) -> Dict[str, np.ndarray]:
    """``{DROP_RNG_KEY: uint8 state}`` of the drop-path / dropout generator
    (empty without one)."""
    if generator is None:
        return {}
    return {DROP_RNG_KEY: generator.get_state().numpy().copy()}


def restore_drop_rng(state: Dict[str, np.ndarray], generator: Optional[torch.Generator]) -> bool:
    """Set the generator to the state ``capture_drop_rng`` stored; True if
    it did. A checkpoint without the key (JAX's, or a model without drop
    layers) leaves the generator as it is."""
    if generator is None or DROP_RNG_KEY not in state:
        return False
    generator.set_state(torch.from_numpy(np.ascontiguousarray(state[DROP_RNG_KEY], np.uint8)))
    return True
