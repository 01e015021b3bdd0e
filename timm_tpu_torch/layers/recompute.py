"""What a layer must know when gradient checkpointing recomputes it.

``torch.utils.checkpoint`` reruns a block's forward in the backward pass. Two
things in the port's layers must not happen twice:

* Random draws. The drop layers draw from the model's own
  ``torch.Generator`` (``layers/drop.py``), which checkpoint's
  ``preserve_rng_state`` does not cover: a recompute would draw other masks
  (wrong gradients) and move the generator on (a step that no longer resumes
  bit for bit). So every draw of a drop layer goes through ``draw``: inside a
  checkpointed forward it is recorded on a tape, and the recompute reads the
  tape back instead of drawing. The generator moves exactly as in a step
  without checkpointing. The tape holds the masks (a few bytes a sample for
  drop path) until the recompute has run.
* Running statistics. A BatchNorm in train mode updates them in place; the
  recompute must not update them again (``recomputing()``).

``checkpoint_contexts`` gives the two context managers that
``checkpoint(..., context_fn=...)`` enters around the forward and the
recompute. The active tape is thread-local: autograd may run the recompute on
its own device thread, and the recompute's context is entered there.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Tuple

import torch

__all__ = ['checkpoint_contexts', 'draw', 'recomputing']

_STATE = threading.local()


class _Tape:
    """The draws of one checkpointed forward, in order."""

    def __init__(self):
        self.draws: List[torch.Tensor] = []
        self.pos = 0
        self.replaying = False

    def draw(self, make: Callable[[], torch.Tensor]) -> torch.Tensor:
        if not self.replaying:
            out = make()
            self.draws.append(out)
            return out
        if self.pos >= len(self.draws):
            raise RuntimeError('a recompute drew more random numbers than its forward')
        out = self.draws[self.pos]
        self.pos += 1
        return out


@contextlib.contextmanager
def _active(tape: _Tape, replay: bool):
    prev = getattr(_STATE, 'tape', None)
    _STATE.tape = tape
    tape.replaying, tape.pos = replay, 0
    try:
        yield
    finally:
        _STATE.tape = prev


def checkpoint_contexts() -> Tuple[contextlib.AbstractContextManager,
                                   contextlib.AbstractContextManager]:
    """(forward context, recompute context) sharing one new tape: the
    ``context_fn`` of a non-reentrant ``torch.utils.checkpoint``."""
    tape = _Tape()
    return _active(tape, False), _active(tape, True)


def draw(make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()``, a layer's random draw; inside a checkpointed region it
    is recorded on the forward and read back on the recompute."""
    tape = getattr(_STATE, 'tape', None)
    return make() if tape is None else tape.draw(make)


def recomputing() -> bool:
    """Whether the code runs inside a checkpoint's recompute."""
    tape = getattr(_STATE, 'tape', None)
    return tape is not None and tape.replaying
