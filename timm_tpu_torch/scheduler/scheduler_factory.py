"""Scheduler factory (counterpart of timm_tpu/scheduler/scheduler_factory.py).

Ported: ``sched='cosine'`` with warmup, stepping on epochs or on updates,
and ``'none'``. The step, multistep, plateau, poly and tanh schedules, and
the cosine options cooldown, warmup prefix, noise, cycles and k-decay, are
not ported yet and raise ``NotImplementedError`` (ROADMAP §A.5).
"""
from __future__ import annotations

from typing import List, Union

from .cosine_lr import CosineLRScheduler

__all__ = ['create_scheduler_v2']

_NOT_PORTED = ('tanh', 'step', 'multistep', 'plateau', 'poly')
# Options of the JAX factory this port does not have yet, at their defaults.
_NOT_PORTED_OPTIONS = dict(
    cooldown_epochs=0, warmup_prefix=False, noise=None, noise_pct=0.67, noise_std=1.0,
    noise_seed=42, cycle_mul=1.0, cycle_decay=0.1, cycle_limit=1, k_decay=1.0)


def create_scheduler_v2(
        base_lr: Union[float, List[float]] = 0.1,
        sched: str = 'cosine',
        num_epochs: int = 300,
        min_lr: float = 0.0,
        warmup_lr: float = 1e-5,
        warmup_epochs: int = 0,
        step_on_epochs: bool = True,
        updates_per_epoch: int = 0,
        **options,
):
    """Returns (scheduler, num_epochs_with_cooldown)."""
    if sched in _NOT_PORTED:
        raise NotImplementedError(
            f"scheduler {sched!r} is not ported yet (ROADMAP §A.5); the port has 'cosine'")
    if sched not in ('cosine', 'none', ''):
        raise ValueError(f'Unknown scheduler: {sched}')
    for name, value in options.items():
        if name not in _NOT_PORTED_OPTIONS:
            raise TypeError(f'create_scheduler_v2() got an unexpected keyword argument {name!r}')
        if value != _NOT_PORTED_OPTIONS[name]:
            raise NotImplementedError(
                f'scheduler option {name}={value!r} is not ported yet (ROADMAP §A.5)')
    if sched != 'cosine':
        return None, num_epochs
    t_initial = num_epochs
    warmup_t = warmup_epochs
    if not step_on_epochs:
        if updates_per_epoch <= 0:
            raise ValueError('updates_per_epoch must be set when stepping on updates')
        t_initial = t_initial * updates_per_epoch
        warmup_t = warmup_t * updates_per_epoch
    lr_scheduler = CosineLRScheduler(
        base_lr,
        t_initial=t_initial,
        lr_min=min_lr,
        warmup_lr_init=warmup_lr,
        warmup_t=warmup_t,
        t_in_epochs=step_on_epochs,
    )
    return lr_scheduler, num_epochs
