"""Scheduler factory (counterpart of timm_tpu/scheduler/scheduler_factory.py):
every schedule of the JAX factory, with its cooldown, warmup prefix, noise,
cycles and k-decay; ``scheduler_kwargs`` reads them from the drivers' flags."""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

from .cosine_lr import CosineLRScheduler
from .step_lr import MultiStepLRScheduler, PlateauLRScheduler, PolyLRScheduler, StepLRScheduler
from .tanh_lr import TanhLRScheduler

__all__ = ['create_scheduler_v2', 'scheduler_kwargs']


def scheduler_kwargs(cfg, decreasing_metric: Optional[bool] = None) -> dict:
    """Build factory kwargs from an argparse-style cfg namespace
    (the train driver's flags)."""
    eval_metric = getattr(cfg, 'eval_metric', 'top1')
    if decreasing_metric is not None:
        plateau_mode = 'min' if decreasing_metric else 'max'
    else:
        plateau_mode = 'min' if 'loss' in eval_metric else 'max'
    kwargs = dict(
        sched=cfg.sched,
        num_epochs=getattr(cfg, 'epochs', 300),
        decay_epochs=getattr(cfg, 'decay_epochs', 90),
        decay_milestones=getattr(cfg, 'decay_milestones', (90, 180, 270)),
        warmup_epochs=getattr(cfg, 'warmup_epochs', 5),
        cooldown_epochs=getattr(cfg, 'cooldown_epochs', 0),
        patience_epochs=getattr(cfg, 'patience_epochs', 10),
        decay_rate=getattr(cfg, 'decay_rate', 0.1),
        min_lr=getattr(cfg, 'min_lr', 0.0),
        warmup_lr=getattr(cfg, 'warmup_lr', 1e-5),
        warmup_prefix=getattr(cfg, 'warmup_prefix', False),
        noise=getattr(cfg, 'lr_noise', None),
        noise_pct=getattr(cfg, 'lr_noise_pct', 0.67),
        noise_std=getattr(cfg, 'lr_noise_std', 1.0),
        noise_seed=getattr(cfg, 'seed', 42),
        cycle_mul=getattr(cfg, 'lr_cycle_mul', 1.0),
        cycle_decay=getattr(cfg, 'lr_cycle_decay', 0.1),
        cycle_limit=getattr(cfg, 'lr_cycle_limit', 1),
        k_decay=getattr(cfg, 'lr_k_decay', 1.0),
        plateau_mode=plateau_mode,
        step_on_epochs=not getattr(cfg, 'sched_on_updates', False),
    )
    return kwargs


def create_scheduler_v2(
        base_lr: Union[float, List[float]] = 0.1,
        sched: str = 'cosine',
        num_epochs: int = 300,
        decay_epochs: int = 90,
        decay_milestones: List[int] = (90, 180, 270),
        cooldown_epochs: int = 0,
        patience_epochs: int = 10,
        decay_rate: float = 0.1,
        min_lr: float = 0.0,
        warmup_lr: float = 1e-5,
        warmup_epochs: int = 0,
        warmup_prefix: bool = False,
        noise: Union[float, List[float], None] = None,
        noise_pct: float = 0.67,
        noise_std: float = 1.0,
        noise_seed: int = 42,
        cycle_mul: float = 1.0,
        cycle_decay: float = 0.1,
        cycle_limit: int = 1,
        k_decay: float = 1.0,
        plateau_mode: str = 'max',
        step_on_epochs: bool = True,
        updates_per_epoch: int = 0,
):
    """Returns (scheduler, num_epochs_with_cooldown)."""
    t_initial = num_epochs
    warmup_t = warmup_epochs
    decay_t = decay_epochs
    cooldown_t = cooldown_epochs

    if not step_on_epochs:
        if updates_per_epoch <= 0:
            raise ValueError('updates_per_epoch must be set when stepping on updates')
        t_initial = t_initial * updates_per_epoch
        warmup_t = warmup_t * updates_per_epoch
        decay_t = decay_t * updates_per_epoch
        decay_milestones = [d * updates_per_epoch for d in decay_milestones]
        cooldown_t = cooldown_t * updates_per_epoch

    if noise is not None:
        if isinstance(noise, (list, tuple)):
            noise_range = [n * t_initial for n in noise]
            if len(noise_range) == 1:
                noise_range = noise_range[0]
        else:
            noise_range = noise * t_initial
    else:
        noise_range = None

    noise_args = dict(
        noise_range_t=noise_range,
        noise_pct=noise_pct,
        noise_std=noise_std,
        noise_seed=noise_seed,
    )
    cycle_args = dict(
        cycle_mul=cycle_mul,
        cycle_decay=cycle_decay,
        cycle_limit=cycle_limit,
    )

    lr_scheduler = None
    if sched == 'cosine':
        lr_scheduler = CosineLRScheduler(
            base_lr,
            t_initial=t_initial,
            lr_min=min_lr,
            warmup_lr_init=warmup_lr,
            warmup_t=warmup_t,
            t_in_epochs=step_on_epochs,
            warmup_prefix=warmup_prefix,
            k_decay=k_decay,
            **cycle_args,
            **noise_args,
        )
    elif sched == 'tanh':
        lr_scheduler = TanhLRScheduler(
            base_lr,
            t_initial=t_initial,
            lr_min=min_lr,
            warmup_lr_init=warmup_lr,
            warmup_t=warmup_t,
            t_in_epochs=step_on_epochs,
            warmup_prefix=warmup_prefix,
            **cycle_args,
            **noise_args,
        )
    elif sched == 'step':
        lr_scheduler = StepLRScheduler(
            base_lr,
            decay_t=decay_t,
            decay_rate=decay_rate,
            warmup_lr_init=warmup_lr,
            warmup_t=warmup_t,
            t_in_epochs=step_on_epochs,
            **noise_args,
        )
    elif sched == 'multistep':
        lr_scheduler = MultiStepLRScheduler(
            base_lr,
            decay_t=list(decay_milestones),
            decay_rate=decay_rate,
            warmup_lr_init=warmup_lr,
            warmup_t=warmup_t,
            t_in_epochs=step_on_epochs,
            **noise_args,
        )
    elif sched == 'plateau':
        if not step_on_epochs:
            raise ValueError('Plateau LR only supports step per epoch.')
        lr_scheduler = PlateauLRScheduler(
            base_lr,
            decay_rate=decay_rate,
            patience_t=patience_epochs,
            cooldown_t=0,
            warmup_lr_init=warmup_lr,
            warmup_t=warmup_t,
            lr_min=min_lr,
            mode=plateau_mode,
            **noise_args,
        )
    elif sched == 'poly':
        lr_scheduler = PolyLRScheduler(
            base_lr,
            power=decay_rate,  # overloaded 'power' via decay_rate (ref behavior)
            t_initial=t_initial,
            lr_min=min_lr,
            warmup_lr_init=warmup_lr,
            warmup_t=warmup_t,
            t_in_epochs=step_on_epochs,
            k_decay=k_decay,
            warmup_prefix=warmup_prefix,
            **cycle_args,
            **noise_args,
        )
    elif sched in ('none', ''):
        lr_scheduler = None
    else:
        raise ValueError(f'Unknown scheduler: {sched}')

    if hasattr(lr_scheduler, 'get_cycle_length'):
        t_with_cycles_and_cooldown = lr_scheduler.get_cycle_length() + cooldown_t
        if step_on_epochs:
            num_epochs = t_with_cycles_and_cooldown
        else:
            num_epochs = t_with_cycles_and_cooldown // updates_per_epoch
    else:
        num_epochs = num_epochs + cooldown_epochs

    return lr_scheduler, num_epochs
