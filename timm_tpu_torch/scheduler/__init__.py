from .cosine_lr import CosineLRScheduler
from .scheduler import Scheduler
from .scheduler_factory import create_scheduler_v2, scheduler_kwargs
from .step_lr import MultiStepLRScheduler, PlateauLRScheduler, PolyLRScheduler, StepLRScheduler
from .tanh_lr import TanhLRScheduler
