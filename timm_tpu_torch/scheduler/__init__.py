from .cosine_lr import CosineLRScheduler
from .scheduler import Scheduler
from .scheduler_factory import create_scheduler_v2
