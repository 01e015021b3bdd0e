from .clip_grad import (
    adaptive_clip_grad, clip_grad_norm, clip_grad_value, clip_scale, dispatch_clip_grad,
    global_grad_norm,
)
from .model_ema import ModelEmaV3, ema_update
