from .checkpoint_saver import CheckpointSaver
from .clip_grad import (
    adaptive_clip_grad, clip_grad_norm, clip_grad_value, clip_scale, dispatch_clip_grad,
    global_grad_norm,
)
from .log import FormatterNoInfo, setup_default_logging
from .metrics import AverageMeter, accuracy, eval_metrics
from .model_ema import ModelEmaV3, ema_update
from .random import random_seed
from .serialization import add_prefix, load_module_arrays, module_arrays, split_prefix, to_numpy
from .summary import get_outdir, update_summary
