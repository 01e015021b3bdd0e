from ._optim_factory import create_optimizer_v2
from ._optimizers import SGD, AdamW
from ._param_groups import param_groups_weight_decay
