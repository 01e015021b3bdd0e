from ._optim_factory import create_optimizer_v2, list_optimizers
from ._optimizers import (
    NS_COEFFS, NS_STEPS, SGD, AdamW, Lamb, Laprop, Madgrad, Mars, Muon, NAdamW,
    orthogonalize_via_newton_schulz,
)
from ._param_groups import auto_group_layers, param_groups_layer_decay, param_groups_weight_decay
