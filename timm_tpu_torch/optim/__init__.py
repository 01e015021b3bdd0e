from ._optim_factory import create_optimizer_v2, list_optimizers
from ._optimizers import (
    NS_COEFFS, NS_STEPS, SGD, SGDW, SM3, AdaBelief, Adadelta, Adafactor, Adagrad, Adam, Adamax,
    AdamP, AdamW, Adan, Adopt, Lamb, Laprop, Lars, Lion, Madgrad, Mars, Muon, NAdamW, NovoGrad,
    RAdam, RMSprop, Yogi, factored_dims, orthogonalize_via_newton_schulz,
)
from ._param_groups import auto_group_layers, param_groups_layer_decay, param_groups_weight_decay
