from .attention import Attention, maybe_add_mask, scaled_dot_product_attention
from .classifier import ClassifierHead, NormMlpClassifierHead, create_classifier
from .config import softmax_with_policy
from .create_act import gelu, get_act_fn
from .create_conv2d import Conv2d, create_conv2d, get_padding
from .create_norm import create_norm_layer, get_norm_layer
from .drop import (
    DropPath, Dropout, apply_keep_mask, calculate_drop_path_rates, drop_path, dropout,
    get_drop_generator, set_drop_generator,
)
from .helpers import extend_tuple, make_divisible, to_2tuple
from .layer_scale import LayerScale
from .linear import Linear
from .mlp import GlobalResponseNorm, GlobalResponseNormMlp, Mlp
from .norm import LayerNorm, LayerNorm2d, LayerNormFp32, RmsNorm, RmsNorm2d, SimpleNorm, SimpleNorm2d
from .patch_embed import PatchEmbed
from .pool import SelectAdaptivePool2d, adaptive_pool_feat_mult, global_pool_nlc
from .weight_init import lecun_normal_, trunc_normal_, variance_scaling_
