from .attention import Attention, maybe_add_mask, scaled_dot_product_attention
from .config import softmax_with_policy
from .create_act import gelu, get_act_fn
from .drop import (
    DropPath, Dropout, apply_keep_mask, calculate_drop_path_rates, drop_path, dropout,
    get_drop_generator, set_drop_generator,
)
from .layer_scale import LayerScale
from .linear import Linear
from .mlp import Mlp
from .norm import LayerNorm
from .patch_embed import PatchEmbed
from .pool import global_pool_nlc
from .weight_init import lecun_normal_, trunc_normal_
