from .attention import Attention, SeqPadMask, maybe_add_mask, scaled_dot_product_attention
from .blur_pool import AvgPool2dAA, BlurPool2d
from .classifier import ClassifierHead, NormMlpClassifierHead, create_classifier
from .config import softmax_with_policy
from .cond_conv2d import CondConv2d
from .create_act import gelu, get_act_fn
from .create_attn import create_attn, get_attn
from .create_conv2d import (
    Conv2d, ConvNormAct, SeparableConvNormAct, create_conv2d, get_aa_layer, get_padding,
)
from .create_norm import create_norm_layer, get_norm_layer
from .diff_attention import DiffAttention
from .eca import CecaModule, EcaModule
from .drop import (
    DropPath, Dropout, apply_keep_mask, calculate_drop_path_rates, drop_path, dropout,
    get_drop_generator, set_drop_generator,
)
from .helpers import extend_tuple, make_divisible, to_2tuple
from .layer_scale import LayerScale
from .linear import Linear
from .mixed_conv2d import MixedConv2d
from .mlp import GlobalResponseNorm, GlobalResponseNormMlp, Mlp
from .norm import (
    BatchNorm2d, GroupNorm, GroupNorm1, LayerNorm, LayerNorm2d, LayerNormFp32, RmsNorm, RmsNorm2d,
    SimpleNorm, SimpleNorm2d,
)
from .norm_act import (
    BatchNormAct2d, FrozenBatchNormAct2d, GroupNorm1Act, GroupNormAct, LayerNormAct,
    LayerNormAct2d, get_norm_act_layer,
)
from .patch_embed import PatchEmbed, resample_patch_embed, resample_weight_matrix
from .pool import SelectAdaptivePool2d, adaptive_pool_feat_mult, global_pool_nlc
from .split_batchnorm import SplitBatchNorm2d, SplitBatchNormAct2d, convert_splitbn_model
from .squeeze_excite import EffectiveSEModule, SEModule, SqueezeExcite
from .test_time_pool import TestTimePoolHead, apply_test_time_pool
from .weight_init import lecun_normal_, trunc_normal_, variance_scaling_
