from ._factory import create_model
from ._helpers import clean_state_dict, load_checkpoint, load_state_dict, save_state_dict
from ._jax_convert import (
    convert_jax_checkpoint, convert_jax_state_dict, is_jax_checkpoint, load_jax_state_dict,
)
from ._pretrained import DefaultCfg, PretrainedCfg
from ._registry import (
    generate_default_cfgs, get_pretrained_cfg, is_model, list_models, model_entrypoint,
    register_model, split_model_name_tag,
)
from ._features import FeatureGetterNet, FeatureInfo
from ._manipulate import checkpoint_seq
from .convnext import ConvNeXt
from .deit import VisionTransformerDistilled
from .naflexvit import NaFlexVit
from .resnet import ResNet
from .efficientnet import EfficientNet
from .vision_transformer import (
    Block, DiffParallelScalingBlock, ParallelScalingBlock, ParallelThingsBlock, ResPostBlock,
    VisionTransformer,
)
