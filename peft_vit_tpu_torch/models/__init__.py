from .classifier import ClassifierHead, ContrastiveClassifier, FeatureBatchNorm, ImageClassifier
from .clip import CLIP, clip_from_config
from .clip_resnet import AttentionPool2d, ModifiedResNet
from .convert import (
    clip_state_dict_to_tree,
    infer_clip_shape,
    jax_path,
    load_jax_variables,
    load_torch_checkpoint,
    params_from_jax,
    params_to_jax,
    text_state_dict,
    visual_state_dict,
)
from .factory import (backbone_eval_variables, build_image_classifier, compute_dtype, flagship,
                      init_head_from_text, is_clip_model)
from .layers import (
    ACT2FN,
    Adapter,
    Block,
    CompacterAdapter,
    Dense,
    Int8Dense,
    LayerNorm,
    Mlp,
    MultiHeadAttention,
    PHMDense,
    cast_frozen_,
    collect_activation_stats,
    quick_gelu,
)
from .registry import get_custom_builder, register_model
from .resnet import ResNet
from .ssl_swin import build_ssl_swin, extract_n_last_blocks, multi_crop_forward
from .swin import SwinTransformer
from .text import TextEncoder, TextTransformer
from .vit import VisionTransformer
from .vit_conv import ConvViT

__all__ = [
    "ACT2FN",
    "Adapter",
    "AttentionPool2d",
    "Block",
    "CLIP",
    "ClassifierHead",
    "CompacterAdapter",
    "ContrastiveClassifier",
    "ConvViT",
    "Dense",
    "FeatureBatchNorm",
    "ImageClassifier",
    "Int8Dense",
    "LayerNorm",
    "Mlp",
    "ModifiedResNet",
    "MultiHeadAttention",
    "PHMDense",
    "ResNet",
    "SwinTransformer",
    "TextEncoder",
    "TextTransformer",
    "VisionTransformer",
    "backbone_eval_variables",
    "build_image_classifier",
    "build_ssl_swin",
    "cast_frozen_",
    "clip_from_config",
    "clip_state_dict_to_tree",
    "collect_activation_stats",
    "compute_dtype",
    "extract_n_last_blocks",
    "flagship",
    "get_custom_builder",
    "infer_clip_shape",
    "init_head_from_text",
    "is_clip_model",
    "jax_path",
    "load_jax_variables",
    "load_torch_checkpoint",
    "multi_crop_forward",
    "params_from_jax",
    "params_to_jax",
    "quick_gelu",
    "register_model",
    "text_state_dict",
    "visual_state_dict",
]
