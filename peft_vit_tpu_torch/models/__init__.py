from .classifier import ClassifierHead, FeatureBatchNorm, ImageClassifier
from .convert import (
    clip_state_dict_to_tree,
    infer_clip_shape,
    jax_path,
    load_jax_variables,
    load_torch_checkpoint,
    params_from_jax,
    params_to_jax,
    visual_state_dict,
)
from .factory import build_image_classifier, compute_dtype, flagship, is_clip_model
from .layers import (
    ACT2FN,
    Block,
    Dense,
    Int8Dense,
    LayerNorm,
    Mlp,
    MultiHeadAttention,
    cast_frozen_,
    collect_activation_stats,
    quick_gelu,
)
from .vit import VisionTransformer

__all__ = [
    "ACT2FN",
    "Block",
    "ClassifierHead",
    "Dense",
    "FeatureBatchNorm",
    "ImageClassifier",
    "Int8Dense",
    "LayerNorm",
    "Mlp",
    "MultiHeadAttention",
    "VisionTransformer",
    "build_image_classifier",
    "cast_frozen_",
    "clip_state_dict_to_tree",
    "collect_activation_stats",
    "compute_dtype",
    "flagship",
    "infer_clip_shape",
    "is_clip_model",
    "jax_path",
    "load_jax_variables",
    "load_torch_checkpoint",
    "params_from_jax",
    "params_to_jax",
    "quick_gelu",
    "visual_state_dict",
]
