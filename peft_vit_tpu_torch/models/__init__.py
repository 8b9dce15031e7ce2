from .classifier import ClassifierHead, FeatureBatchNorm, ImageClassifier
from .convert import jax_path, load_jax_variables, params_from_jax, params_to_jax
from .factory import flagship
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
    "cast_frozen_",
    "collect_activation_stats",
    "flagship",
    "jax_path",
    "load_jax_variables",
    "params_from_jax",
    "params_to_jax",
    "quick_gelu",
]
