from .classifier import ClassifierHead, FeatureBatchNorm, ImageClassifier
from .convert import load_jax_variables, params_from_jax
from .factory import flagship
from .layers import ACT2FN, Block, LayerNorm, Mlp, MultiHeadAttention, quick_gelu
from .vit import VisionTransformer

__all__ = [
    "ACT2FN",
    "Block",
    "ClassifierHead",
    "FeatureBatchNorm",
    "ImageClassifier",
    "LayerNorm",
    "Mlp",
    "MultiHeadAttention",
    "VisionTransformer",
    "flagship",
    "load_jax_variables",
    "params_from_jax",
    "quick_gelu",
]
