from .masks import (
    build_mask,
    count_trainable,
    describe_mask,
    merge_params,
    split_params,
)
from .spec import PEFTSpec

__all__ = [
    "PEFTSpec",
    "build_mask",
    "count_trainable",
    "describe_mask",
    "merge_params",
    "split_params",
]
