from .masks import (
    build_mask,
    count_trainable,
    describe_mask,
    merge_params,
    split_params,
)
from .spec import PEFTSpec, canonical_method, spec_from_config

__all__ = [
    "PEFTSpec",
    "build_mask",
    "canonical_method",
    "count_trainable",
    "describe_mask",
    "merge_params",
    "spec_from_config",
    "split_params",
]
