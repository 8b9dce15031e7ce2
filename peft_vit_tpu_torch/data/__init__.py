"""Data of the few-shot driver (counterpart of ``peft_vit_tpu/data``): the
registry, few-shot sampling, the host transforms and ``construct_splits``."""
from .few_shot import balanced_val_split, effective_shots, sample_few_shot_subset
from .pipeline import Splits, construct_splits, merge_trainval
from .registry import (
    DatasetInfo,
    dataset_info,
    list_datasets,
    load_npz,
    load_split,
    save_npz,
    synthetic_dataset,
    synthetic_multilabel_dataset,
)
from .transforms import (
    CLIP_MEAN,
    CLIP_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_batch,
    resize_center_crop,
    to_normalized_array,
)

__all__ = [
    "CLIP_MEAN",
    "CLIP_STD",
    "DatasetInfo",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "Splits",
    "balanced_val_split",
    "construct_splits",
    "dataset_info",
    "effective_shots",
    "list_datasets",
    "load_npz",
    "load_split",
    "merge_trainval",
    "normalize_batch",
    "resize_center_crop",
    "sample_few_shot_subset",
    "save_npz",
    "synthetic_dataset",
    "synthetic_multilabel_dataset",
    "to_normalized_array",
]
