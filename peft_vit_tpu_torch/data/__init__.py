"""Data (counterpart of ``peft_vit_tpu/data``): the registry and its local
sources, few-shot sampling, the host and device transforms,
``construct_splits``, the hub's resolution, the samplers and the streaming
source over the native decode ring."""
from .few_shot import balanced_val_split, effective_shots, sample_few_shot_subset
from .hub import ensure_dataset, load_registry, resolve_entry
from .pipeline import Splits, construct_splits, merge_trainval
from .registry import (
    DatasetInfo,
    dataset_info,
    list_datasets,
    load_imagefolder,
    load_npz,
    load_split,
    load_tsv,
    register_dataset,
    save_npz,
    synthetic_dataset,
    synthetic_multilabel_dataset,
)
from .samplers import build_order, chunk_order, class_aware_order, default_order, shard_order
from .streaming import StreamingSource, prefetch_to_device
from .transforms import (
    CLIP_MEAN,
    CLIP_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_batch,
    random_crop_resize,
    random_flip,
    resize_center_crop,
    to_normalized_array,
)

__all__ = [
    "ensure_dataset",
    "load_registry",
    "resolve_entry",
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
    "load_imagefolder",
    "load_npz",
    "load_split",
    "load_tsv",
    "merge_trainval",
    "normalize_batch",
    "random_crop_resize",
    "random_flip",
    "register_dataset",
    "resize_center_crop",
    "sample_few_shot_subset",
    "save_npz",
    "StreamingSource",
    "build_order",
    "chunk_order",
    "class_aware_order",
    "default_order",
    "prefetch_to_device",
    "shard_order",
    "synthetic_dataset",
    "synthetic_multilabel_dataset",
    "to_normalized_array",
]
