"""construct_dataloader equivalent: config -> device-ready splits (a copy of
``peft_vit_tpu/data/pipeline.py``: the same config gives bit-identical
splits).

Reference call: construct_dataloader(config) -> (train, val, test)
DataLoaders (feature.py:514-598).  Here the product is numpy splits (and
``engine.make_array_task`` for device residency):

1. load train split; if DATASET.NUM_SAMPLES_PER_CLASS > 0, take the k-shot
   subset with RANDOM_SEED_SAMPLING                     (feature.py:580-583)
2. class-balanced 80/20 train/val split                 (feature.py:87-148)
3. load test split
4. normalize with INPUT.MEAN/STD (the model YAML carries CLIP stats)

``merge_trainval`` reproduces merge_trainval_loader
(adapter_tuning_clip.py:429-445) for the final run.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Tuple

import numpy as np

from .few_shot import balanced_val_split, sample_few_shot_subset
from .registry import dataset_info, load_split
from .transforms import to_normalized_array

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Splits:
    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int
    multilabel: bool


def construct_splits(
    cfg, test_split_only: bool = False, normalize: bool = True
) -> Splits:
    name = cfg.DATASET.DATASET
    info = dataset_info(name)
    num_classes = int(cfg.DATASET.NUM_CLASSES) or info.num_classes
    mean, std = list(cfg.INPUT.MEAN), list(cfg.INPUT.STD)

    def prep(x):
        if not normalize or x.ndim != 4:
            return x
        return np.stack([to_normalized_array(im, mean, std) for im in x])

    x_test, y_test = load_split(cfg, "test")
    logger.info("Test size is %d.", len(x_test))
    if test_split_only:
        e = np.empty((0,))
        return Splits(
            e, e, e, e, prep(x_test), y_test, num_classes,
            info.type.endswith("multilabel"),
        )

    x_train, y_train = load_split(cfg, "train")
    k = int(cfg.DATASET.NUM_SAMPLES_PER_CLASS)
    if k > 0:
        idx = sample_few_shot_subset(
            y_train, k, int(cfg.DATASET.RANDOM_SEED_SAMPLING)
        )
        x_train, y_train = x_train[idx], y_train[idx]

    tr_idx, va_idx = balanced_val_split(y_train, val_split=0.2)
    logger.info(
        "Val split from Train set: Train size is %d, and validation size "
        "is %d.",
        len(tr_idx),
        len(va_idx),
    )
    return Splits(
        prep(x_train[tr_idx]),
        y_train[tr_idx],
        prep(x_train[va_idx]),
        y_train[va_idx],
        prep(x_test),
        y_test,
        num_classes,
        info.type.endswith("multilabel"),
    )


def merge_trainval(s: Splits) -> Tuple[np.ndarray, np.ndarray]:
    """Final-run train set = train + val (adapter_tuning_clip.py:429-445)."""
    return (
        np.concatenate([s.x_train, s.x_val]),
        np.concatenate([s.y_train, s.y_val]),
    )
