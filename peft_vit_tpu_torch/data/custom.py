"""Custom dataset parsers (counterpart of ``peft_vit_tpu/data/custom.py``):
VOC2007 and ChestX-ray8.

What follows is the JAX module's own account.

Custom dataset parsers (reference evaluation/dataset.py:8-130).

* VOC2007 multilabel classification — parses
  ``VOCdevkit/VOC2007/ImageSets/Main/{class}_{split}.txt`` annotation lists
  (labels in {-1, 0, 1}; 0 = difficult, counted positive like the
  reference).
* ChestX-ray8 — CSV index (``Data_Entry_2017.csv`` style: image name +
  '|'-separated finding labels over 8 pathologies).

Both return (image_paths, labels (N, C) int64); decode happens through
data.native / PIL at load time.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

CHESTX_CLASSES = [
    "Atelectasis", "Cardiomegaly", "Effusion", "Infiltration",
    "Mass", "Nodule", "Pneumonia", "Pneumothorax",
]


def voc2007_classification(
    root: str, image_set: str = "train"
) -> Tuple[List[str], np.ndarray]:
    """root = path containing VOCdevkit/VOC2007."""
    base = os.path.join(root, "VOCdevkit", "VOC2007")
    if not os.path.isdir(base):
        base = root  # already pointed at VOC2007
    main = os.path.join(base, "ImageSets", "Main")
    ids: List[str] = []
    per_class: dict = {}
    for ci, cls in enumerate(VOC_CLASSES):
        path = os.path.join(main, f"{cls}_{image_set}.txt")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                img_id, flag = parts[0], int(parts[1])
                per_class.setdefault(img_id, np.zeros(
                    len(VOC_CLASSES), np.int64
                ))
                # reference counts 0 (difficult) as positive
                if flag >= 0:
                    per_class[img_id][ci] = 1
    ids = sorted(per_class)
    paths = [
        os.path.join(base, "JPEGImages", f"{i}.jpg") for i in ids
    ]
    labels = np.stack([per_class[i] for i in ids]) if ids else np.zeros(
        (0, len(VOC_CLASSES)), np.int64
    )
    return paths, labels


def chestxray8(
    root: str, image_set: str = "train"
) -> Tuple[List[str], np.ndarray]:
    """root contains images/ and Data_Entry_2017.csv plus
    train_val_list.txt / test_list.txt."""
    list_file = os.path.join(
        root,
        "train_val_list.txt" if image_set == "train" else "test_list.txt",
    )
    wanted = None
    if os.path.exists(list_file):
        wanted = {l.strip() for l in open(list_file) if l.strip()}
    csv_path = os.path.join(root, "Data_Entry_2017.csv")
    paths: List[str] = []
    labels: List[np.ndarray] = []
    with open(csv_path) as f:
        header = f.readline()
        del header
        for line in f:
            parts = line.rstrip("\n").split(",")
            if len(parts) < 2:
                continue
            name, findings = parts[0], parts[1]
            if wanted is not None and name not in wanted:
                continue
            vec = np.zeros(len(CHESTX_CLASSES), np.int64)
            for fnd in findings.split("|"):
                if fnd in CHESTX_CLASSES:
                    vec[CHESTX_CLASSES.index(fnd)] = 1
            paths.append(os.path.join(root, "images", name))
            labels.append(vec)
    return paths, (
        np.stack(labels)
        if labels
        else np.zeros((0, len(CHESTX_CLASSES)), np.int64)
    )


def load_image_paths(
    paths: Sequence[str], image_size: int
) -> np.ndarray:
    """Decode a path list to (N, S, S, 3) uint8 via the native runtime
    when available."""
    from .native import decode_resize

    out = np.zeros((len(paths), image_size, image_size, 3), np.uint8)
    for i, p in enumerate(paths):
        try:
            with open(p, "rb") as f:
                img = decode_resize(f.read(), image_size)
            if img is not None:
                out[i] = img
        except OSError:
            pass
    return out
