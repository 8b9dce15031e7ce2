"""The ELEVATER / vision-datasets on-disk format reader (counterpart of
``peft_vit_tpu/data/elevater.py``): the manifest registry, coco-style and
txt index splits, ``images.zip@member`` reads, ``scan_zip_split`` for the
streaming source, and the class names registered with ``data.prompts``.
Images decode through ``native.decode_resize``, as in the JAX package.

What follows is the JAX module's own account.

ELEVATER / vision-datasets on-disk format reader.

The reference consumes ELEVATER benchmark dumps through the
``vision_datasets`` package (evaluation/feature.py:549-577): a registry
JSON (``vision_datasets.json`` — entries with name, type, root_folder and
per-usage ``{index_path, files_for_local_usage}``) plus coco-style index
files whose image ``file_name`` entries may point inside zip archives
(``images.zip@member/path.jpg``).

This reader loads the same layout straight from local disk (zero-egress:
the Azure hub download is out of scope), returning numpy arrays for
``data.registry.load_split``:

* multiclass -> labels (N,) int64 (category ids made contiguous)
* multilabel -> labels (N, C) binary
* class names from the index's ``categories`` are registered with
  ``data.prompts`` so zero-shot / text-head init work out of the box
"""

from __future__ import annotations

import json
import logging
import os
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_USAGE_KEYS = {"train": "train", "val": "val", "test": "test"}


def load_manifest_registry(path: str) -> List[dict]:
    with open(path) as f:
        reg = json.load(f)
    if not isinstance(reg, list):
        raise ValueError(f"{path}: expected a list of dataset entries")
    return reg


def find_registry(root: str, explicit: str = "") -> Optional[str]:
    """Locate a vision_datasets.json: explicit path, then DATASET.ROOT."""
    for p in (explicit, os.path.join(root or "", "vision_datasets.json")):
        if p and os.path.exists(p):
            return p
    return None


def find_dataset(registry: List[dict], name: str) -> Optional[dict]:
    for entry in registry:
        if entry.get("name") == name:
            return entry
    return None


class _ZipCache:
    """Open zip archives once per load (members read lazily)."""

    def __init__(self):
        self._zips: Dict[str, zipfile.ZipFile] = {}

    def read(self, zip_path: str, member: str) -> bytes:
        zf = self._zips.get(zip_path)
        if zf is None:
            zf = zipfile.ZipFile(zip_path)
            self._zips[zip_path] = zf
        return zf.read(member)

    def close(self):
        for zf in self._zips.values():
            zf.close()
        self._zips.clear()


def _read_image_bytes(
    file_name: str, base_dir: str, zips: _ZipCache
) -> bytes:
    if "@" in file_name:
        zip_rel, member = file_name.split("@", 1)
        return zips.read(os.path.join(base_dir, zip_rel), member)
    with open(os.path.join(base_dir, file_name), "rb") as f:
        return f.read()


def _decode(image_bytes: bytes, size: int) -> np.ndarray:
    from .native import decode_resize

    out = decode_resize(image_bytes, size)
    if out is None:
        raise ValueError("undecodable image in manifest dataset")
    return out


def load_coco_split(
    root: str,
    entry: dict,
    split: str,
    image_size: int,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(images_u8, labels, class_names) for one usage of a registry entry.

    ``split``: train/val/test; a missing val usage falls back to test
    being absent -> KeyError (caller decides; the reference derives val
    from train by a balanced 80/20 split upstream, feature.py:87-148).
    """
    usage = entry.get(_USAGE_KEYS[split])
    if usage is None:
        raise KeyError(
            f"dataset {entry.get('name')!r} has no {split!r} usage"
        )
    base_dir = os.path.join(root or "", entry.get("root_folder", ""))
    index_path = os.path.join(base_dir, usage["index_path"])
    with open(index_path) as f:
        index = json.load(f)

    categories = sorted(index["categories"], key=lambda c: c["id"])
    cid_to_idx = {c["id"]: i for i, c in enumerate(categories)}
    class_names = [str(c["name"]) for c in categories]
    num_classes = len(categories)
    multilabel = str(entry.get("type", "")).endswith("multilabel")

    per_image: Dict[int, List[int]] = {}
    for ann in index.get("annotations", []):
        per_image.setdefault(int(ann["image_id"]), []).append(
            cid_to_idx[ann["category_id"]]
        )

    zips = _ZipCache()
    xs, ys = [], []
    skipped = 0
    try:
        for im in index["images"]:
            ids = per_image.get(int(im["id"]), [])
            if not multilabel and not ids:
                # unannotated image: the reference only indexes annotated
                # images; emitting label -1 here would silently wrap to
                # the last class under take_along_axis CE — drop instead
                skipped += 1
                continue
            raw = _read_image_bytes(str(im["file_name"]), base_dir, zips)
            xs.append(_decode(raw, image_size))
            ys.append(ids)
    finally:
        zips.close()
    if skipped:
        logger.warning(
            "=> %s/%s: dropped %d unannotated image(s)",
            entry.get("name"),
            split,
            skipped,
        )

    x = np.stack(xs) if xs else np.zeros(
        (0, image_size, image_size, 3), np.uint8
    )
    if multilabel:
        y = np.zeros((len(ys), num_classes), np.int64)
        for i, ids in enumerate(ys):
            y[i, ids] = 1
    else:
        y = np.asarray([ids[0] for ids in ys], np.int64).reshape(len(ys))
    return x, y, class_names


def load_txt_split(
    root: str,
    entry: dict,
    split: str,
    image_size: int,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Iris txt-format usage (30 of the 46 hub registry entries, e.g.
    cifar-10's ``train.txt``): each index line is
    ``<image_path> <label[,label...]>`` where the image path may be
    ``archive.zip@member``; class names come from the entry-level
    ``labelmap`` file (one name per line) when present."""
    usage = entry.get(_USAGE_KEYS[split])
    if usage is None:
        raise KeyError(
            f"dataset {entry.get('name')!r} has no {split!r} usage"
        )
    base_dir = os.path.join(root or "", entry.get("root_folder", ""))
    multilabel = str(entry.get("type", "")).endswith("multilabel")

    rows: List[Tuple[str, List[int]]] = []
    with open(os.path.join(base_dir, usage["index_path"])) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2:
                raise ValueError(
                    f"iris index line without a label: {line!r}"
                )
            labels = [int(t) for t in parts[-1].split(",") if t != ""]
            if not labels and not multilabel:
                # diagnose at parse time (ADVICE r3): a bare ',' label
                # field would otherwise IndexError far from the line
                raise ValueError(
                    f"iris index line with an empty label field: {line!r}"
                )
            rows.append((" ".join(parts[:-1]), labels))

    class_names: List[str] = []
    lm = entry.get("labelmap")
    if lm and os.path.exists(os.path.join(base_dir, lm)):
        with open(os.path.join(base_dir, lm)) as f:
            class_names = [ln.strip() for ln in f if ln.strip()]
    num_classes = len(class_names) or (
        1 + max((max(ls) for _, ls in rows if ls), default=-1)
    )
    if not class_names:
        class_names = [f"class {i}" for i in range(num_classes)]

    zips = _ZipCache()
    xs, ys = [], []
    try:
        for file_name, labels in rows:
            raw = _read_image_bytes(file_name, base_dir, zips)
            xs.append(_decode(raw, image_size))
            ys.append(labels)
    finally:
        zips.close()

    x = np.stack(xs) if xs else np.zeros(
        (0, image_size, image_size, 3), np.uint8
    )
    if multilabel:
        y = np.zeros((len(ys), num_classes), np.int64)
        for i, ids in enumerate(ys):
            y[i, ids] = 1
    else:
        y = np.asarray([ids[0] for ids in ys], np.int64).reshape(len(ys))
    return x, y, class_names


def load_elevater_split(
    cfg, split: str
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """registry.load_split hook: resolve DATASET.DATASET from a local
    vision_datasets.json; None when no manifest matches."""
    root = cfg.DATASET.ROOT
    reg_path = find_registry(root, str(cfg.DATASET.get("REGISTRY_JSON", "")))
    if reg_path is None:
        return None
    entry = find_dataset(load_manifest_registry(reg_path), cfg.DATASET.DATASET)
    if entry is None:
        return None
    if split == "val" and "val" not in entry:
        # reference derives val from train upstream (feature.py:87-148)
        return None
    size = int(cfg.TRAIN.IMAGE_SIZE[0])
    usage = entry.get(_USAGE_KEYS[split]) or {}
    if str(usage.get("index_path", "")).endswith(".txt"):
        # iris txt format (format key absent in the hub registry for
        # these entries; coco entries carry format='coco')
        x, y, class_names = load_txt_split(root, entry, split, size)
    else:
        x, y, class_names = load_coco_split(root, entry, split, size)
    logger.info(
        "=> ELEVATER manifest %s/%s: %d images, %d classes",
        cfg.DATASET.DATASET,
        split,
        len(x),
        len(class_names),
    )
    from .prompts import class_map, register_prompts

    if class_map(cfg.DATASET.DATASET, root) is None:
        register_prompts(cfg.DATASET.DATASET, class_names)
    from .registry import DatasetInfo, dataset_info, register_dataset

    known = dataset_info(str(entry["name"]))
    if known.num_classes == 0:  # keep built-in metric/type for known sets
        register_dataset(
            DatasetInfo(
                str(entry["name"]),
                len(class_names),
                str(entry.get("type", "classification_multiclass")),
            )
        )
    return x, y


def scan_zip_split(cfg, split: str):
    """Streaming hook: resolve a manifest split to
    ``(zip_path, members, labels)`` when every image lives in one zip
    archive and the task is multiclass — the common ELEVATER dump layout
    (``images.zip@member``).  Returns None otherwise (the in-RAM
    ``load_elevater_split`` path handles mixed/loose/multilabel cases).
    """
    root = cfg.DATASET.ROOT
    reg_path = find_registry(root, str(cfg.DATASET.get("REGISTRY_JSON", "")))
    if reg_path is None:
        return None
    entry = find_dataset(
        load_manifest_registry(reg_path), cfg.DATASET.DATASET
    )
    if entry is None:
        return None
    if str(entry.get("type", "")).endswith("multilabel"):
        return None
    usage = entry.get(_USAGE_KEYS.get(split, split))
    if usage is None:
        return None
    base_dir = os.path.join(root or "", entry.get("root_folder", ""))
    index_path = os.path.join(base_dir, usage["index_path"])
    with open(index_path) as f:
        index = json.load(f)
    categories = sorted(index["categories"], key=lambda c: c["id"])
    cid_to_idx = {c["id"]: i for i, c in enumerate(categories)}
    per_image = {}
    for ann in index.get("annotations", []):
        per_image.setdefault(int(ann["image_id"]), []).append(
            cid_to_idx[ann["category_id"]]
        )
    zip_rel = None
    members, labels = [], []
    skipped = 0
    for im in index["images"]:
        fn = str(im["file_name"])
        if "@" not in fn:
            return None  # loose files: no single archive to stream
        z, member = fn.split("@", 1)
        if zip_rel is None:
            zip_rel = z
        elif z != zip_rel:
            return None  # multiple archives: fall back
        ids = per_image.get(int(im["id"]), [])
        if not ids:
            # unannotated: never stream label -1 into training (it would
            # wrap to the last class under take_along_axis CE)
            skipped += 1
            continue
        members.append(member)
        labels.append(ids[0])
    if skipped:
        logger.warning(
            "=> %s/%s: dropped %d unannotated zip member(s)",
            entry.get("name"),
            split,
            skipped,
        )
    if zip_rel is None:
        return None
    return os.path.join(base_dir, zip_rel), members, labels
