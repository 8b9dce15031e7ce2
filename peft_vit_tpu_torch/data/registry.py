"""Dataset registry and loaders (counterpart of ``peft_vit_tpu/data/registry.py``).

The port keeps the registry's names and protocol metadata and resolves every
local source the JAX package does, in its order: synthetic, TSV shards, the
hub (files already provisioned; it never downloads), an ELEVATER manifest,
an npz cache, an ImageFolder tree.  ``load_tsv`` and ``load_imagefolder``
decode with PIL, bicubic, as the JAX loaders do.  What follows is the JAX
module's own account.

The reference resolves datasets by name through the `vision-datasets`
DatasetHub backed by an Azure blob (feature.py:549-577) — a network path
this zero-egress environment cannot take.  The registry keeps the same
*names and protocol metadata* (the 20 ELEVATER ICinW datasets + custom
ones; class counts and per-dataset metrics from evaluation/metric.py:7-34)
and resolves data from local sources:

* ``imagefolder`` — torchvision-style class-per-directory trees
* ``tsv``         — the full-shot TSV shard format (the release's missing
                    ``dataset`` package, re-designed from config evidence:
                    lib/config/default.py TRAIN_TSV_LIST/TEST_TSV_LIST;
                    rows are ``key<TAB>base64(image)<TAB>label``)
* ``npz``         — cached arrays (images or features; analog of the
                    linear-probe .npy caches, commands/linear_probe.py:55-90)
* ``synthetic``   — deterministic procedural data for tests/benchmarks

Every loader returns ``(images_u8 (N,H,W,3) | features (N,D), labels)``
as numpy arrays; few-shot subsetting and splitting live in
``data.few_shot``.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import os
from typing import Dict, Optional, Tuple

import numpy as np

MULTICLASS = "classification_multiclass"
MULTILABEL = "classification_multilabel"


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    name: str
    num_classes: int
    type: str = MULTICLASS
    metric: str = "accuracy"


# The ELEVATER IC-in-the-Wild suite + reference extras
# (names from resources/datasets/vision_datasets.json; metrics from
# evaluation/metric.py:7-34).
_DATASETS = [
    DatasetInfo("cifar-10", 10),
    DatasetInfo("cifar-100", 100),
    DatasetInfo("caltech-101", 102, metric="mean-per-class"),
    DatasetInfo("oxford-flower-102", 102, metric="mean-per-class"),
    DatasetInfo("oxford-iiit-pets", 37, metric="mean-per-class"),
    DatasetInfo(
        "fgvc-aircraft-2013b-variants102", 100, metric="mean-per-class"
    ),
    DatasetInfo("food-101", 101),
    DatasetInfo("dtd", 47),
    DatasetInfo("eurosat_clip", 10),
    DatasetInfo("fer-2013", 7),
    DatasetInfo("gtsrb", 43),
    DatasetInfo("hateful-memes", 2, metric="roc_auc"),
    DatasetInfo("kitti-distance", 4),
    DatasetInfo("mnist", 10),
    DatasetInfo("patch-camelyon", 2),
    DatasetInfo("rendered-sst2", 2),
    DatasetInfo("resisc45_clip", 45),
    DatasetInfo("stanford-cars", 196),
    DatasetInfo("country211", 211),
    DatasetInfo(
        "voc-2007-classification", 20, MULTILABEL, "11point_mAP"
    ),
    DatasetInfo("chestx-ray8", 8, MULTILABEL, "roc_auc"),
    DatasetInfo("imagenet-1k", 1000),
    # procedural data for tests/benchmarks (see synthetic_dataset)
    DatasetInfo("synthetic", 0),
    DatasetInfo("synthetic_multilabel", 0, MULTILABEL, "11point_mAP"),
]

_INFO: Dict[str, DatasetInfo] = {d.name: d for d in _DATASETS}


def register_dataset(info: DatasetInfo) -> None:
    _INFO[info.name] = info


def dataset_info(name: str) -> DatasetInfo:
    if name not in _INFO:
        # unknown names default to multiclass/accuracy; class count must
        # come from config (DATASET.NUM_CLASSES)
        return DatasetInfo(name, 0)
    return _INFO[name]


def list_datasets():
    return sorted(_INFO)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def load_imagefolder(root: str, image_size: int = 224) -> Tuple[np.ndarray, np.ndarray]:
    """Class-per-subdirectory tree -> (images_u8, labels)."""
    from PIL import Image

    from .transforms import resize_center_crop

    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    xs, ys = [], []
    for ci, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            try:
                img = Image.open(os.path.join(cdir, f))
            except Exception:
                continue
            xs.append(resize_center_crop(img, image_size))
            ys.append(ci)
    return np.stack(xs), np.asarray(ys, np.int64)


def load_tsv(paths, image_size: int = 224,
             num_classes: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """TSV shards: ``key<TAB>base64(image-bytes)<TAB>label``; the label an
    int, or ';'-separated ints for multilabel (one-hot when any row holds
    several; then ``num_classes`` is needed)."""
    from PIL import Image

    from .transforms import resize_center_crop

    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    xs, raw_labels = [], []
    multilabel = False
    for path in paths:
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    continue
                img = Image.open(io.BytesIO(base64.b64decode(parts[1])))
                xs.append(resize_center_crop(img, image_size))
                ids = [int(v) for v in str(parts[2]).split(";") if v != ""]
                multilabel = multilabel or len(ids) > 1
                raw_labels.append(ids)
    x = np.stack(xs)
    if multilabel:
        if not num_classes:
            raise ValueError("multilabel TSV needs num_classes")
        y = np.zeros((len(raw_labels), num_classes), np.int64)
        for i, ids in enumerate(raw_labels):
            y[i, ids] = 1
    else:
        y = np.asarray([ids[0] for ids in raw_labels], np.int64)
    return x, y


def load_npz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    z = np.load(path, allow_pickle=False)
    return z["x"], z["y"]


def save_npz(path: str, x: np.ndarray, y: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, x=x, y=y)


def synthetic_multilabel_dataset(
    num_classes: int = 4,
    n_per_class: int = 20,
    image_size: int = 32,
    seed: int = 0,
    signal: float = 1.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Learnable multilabel data: each present label adds a bright band at
    its own row; labels are (N, C) binary with 1-2 labels per image (the
    VOC2007/ChestX-ray8 shape for tests)."""
    rng = np.random.RandomState(seed)
    n = num_classes * n_per_class
    y = np.zeros((n, num_classes), np.int64)
    primary = np.tile(np.arange(num_classes), n_per_class)
    y[np.arange(n), primary] = 1
    extra = rng.randint(0, num_classes, size=n)
    add = rng.rand(n) < 0.5
    y[np.arange(n)[add], extra[add]] = 1
    x = rng.rand(n, image_size, image_size, 3).astype(np.float32)
    band = max(1, image_size // max(num_classes, 1))
    for c in range(num_classes):
        rows = slice(c * band, min((c + 1) * band, image_size))
        x[y[:, c] == 1, rows] += signal
    x = (255 * (x / x.max())).astype(np.uint8)
    return x, y


def synthetic_dataset(
    num_classes: int = 10,
    n_per_class: int = 20,
    image_size: int = 32,
    seed: int = 0,
    signal: float = 1.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic, learnable synthetic data: class-dependent bright
    band over noise (used by tests and smoke benchmarks)."""
    rng = np.random.RandomState(seed)
    n = num_classes * n_per_class
    y = np.tile(np.arange(num_classes), n_per_class)
    x = rng.randn(n, image_size, image_size, 3).astype(np.float32) * 0.25
    band = max(image_size // num_classes, 1)
    for i in range(n):
        c = int(y[i])
        x[i, c * band : (c + 1) * band, :, :] += signal
    x = np.clip((x * 0.25 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    return x, y


def load_split(cfg, split: str) -> Tuple[np.ndarray, np.ndarray]:
    """Resolve a (train|val|test) split from config, in the JAX package's
    order: synthetic -> TSV lists -> the hub (``DATASET.DOWNLOAD``) ->
    ELEVATER manifest -> npz cache -> ImageFolder under
    DATASET.ROOT/<split dir>."""
    name = cfg.DATASET.DATASET
    size = int(cfg.TRAIN.IMAGE_SIZE[0])
    root = cfg.DATASET.ROOT
    info = dataset_info(name)
    num_classes = int(cfg.DATASET.NUM_CLASSES) or info.num_classes

    if name.startswith("synthetic"):
        seed = {"train": 0, "val": 1, "test": 2}[split]
        gen = synthetic_multilabel_dataset if "multilabel" in name else synthetic_dataset
        return gen(num_classes=num_classes or 10, n_per_class=20, image_size=size, seed=seed)

    tsv_list = cfg.DATASET.TRAIN_TSV_LIST if split == "train" else cfg.DATASET.TEST_TSV_LIST
    if tsv_list:
        return load_tsv([os.path.join(root, p) for p in tsv_list], size, num_classes)

    # the vision-datasets hub (DATASET.DOWNLOAD): resolve the dataset in the
    # shipped vision_datasets.json; its files must already be under
    # DATASET.ROOT (data/hub.py raises the provisioning message otherwise)
    if bool(cfg.DATASET.get("DOWNLOAD", False)):
        import shutil

        from .hub import ensure_dataset, packaged_registry_path

        base = root or "."
        reg_local = os.path.join(base, "vision_datasets.json")
        if not os.path.exists(reg_local):
            os.makedirs(base, exist_ok=True)
            shutil.copy(packaged_registry_path(), reg_local)
        try:
            ensure_dataset(name, base, splits=(split,), download=True)
        except KeyError:
            pass  # not a hub dataset: fall through to the local sources

    # an ELEVATER / vision-datasets manifest under DATASET.ROOT
    from .elevater import load_elevater_split

    manifest = load_elevater_split(cfg, split)
    if manifest is not None:
        return manifest

    npz = os.path.join(root, name, f"{split}.npz")
    if os.path.exists(npz):
        return load_npz(npz)

    split_dir = {
        "train": cfg.DATASET.TRAIN_SET,
        "val": cfg.DATASET.VAL_SET or cfg.DATASET.TEST_SET,
        "test": cfg.DATASET.TEST_SET,
    }[split]
    folder = os.path.join(root, split_dir)
    if os.path.isdir(folder):
        return load_imagefolder(folder, size)

    raise FileNotFoundError(
        f"No local source for dataset {name!r} split {split!r} under {root!r} (zero-egress: "
        "the hub download is unavailable; provide ImageFolder/TSV/npz data)")
