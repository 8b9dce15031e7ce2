"""Tiny on-disk datasets for the port's data tests: PNG images of a few
aspect ratios with a learnable class pattern, written as base64 TSV shards,
an ImageFolder tree and an ELEVATER manifest (``vision_datasets.json``, a
coco-style or txt index, ``images.zip@member``)."""

import base64
import io
import json
import os
import zipfile

import numpy as np
from PIL import Image


def images(num_classes=3, per_class=4, seed=0, sizes=((20, 28), (28, 20))):
    """[(uint8 (H, W, 3), label)]: noise plus a bright band at the class's
    own rows, the sizes taken in turn."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(num_classes * per_class):
        c = i % num_classes
        h, w = sizes[i % len(sizes)]
        x = rng.randint(0, 120, (h, w, 3))
        band = h // num_classes
        x[c * band:(c + 1) * band] += 120
        out.append((x.astype(np.uint8), c))
    return out


def png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def write_tsv(path, items):
    with open(path, "w") as f:
        for i, (x, y) in enumerate(items):
            f.write(f"img{i}\t{base64.b64encode(png(x)).decode()}\t{y}\n")
    return str(path)


def write_folder(root, items, classes):
    for i, (x, y) in enumerate(items):
        d = os.path.join(root, classes[y])
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{i:04d}.png"), "wb") as f:
            f.write(png(x))
    return str(root)


def write_manifest(root, name, splits, classes, fmt="coco"):
    """``splits``: {usage: items}; every image in ``<usage>/images.zip``
    (DEFLATE), indexed by a coco json or an iris txt."""
    folder = os.path.join(root, name)
    os.makedirs(folder, exist_ok=True)
    entry = {"name": name, "type": "classification_multiclass", "root_folder": name,
             "format": fmt}
    if fmt == "txt":
        with open(os.path.join(folder, "labels.txt"), "w") as f:
            f.write("\n".join(classes) + "\n")
        entry["labelmap"] = "labels.txt"
    for usage, items in splits.items():
        zip_rel = f"{usage}_images.zip"
        with zipfile.ZipFile(os.path.join(folder, zip_rel), "w", zipfile.ZIP_DEFLATED) as z:
            for i, (x, _) in enumerate(items):
                z.writestr(f"{usage}/{i:04d}.png", png(x))
        if fmt == "coco":
            index = {"images": [{"id": i + 1, "file_name": f"{zip_rel}@{usage}/{i:04d}.png"}
                                for i in range(len(items))],
                     "annotations": [{"id": i + 1, "image_id": i + 1, "category_id": y + 1}
                                     for i, (_, y) in enumerate(items)],
                     "categories": [{"id": c + 1, "name": n} for c, n in enumerate(classes)]}
            index_rel = f"{usage}.json"
            with open(os.path.join(folder, index_rel), "w") as f:
                json.dump(index, f)
        else:
            index_rel = f"{usage}.txt"
            with open(os.path.join(folder, index_rel), "w") as f:
                for i, (_, y) in enumerate(items):
                    f.write(f"{zip_rel}@{usage}/{i:04d}.png {y}\n")
        entry[usage] = {"index_path": index_rel, "files_for_local_usage": [zip_rel]}
    with open(os.path.join(root, "vision_datasets.json"), "w") as f:
        json.dump([entry], f)
    return entry
