"""The vision-datasets hub: registry resolution and its egress gate
(counterpart of ``peft_vit_tpu/data/hub.py``).  The registry is the JAX
package's shipped ``vision_datasets.json``, read by path.  The port has no
download half: with the files present ``ensure_dataset`` resolves them
without touching the network, and with files missing it raises the JAX
package's provisioning message, whether or not ``download`` is set.  No
socket is ever opened.

What follows is the JAX module's own account.

Azure vision-datasets hub: registry resolution + gated download.

Reference behavior reproduced (few_shot):

* ``common/constants.py:4-12`` — the hub is the constant registry
  ``resources/datasets/vision_datasets.json`` (shipped verbatim here as
  package data, like the prompt tables) rooted at the public blob store
  ``VISION_DATASET_STORAGE``.
* ``evaluation/feature.py:540-587`` — ``create_dataset_manifest``
  downloads each split's coco-style index json plus the
  ``files_for_local_usage`` zip archives into a local cache, then the
  manifest readers take over.  Here the reading side already exists
  (``data/elevater.py`` streams the same registry/index/zip layout);
  this module adds the resolution + download half.

Downloads are EGRESS-GATED: this container has no network, so
``ensure_dataset`` only touches the wire when the caller passes
``download=True`` (or sets ``DATASET.DOWNLOAD``), and a failed/blocked
fetch raises with instructions for offline provisioning rather than
half-populating the cache (files land via a temp name + atomic rename).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# common/constants.py:4; the VISION_DATASET_STORAGE env var overrides
# (lets tests / mirrors point the hub at any blob layout, e.g. a
# localhost HTTP server serving the same directory structure)
_DEFAULT_STORAGE = "https://irisdatasets.blob.core.windows.net/share"
VISION_DATASET_STORAGE = os.environ.get(
    "VISION_DATASET_STORAGE", _DEFAULT_STORAGE
)


def storage_url() -> str:
    """Resolve the blob-storage base URL at CALL time (env override)."""
    return os.environ.get("VISION_DATASET_STORAGE", _DEFAULT_STORAGE)

_SPLITS = ("train", "val", "test")


def packaged_registry_path() -> str:
    """The shipped vision_datasets.json (the JAX package's resource, read by
    path as ``data.prompts`` reads the prompt tables)."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "peft_vit_tpu", "resources", "datasets", "vision_datasets.json")


def load_registry(path: Optional[str] = None) -> List[dict]:
    with open(path or packaged_registry_path()) as f:
        return json.load(f)


def resolve_entry(name: str, registry: Optional[List[dict]] = None) -> dict:
    """Find a dataset by name (latest version wins, like DatasetHub)."""
    reg = registry if registry is not None else load_registry()
    hits = [e for e in reg if e.get("name") == name]
    if not hits:
        known = sorted({e.get("name", "?") for e in reg})
        raise KeyError(
            f"dataset {name!r} not in the hub registry; known: {known}"
        )
    return max(hits, key=lambda e: e.get("version", 1))


def split_files(entry: dict, split: str) -> List[str]:
    """Files a split needs, relative to the entry's root_folder: the
    coco index json + every zip in files_for_local_usage
    (vision_datasets.json per-usage schema)."""
    s = entry.get(split)
    if not s:
        return []
    files = []
    if s.get("index_path"):
        files.append(s["index_path"])
    files.extend(s.get("files_for_local_usage", ()))
    return files


def dataset_files(entry: dict, splits=_SPLITS) -> List[str]:
    out: List[str] = []
    # entry-level labelmap (iris-format datasets name classes there,
    # e.g. cifar-10's labels.txt)
    if entry.get("labelmap"):
        out.append(entry["labelmap"])
    for sp in splits:
        for f in split_files(entry, sp):
            if f not in out:
                out.append(f)
    return out


def missing_files(entry: dict, dest_root: str, splits=_SPLITS) -> List[str]:
    local = os.path.join(dest_root, entry.get("root_folder", ""))
    return [
        f
        for f in dataset_files(entry, splits)
        if not os.path.exists(os.path.join(local, f))
    ]


def ensure_dataset(
    name: str,
    dest_root: str,
    *,
    splits=_SPLITS,
    storage: Optional[str] = None,
    registry_path: Optional[str] = None,
    download: bool = False,
) -> Dict[str, str]:
    """Resolve a hub dataset that is already provisioned under ``dest_root``.

    Returns {'root': <local dataset dir>, 'name': ..., 'root_folder': ...}
    once every file the requested splits need exists.  Missing files raise a
    FileNotFoundError listing the exact blobs to provision offline, with or
    without ``download`` (the port never fetches; the JAX package fetches
    only when asked and its container forbids it)."""
    storage = storage or storage_url()
    entry = resolve_entry(name, load_registry(registry_path))
    root_folder = entry.get("root_folder", "")
    local = os.path.join(dest_root, root_folder)
    missing = missing_files(entry, dest_root, splits)
    if not missing:
        return {"root": local, "name": name, "root_folder": root_folder}
    urls = [f"{storage.rstrip('/')}/{root_folder.rstrip('/')}/{f}" for f in missing]
    why = ("and this port does not download (no network)" if download
           else "and downloads are disabled (zero-egress default)")
    raise FileNotFoundError(
        f"hub dataset {name!r} is missing {len(missing)} file(s) under {local!r} {why}. "
        "Provision these blobs offline or pass download=True / set DATASET.DOWNLOAD: "
        + ", ".join(urls))
