"""Prompt templates and class names of the zero-shot classifier (counterpart
of ``peft_vit_tpu/data/prompts.py``).

``class_map`` and ``template_map`` resolve, in order, from a user's JSON
file (``{"classes": [...], "templates": ["a photo of a {}.", ...]}`` at
``DATASET.ROOT/<name>/prompts.json`` or ``DATASET.ROOT/<name>_prompts.json``),
from the per-dataset JSON resources of the JAX package (read by path from
``PROMPTS_DIR``, one file per dataset), then from the built-in entries below
and the generic templates.  ``register_prompts`` overrides them at run time.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: the per-dataset class lists and template sets, read from the JAX package
PROMPTS_DIR = os.path.join(_REPO, "peft_vit_tpu", "resources", "prompts")

GENERIC_TEMPLATES = [
    "a photo of a {}.",
    "a photo of the {}.",
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
]

_CLASS_MAP: Dict[str, List[str]] = {
    "cifar-10": ["airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse",
                 "ship", "truck"],
    "mnist": [str(i) for i in range(10)],
    "patch-camelyon": ["lymph node", "lymph node containing metastatic tumor tissue"],
    "rendered-sst2": ["negative", "positive"],
    "hateful-memes": ["meme", "hatespeech meme"],
    "kitti-distance": [
        "a photo i took of a car on my left or right side.",
        "a photo i took with a car nearby.",
        "a photo i took with a car in the distance.",
        "a photo i took with no car.",
    ],
    "eurosat_clip": [
        "annual crop land", "forest", "brushland or shrubland", "highway or road",
        "industrial buildings or commercial buildings", "pasture land", "permanent crop land",
        "residential buildings or homes or apartments", "river", "lake or sea",
    ],
}

_TEMPLATE_MAP: Dict[str, List[str]] = {
    "cifar-10": [
        "a photo of a {}.",
        "a blurry photo of a {}.",
        "a black and white photo of a {}.",
        "a low contrast photo of a {}.",
        "a high contrast photo of a {}.",
        "a bad photo of a {}.",
        "a good photo of a {}.",
        "a photo of a small {}.",
        "a photo of a big {}.",
        "a photo of the {}.",
        "a blurry photo of the {}.",
        "a black and white photo of the {}.",
        "a low contrast photo of the {}.",
        "a high contrast photo of the {}.",
        "a bad photo of the {}.",
        "a good photo of the {}.",
        "a photo of the small {}.",
        "a photo of the big {}.",
    ],
    "mnist": ['a photo of the number: "{}".'],
    "patch-camelyon": ["this is a photo of {}"],
    "rendered-sst2": ["a {} review of a movie."],
    "kitti-distance": ["{}"],
    "eurosat_clip": [
        "a centered satellite photo of {}.",
        "a centered satellite photo of a {}.",
        "a centered satellite photo of the {}.",
    ],
}
_TEMPLATE_MAP["cifar-100"] = _TEMPLATE_MAP["cifar-10"]

_builtin_cache: Dict[str, Optional[dict]] = {}


def _builtin(dataset: str) -> Optional[dict]:
    if dataset not in _builtin_cache:
        path = os.path.join(PROMPTS_DIR, f"{dataset}.json")
        _builtin_cache[dataset] = None
        if os.path.exists(path):
            with open(path) as f:
                _builtin_cache[dataset] = json.load(f)
    return _builtin_cache[dataset]


def _external(root: str, dataset: str) -> Optional[dict]:
    for path in (os.path.join(root or "", dataset, "prompts.json"),
                 os.path.join(root or "", f"{dataset}_prompts.json")):
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    return None


def class_map(dataset: str, root: str = "") -> Optional[List[str]]:
    ext = _external(root, dataset)
    if ext and "classes" in ext:
        return list(ext["classes"])
    built = _builtin(dataset)
    if built and "classes" in built:
        return list(built["classes"])
    return _CLASS_MAP.get(dataset)


def template_map(dataset: str, root: str = "") -> List[str]:
    ext = _external(root, dataset)
    if ext and "templates" in ext:
        return list(ext["templates"])
    built = _builtin(dataset)
    if built and "templates" in built:
        return list(built["templates"])
    return _TEMPLATE_MAP.get(dataset, GENERIC_TEMPLATES)


def register_prompts(dataset: str, classes: List[str],
                     templates: Optional[List[str]] = None) -> None:
    """Run-time registration; overrides the resources."""
    entry = dict(_builtin(dataset) or {})
    entry["classes"] = list(classes)
    if templates:
        entry["templates"] = list(templates)
    _builtin_cache[dataset] = entry
