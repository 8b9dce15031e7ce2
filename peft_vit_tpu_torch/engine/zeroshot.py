"""Zero-shot evaluation and frozen-feature extraction (counterpart of
``peft_vit_tpu/engine/zeroshot.py``).

* ``extract_text_features`` (the reference's feature.py:350-509): per class,
  embed every template (and the optional knowledge text), L2-normalize each,
  average over the templates, L2-normalize the mean.  One ``encode_text``
  call per class, as the JAX function.
* ``clip_zeroshot_evaluator`` (clip_zeroshot_evaluator.py:9-22):
  ``logits = 100 * img_feats @ text_feats^T`` -> the metric.
* ``extract_image_features`` with the npz cache of the reference's
  commands/linear_probe.py:55-90.
* ``knowledge_text``: the external definition text (WordNet, Wiktionary,
  GPT-3) appended to each class prompt when configured and present.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from ..data.prompts import class_map, template_map
from ..data.tokenizer import tokenize
from .metrics import get_metric

logger = logging.getLogger(__name__)


def knowledge_text(cfg, dataset: str, classname: str) -> str:
    """The external knowledge suffix of a class ('' when disabled)."""
    k = cfg.KNOWLEDGE
    parts: List[str] = []
    for flag, path_key, kind in ((k.WIKITIONARY.USE_DEFINITION, k.WIKITIONARY.WIKI_DICT_PATH,
                                  "wiki"),
                                 (k.GPT3.USE_GPT3, k.GPT3.GPT3_DICT_PATH, "gpt3")):
        if not flag:
            continue
        path = os.path.join(str(path_key), f"{dataset}_knowledge.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            entry = json.load(f).get(classname) or {}
        txt = entry.get("def") or entry.get(kind) or ""
        if isinstance(txt, list):
            txt = " ".join(txt[: int(k.AGGREGATION.NUM_GPT3_ITEMS)])
        if txt:
            parts.append(str(txt))
    return (" " + " ".join(parts)) if parts else ""


def extract_text_features(
    encode_text: Callable,
    cfg,
    dataset: Optional[str] = None,
    classnames: Optional[List[str]] = None,
    context_length: Optional[int] = None,
) -> torch.Tensor:
    """(num_classes, embed_dim) L2-normalized fp32 zero-shot classifier on
    the text tower's device.  ``encode_text``: token ids -> features
    (``models.text.TextEncoder``)."""
    dataset = dataset or cfg.DATASET.DATASET
    classnames = classnames or class_map(dataset, cfg.DATASET.ROOT)
    if classnames is None:
        raise ValueError(f"No class names for dataset {dataset!r}: add prompts.json under "
                         "DATASET.ROOT or register_prompts().")
    templates = template_map(dataset, cfg.DATASET.ROOT)
    ctx = (context_length or getattr(encode_text, "context_length", None)
           or int(cfg.MODEL.SPEC.TEXT.CONTEXT_LENGTH))
    feats = []
    for name in classnames:
        suffix = knowledge_text(cfg, dataset, name)
        toks = tokenize([t.format(name) + suffix for t in templates], ctx)
        emb = encode_text(toks).to(torch.float32)
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        mean = emb.mean(dim=0)
        feats.append(mean / torch.linalg.vector_norm(mean))
    return torch.stack(feats)


def extract_image_features(
    encode_image: Callable,
    x: np.ndarray,
    batch_size: int = 64,
    normalize: bool = True,
    cache_path: Optional[str] = None,
) -> np.ndarray:
    """Frozen-tower features of ``x`` in batches of ``batch_size``, fp32
    numpy, L2-normalized (``normalize``, floored at 1e-12), with the npz
    cache (the reference's commands/linear_probe.py:55-90).
    ``encode_image``: a numpy batch -> features."""
    if cache_path and os.path.exists(cache_path):
        logger.info("=> load features from %s", cache_path)
        return np.load(cache_path)["feats"]
    outs = [np.asarray(torch.as_tensor(encode_image(x[i:i + batch_size])).to(torch.float32)
                       .cpu()) for i in range(0, x.shape[0], batch_size)]
    feats = np.concatenate(outs)
    if normalize:
        feats = feats / np.clip(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-12, None)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez_compressed(cache_path, feats=feats)
        logger.info("=> saved features to %s", cache_path)
    return feats


def clip_zeroshot_evaluator(image_features, text_features, labels, metric_name: str = "accuracy"):
    """``(result, logits)``: the metric of ``100 * img @ text^T`` in fp32
    (clip_zeroshot_evaluator.py:9-22)."""
    img = torch.as_tensor(np.asarray(image_features), dtype=torch.float32)
    txt = torch.as_tensor(text_features).to(dtype=torch.float32, device="cpu")
    logits = 100.0 * img @ txt.t()
    result = get_metric(metric_name)(logits.numpy(), np.asarray(labels))
    return result, logits
