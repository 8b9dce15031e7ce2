"""Metric registry (counterpart of ``peft_vit_tpu/engine/metrics.py``: the
numpy metrics are copies, ``topk_accuracy`` takes tensors).

Reference: few_shot/vision_benchmark/evaluation/metric.py:7-47 dispatches to
`vision-evaluation` evaluators (accuracy, mean-per-class "balanced"
accuracy, 11-point interpolated mAP, roc_auc) and full_shot
lib/core/evaluate.py provides top-k accuracy.

Device-side metrics (top-k) take tensors; the sweep-level
metrics run on host numpy over gathered predictions, mirroring the
reference protocol (predictions are small: num_test x num_classes).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def topk_accuracy(logits: torch.Tensor, target: torch.Tensor, ks=(1,)):
    """Top-k accuracy in percent (lib/core/evaluate.py semantics)."""
    out = []
    ranked = torch.argsort(-logits, dim=-1, stable=True)
    for k in ks:
        hit = (ranked[:, :k] == target[:, None]).any(dim=-1)
        out.append(100.0 * hit.to(torch.float32).mean())
    return out


def accuracy_np(scores: np.ndarray, target: np.ndarray) -> float:
    pred = scores.argmax(-1)
    return float(100.0 * (pred == target).mean())


def balanced_accuracy_np(scores: np.ndarray, target: np.ndarray) -> float:
    """Mean-per-class recall ('accuracy' for class-imbalanced datasets;
    vision-evaluation BalancedAccuracyScoreEvaluator)."""
    pred = scores.argmax(-1)
    accs = []
    for c in np.unique(target):
        m = target == c
        accs.append((pred[m] == c).mean())
    return float(100.0 * np.mean(accs))


def average_precision_11point_np(
    scores: np.ndarray, target: np.ndarray
) -> float:
    """11-point interpolated mAP over classes for multilabel targets
    (vision-evaluation MeanAveragePrecisionEvaluatorForMultipleIOUs style,
    VOC protocol).  target: (N, C) binary."""
    if target.ndim == 1:
        n_cls = scores.shape[1]
        onehot = np.zeros_like(scores)
        onehot[np.arange(len(target)), target] = 1
        target = onehot
    aps = []
    for c in range(scores.shape[1]):
        y = target[:, c]
        if y.sum() == 0:
            continue
        order = np.argsort(-scores[:, c])
        y = y[order]
        tp = np.cumsum(y)
        precision = tp / np.arange(1, len(y) + 1)
        recall = tp / y.sum()
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            p = precision[recall >= t]
            ap += (p.max() if p.size else 0.0) / 11.0
        aps.append(ap)
    return float(100.0 * np.mean(aps)) if aps else 0.0


def roc_auc_np(scores: np.ndarray, target: np.ndarray) -> float:
    """Macro ROC-AUC via rank statistic (no sklearn dependency needed)."""
    if target.ndim == 1:
        n_cls = scores.shape[1]
        onehot = np.zeros_like(scores)
        onehot[np.arange(len(target)), target] = 1
        target = onehot
    aucs = []
    for c in range(scores.shape[1]):
        y = target[:, c]
        pos, neg = int(y.sum()), int((1 - y).sum())
        if pos == 0 or neg == 0:
            continue
        ranks = scores[:, c].argsort().argsort() + 1
        auc = (ranks[y == 1].sum() - pos * (pos + 1) / 2) / (pos * neg)
        aucs.append(auc)
    return float(100.0 * np.mean(aucs)) if aucs else 0.0


_REGISTRY: Dict[str, Callable] = {
    "accuracy": accuracy_np,
    "top1": accuracy_np,
    "mean-per-class": balanced_accuracy_np,
    "balanced": balanced_accuracy_np,
    "11point_mAP": average_precision_11point_np,
    "mAP": average_precision_11point_np,
    "roc_auc": roc_auc_np,
}

# datasets scored with non-default metrics (metric.py:7-34 table)
DATASET_METRICS = {
    "caltech-101": "mean-per-class",
    "oxford-flower-102": "mean-per-class",
    "oxford-iiit-pets": "mean-per-class",
    "fgvc-aircraft-2013b-variants102": "mean-per-class",
    "voc-2007-classification": "11point_mAP",
    "chestx-ray8": "roc_auc",
    "hateful-memes": "roc_auc",
    "patch-camelyon": "accuracy",
}


def get_metric(name: str) -> Callable[[np.ndarray, np.ndarray], float]:
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown metric {name!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def metric_for_dataset(dataset: str) -> str:
    if dataset in DATASET_METRICS:
        return DATASET_METRICS[dataset]
    # registered datasets carry their own metric (data/registry.py)
    from ..data.registry import _INFO

    if dataset in _INFO:
        return _INFO[dataset].metric
    return "accuracy"
