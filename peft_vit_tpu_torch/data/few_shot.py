"""Few-shot sampling and class-balanced train/val splitting (a copy of
``peft_vit_tpu/data/few_shot.py``: the same seed picks the same images).

Reference semantics reproduced exactly:

* ``sample_few_shot_subset`` — vision_datasets' manifest sampler invoked at
  feature.py:580-583: per class, keep ``k`` random images (seeded);
  multilabel images count toward every label they carry, and classes keep
  at least one image even when over-subscribed.
* ``balanced_val_split`` — feature.py:87-148: per class take the FIRST
  ceil(count * val_split) sample indices (deterministic, not random — the
  reference comment says "not doing random. confirm that it is
  unnecessary"); multilabel uses the greedy per-label quota walk
  (:129-143).
* 1-shot -> 2-shot promotion and the 10000-shot patch-camelyon rule live in
  commands/* (commands/adapter_clip.py:112-133) — here `effective_shots`.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Tuple

import numpy as np


def effective_shots(num_shots: int, dataset: str) -> int:
    """commands/adapter_clip.py:112-133: 1-shot runs as 2-shot (the 20%
    val split needs >= 1 image); patch-camelyon 10000-shot special case."""
    if num_shots == 1:
        return 2
    if dataset == "patch-camelyon" and num_shots == 10000:
        return 10000
    return num_shots


def sample_few_shot_subset(
    labels: np.ndarray, k: int, seed: int
) -> np.ndarray:
    """Return indices of a k-shot subset.

    labels: (n,) int for multiclass, or (n, c) binary for multilabel.
    """
    rng = np.random.RandomState(seed)
    n = labels.shape[0]
    if labels.ndim == 1:
        picked: List[int] = []
        for c in np.unique(labels):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            picked.extend(idx[:k].tolist())
        return np.sort(np.asarray(picked))
    # multilabel: greedily fill per-class quotas
    c = labels.shape[1]
    quota = np.full(c, k, np.int64)
    order = rng.permutation(n)
    picked = []
    for i in order:
        pos = labels[i] > 0
        if (quota[pos] > 0).any():
            picked.append(i)
            quota[pos] -= 1
    return np.sort(np.asarray(picked))


def balanced_val_split(
    labels: np.ndarray, val_split: float = 0.2
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-balanced (train_idx, val_idx), reference feature.py:87-148."""
    if labels.ndim == 1:
        cls_to_count = Counter(labels.tolist())
        val_indices = []
        for label in cls_to_count:
            n_samples = math.ceil(cls_to_count[label] * val_split)
            samples = np.where(labels == label)[0][:n_samples]
            val_indices.append(samples)
        val_idx = set(np.concatenate(val_indices).tolist())
        train_idx = set(range(len(labels))) - val_idx
        return (
            np.asarray(sorted(train_idx)),
            np.asarray(sorted(val_idx)),
        )
    # multilabel greedy quota walk (feature.py:129-143)
    lab = labels.copy().astype(np.int64)
    val_target = np.ceil(lab.sum(axis=0) * val_split)
    next_targets = np.where(val_target > 0)[0]
    val_idx: List[int] = []
    while next_targets.size > 0:
        target_cls = next_targets[0]
        candidates = np.where(lab[:, target_cls] > 0)[0]
        if candidates.size == 0:
            val_target[target_cls] = 0
            next_targets = np.where(val_target > 0)[0]
            continue
        next_sample = candidates[0]
        val_idx.append(int(next_sample))
        val_target -= lab[next_sample]
        lab[next_sample] = 0
        next_targets = np.where(val_target > 0)[0]
    train_idx = sorted(set(range(len(labels))) - set(val_idx))
    return np.asarray(train_idx), np.asarray(sorted(set(val_idx)))
