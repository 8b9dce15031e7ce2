"""Epoch sample-order strategies of the streaming trainer (counterpart of
``peft_vit_tpu/data/samplers.py``): numpy ``RandomState`` orders, equal
element for element to the JAX package's.  What follows is the JAX module's
own account.

Reference: full_shot's ``TRAIN.SAMPLER`` config key
(full_shot/main/lib/config/default.py:69-73) selecting among the
``dataset`` package's samplers — default shuffle, class-aware resampling
(uniform over classes with cycling per-class queues, for long-tailed
data), and chunk sampling (shuffle chunks, then within chunks — keeps
TSV shard reads disk-local).

All strategies are host-side numpy index orders consumed by
``NativeTsvLoader.epoch(order=...)``; they are deterministic in
``(seed, epoch)`` so every process in a multi-host run derives the same
global order before taking its shard.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def default_order(n: int, epoch: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + epoch).permutation(n).astype(
        np.int64
    )


def class_aware_order(
    labels: np.ndarray,
    epoch: int,
    seed: int = 0,
    num_samples: Optional[int] = None,
) -> np.ndarray:
    """Uniform-over-classes resampling: each draw picks a class uniformly,
    then the next instance from that class's shuffled cyclic queue
    (the ClassAwareSampler recipe for long-tailed datasets)."""
    rng = np.random.RandomState(seed + epoch)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    n = int(num_samples or len(labels))
    picks = rng.randint(0, len(classes), size=n)
    out = np.empty(n, np.int64)
    for ci, c in enumerate(classes):
        pos = np.where(picks == ci)[0]
        if pos.size == 0:
            continue
        pool = np.where(labels == c)[0]
        reps = -(-pos.size // pool.size)
        queue = np.concatenate(
            [rng.permutation(pool) for _ in range(reps)]
        )[: pos.size]
        out[pos] = queue
    return out


def chunk_order(
    n: int, epoch: int, seed: int = 0, chunk_size: int = 1024
) -> np.ndarray:
    """Shuffle chunk order, then shuffle within each chunk: near-random
    statistically but each chunk's reads stay contiguous on disk."""
    rng = np.random.RandomState(seed + epoch)
    starts = np.arange(0, n, chunk_size)
    out = np.empty(n, np.int64)
    o = 0
    for ci in rng.permutation(len(starts)):
        s = int(starts[ci])
        e = min(s + chunk_size, n)
        idx = np.arange(s, e, dtype=np.int64)
        rng.shuffle(idx)
        out[o : o + len(idx)] = idx
        o += len(idx)
    return out


def shard_order(
    order: np.ndarray, process_index: int, process_count: int
) -> np.ndarray:
    """This process's slice of a global order (sample-interleaved; every
    process sees the same global order, so shards are disjoint)."""
    if process_count <= 1:
        return order
    return order[process_index::process_count]


def build_order(
    sampler: str,
    n: int,
    epoch: int,
    seed: int = 0,
    labels_fn: Optional[Callable[[], np.ndarray]] = None,
    chunk_size: int = 1024,
) -> np.ndarray:
    name = (sampler or "default").lower()
    if name in ("default", "random", ""):
        return default_order(n, epoch, seed)
    if name in ("class_aware", "classaware", "class-aware"):
        if labels_fn is None:
            raise ValueError("class_aware sampler needs labels")
        return class_aware_order(labels_fn(), epoch, seed, num_samples=n)
    if name == "chunk":
        return chunk_order(n, epoch, seed, chunk_size)
    raise ValueError(f"Unknown TRAIN.SAMPLER {sampler!r}")
