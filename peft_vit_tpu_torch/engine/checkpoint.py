"""Checkpoint and auto-resume (counterpart of
``peft_vit_tpu/engine/checkpoint.py``, which keeps one Orbax
CheckpointManager a directory).

Reference semantics (lib/utils/utils.py:101-203, tools/train.py:230-258):
the composite state (trainable leaves, optimizer state, step, epoch, the
batch position inside the epoch, the random generator's state, EMA shadow,
SWA average and count, BN statistics) is saved by one process;
``TRAIN.AUTO_RESUME`` picks up the latest.  Here each save is one
``torch.save`` of that dict (tensors on the CPU) to ``<dir>/<step>.pt``,
written to a temporary file first and moved into place with ``os.replace``,
so a crash never leaves a torn checkpoint; the three newest are kept, as the
Orbax manager's ``max_to_keep=3``.  Saves are synchronous: the counterpart
of Orbax's ``wait=False`` returns after the write, so ``wait_for_saves`` has
nothing to wait for.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

MAX_TO_KEEP = 3
_CKPT = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{int(step)}.pt")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_checkpoint(directory: str, step: int, state: Dict[str, Any],
                    overwrite: bool = False, max_to_keep: int = MAX_TO_KEEP) -> None:
    """Save ``state`` (nested dicts of tensors and numbers) as ``step``.  A
    save to a step already on disk is a no-op unless ``overwrite``."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    if os.path.exists(path) and not overwrite:
        return
    tmp = os.path.join(directory, f".{int(step)}.pt.tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))
    logger.info("=> saved checkpoint step %d to %s", step, directory)


def wait_for_saves(directory: str) -> None:
    """Saves are synchronous: nothing is ever in flight."""
    del directory


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _load(directory: str, step: int) -> Dict[str, Any]:
    # mmap: reading the keys of a large checkpoint reads none of its tensors
    return torch.load(_path(directory, step), map_location="cpu", weights_only=True, mmap=True)


def checkpoint_keys(directory: str, step: Optional[int] = None) -> Optional[set]:
    """The top-level keys of a checkpoint (None when there is none), so that
    a resume tolerates checkpoints that predate newer state."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None
    return set(_load(directory, step)) or None


def _like(value, template):
    """``value`` on the template's device and in its dtype."""
    if isinstance(template, dict):
        return {k: _like(value[k], t) for k, t in template.items()}
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(value).to(device=template.device, dtype=template.dtype, copy=True)
    return value


def restore_checkpoint(directory: str, template: Dict[str, Any],
                       step: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The checkpoint ``step`` (default: the latest) in the shape of
    ``template`` (its keys, each tensor on the template's device and in its
    dtype); None when there is nothing to resume.  A key of the template
    that the checkpoint lacks raises ``KeyError``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None
    stored = _load(directory, step)
    restored = {k: _like(stored[k], t) for k, t in template.items()}
    logger.info("=> resumed from %s step %d", directory, step)
    return restored


def dump_nan_state(path: str, **arrays) -> None:
    """The NaN-loss forensic dump (lib/core/function.py:91-107): the given
    arrays (numpy or tensors; dicts and None are left out) in one npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in arrays.items() if v is not None and not isinstance(v, dict)})
    logger.error("=> NaN loss: dumped state to %s", path)
