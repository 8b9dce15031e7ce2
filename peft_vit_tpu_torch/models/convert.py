"""Weights carried across from the JAX package.

``params_from_jax`` maps a flax variables tree of the JAX package
(``{'params': ..., 'batch_stats': ...}``, numpy or JAX arrays, with exactly
the names a flax init produces) to this package's ``state_dict``:

* module path ``a/b/c`` -> ``a.b.c``; ``blocks_<i>`` -> ``blocks.<i>``;
* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
* LayerNorm ``scale`` -> ``weight``;
* everything else (biases, ``class_embedding``, ``positional_embedding``,
  ``proj``, ``bn_mean``, ``bn_var``) keeps its name and layout.

Arrays arrive as fp32.  Loading copies each into the dtype the model
stores it in: fp32 for every trainable leaf (and for every leaf before
``layers.cast_frozen_``), so a master weight never passes through bf16.

``jax_path`` and ``params_to_jax`` are the inverse map, from this package's
names and layouts back to the JAX package's.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_COLLECTIONS = ("params", "batch_stats")
_BLOCK = re.compile(r"^blocks_(\d+)$")
_BATCH_STATS = ("bn_mean", "bn_var")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _torch_name_and_array(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *modules, name = path
    if name == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
        name = "weight"
    elif name == "scale":
        name = "weight"
    parts = []
    for m in modules:
        block = _BLOCK.match(m)
        parts.extend(("blocks", block.group(1)) if block else (m,))
    return ".".join((*parts, name)), arr


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's variables tree -> this package's ``state_dict``."""
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    state = {}
    for collection in _COLLECTIONS:
        for path, leaf in _leaves(variables.get(collection, {})):
            name, arr = _torch_name_and_array(path, np.asarray(leaf, dtype=np.float32))
            if name in state:
                raise ValueError(f"two JAX leaves map to {name}")
            state[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a JAX variables tree into ``model``; missing or unexpected keys
    and shape mismatches raise."""
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def jax_path(name: str, ndim: int) -> str:
    """This package's parameter name -> the JAX package's ``/``-joined path:
    ``backbone.blocks.1.attn.q_adapter1.weight`` (2-D) ->
    ``backbone/blocks_1/attn/q_adapter1/kernel``.  A ``weight`` of rank 1 is
    a LayerNorm ``scale``, of rank 2 or 4 a ``kernel``."""
    *modules, leaf = name.split(".")
    if leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    parts = []
    for m in modules:
        if m.isdigit() and parts and parts[-1] == "blocks":
            parts[-1] = f"blocks_{m}"
        else:
            parts.append(m)
    return "/".join((*parts, leaf))


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """A ``state_dict`` of this package -> the JAX package's variables tree
    (nested dicts of fp32 numpy arrays): the inverse of ``params_from_jax``."""
    variables: Dict[str, dict] = {}
    for name, tensor in state.items():
        arr = tensor.detach().to(torch.float32).cpu().numpy()
        *modules, leaf = jax_path(name, arr.ndim).split("/")
        if leaf == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        collection = "batch_stats" if leaf in _BATCH_STATS else "params"
        node = variables.setdefault(collection, {})
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return variables
