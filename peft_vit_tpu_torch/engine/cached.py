"""The cached-prefix sweep (counterpart of ``peft_vit_tpu/engine/cached.py``).

When the first trainable leaf sits in block K > 0 (AdapterDrop on its last
blocks, the transformer probe's extra block, first_attention and first_mlp
in block 1, the linear probe with K = L), blocks 0 .. K-1 are the same for
every cell and epoch of the lr x wd sweep: their output is computed once per
image (``precompute_prefix_tokens``) and the cells train the suffix from
block K on (``make_suffix_apply``).  ``maybe_cache_prefix`` is the driver's
switch, ``TRAIN.CACHE_FROZEN_PREFIX`` (on by default, as in the JAX driver).

On the card each prefix batch is a CUDA-graph replay (``engine.train``'s
``StepGraph``, kept under ``("prefix", None, batch)``; ``engine.train.runs_captured``
decides, as for the sweep's steps and evals).  The tokens come back to the host in fp32, which holds the
compute dtype's values exactly; the suffix casts them back to it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from . import train as _train
from .train import ApplyFn, pad_dataset

logger = logging.getLogger(__name__)


def first_trainable_layer(mask: Mapping[str, bool], num_layers: int) -> int:
    """Depth of the first backbone block with a trainable leaf: 0 when
    anything at or before block 0 trains (the embeddings, the prompts,
    ``ln_pre``, block 0: no cache), ``num_layers`` when only the head (or the
    probe's extra block, which sits after the tower) does."""
    cut = num_layers
    for name, trainable in mask.items():
        if not trainable or name.startswith("classifier."):
            continue
        parts = name.split(".")
        if parts[:2] != ["backbone", "blocks"]:
            return 0
        cut = min(cut, int(parts[2]))
    return cut


def precompute_prefix_tokens(model: nn.Module, x: np.ndarray, cut: int, batch_size: int = 64,
                             frozen: Optional[Mapping[str, torch.Tensor]] = None,
                             graphs: Optional[dict] = None) -> np.ndarray:
    """The tower's tokens after block ``cut - 1`` for every image of ``x``
    (numpy, fp32), from the eval-mode forward of ``model.backbone`` on the
    model's device with the tensors of ``frozen`` (classifier names: the
    int8 tree) substituted, ``batch_size`` images at a time.  On the card
    each batch is a replay of one ``StepGraph`` in ``graphs``."""
    device = next(model.parameters()).device
    sub = {k[len("backbone."):]: v for k, v in (frozen or {}).items()
           if k.startswith("backbone.")}
    n = x.shape[0]
    xp, _, _ = pad_dataset(np.asarray(x), np.zeros(n, np.int64), batch_size)
    xd = torch.as_tensor(xp, device=device)
    idxs = torch.arange(xd.shape[0], device=device).reshape(-1, batch_size)
    model.train(False)

    def body(inputs):
        with torch.no_grad():
            return functional_call(model.backbone, sub, (xd[inputs["idx"]],),
                                   {"stop_layer": cut})

    if _train.runs_captured(xd):
        graph = _train._graph({} if graphs is None else graphs, ("prefix", None, batch_size), body,
                       {"idx": idxs[0]}, (xd, *sub.values()))
        # a copy of each replay's output, which the next replay overwrites
        outs = [graph(idx=idx).to(torch.float32, copy=True).cpu() for idx in idxs]
    else:
        outs = [body({"idx": idx}).to(torch.float32) for idx in idxs]
    return torch.cat(outs)[:n].numpy()


def make_suffix_apply(model: nn.Module, cut: int) -> ApplyFn:
    """``apply_fn(variables, tokens, train)`` (``engine.train.make_apply_fn``)
    over the tokens after block ``cut - 1``, resuming at block ``cut``."""

    def apply_fn(variables, tokens, train):
        model.train(train)
        return functional_call(model, dict(variables), (tokens,), {"start_layer": cut})

    return apply_fn


def maybe_cache_prefix(cfg, model: nn.Module, mask: Mapping[str, bool], num_layers: int,
                       splits, frozen: Optional[Mapping[str, torch.Tensor]] = None,
                       graphs: Optional[dict] = None) -> Optional[Tuple[ApplyFn, object, int]]:
    """``(apply_fn, token_splits, cut)`` when the cache applies
    (``TRAIN.CACHE_FROZEN_PREFIX`` and a first trainable block ``cut`` > 0),
    else None.  ``token_splits`` is ``splits`` with the token arrays in place
    of the images; the prefix batches are ``TEST.BATCH_SIZE_PER_GPU``
    images."""
    if not bool(cfg.TRAIN.get("CACHE_FROZEN_PREFIX", True)):
        return None
    # only the layer-addressable ViT is cut (the JAX package's style check)
    if getattr(getattr(model, "backbone", None), "style", None) not in ("clip", "timm"):
        return None
    if getattr(model.backbone, "scan_layers", False):
        # the stacked layout runs all its blocks or none: no prefix / suffix cut
        return None
    cut = first_trainable_layer(mask, num_layers)
    if cut <= 0:
        return None
    batch = int(cfg.TEST.BATCH_SIZE_PER_GPU)
    logger.info("=> cached-backbone sweep: frozen prefix through block %d computed once; "
                "cells train the suffix only", cut - 1)
    tok = {f: precompute_prefix_tokens(model, getattr(splits, f), cut, batch, frozen, graphs)
           for f in ("x_train", "x_val", "x_test") if getattr(splits, f).size}
    return make_suffix_apply(model, cut), dataclasses.replace(splits, **tok), cut
