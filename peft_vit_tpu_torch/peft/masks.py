"""Trainable-parameter masks (counterpart of ``peft_vit_tpu/peft/masks.py``).

The reference freezes and unfreezes by substring filters on parameter
names.  The predicates below are the JAX package's, letter for letter, and
still read its ``/``-joined paths (``backbone/blocks_1/attn/q_adapter1/kernel``):
``models.convert.jax_path`` maps each of this package's names to that path,
so no predicate is rewritten for dotted names.

A mask is ``{name: bool}`` over ``named_parameters()`` (True = trainable).
``split_params`` applies it the PyTorch way: ``requires_grad_`` per leaf,
so autograd never computes a frozen gradient, and name-keyed dicts of the
trainable and the frozen tensors for the functional train step.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Tuple, Union

import torch
from torch import nn

from ..models.convert import jax_path

PathPredicate = Callable[[str], bool]
Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _is_head(path: str) -> bool:
    return path.startswith("classifier/") or "/head/" in path or path.startswith(
        "head/"
    )


def _method_predicate(
    method: str, num_layers: int, adapter_layers=None
) -> PathPredicate:
    if method in ("none",):
        return lambda p: False
    if method == "linear":
        return lambda p: False  # head handled by train_head
    if method == "full":
        # full fine-tune trains everything except the text tower
        return lambda p: not p.startswith("text/")
    if method == "bitfit":
        return lambda p: p.endswith("/bias") and not p.startswith("text/")
    if method == "layernorm":
        return lambda p: (
            ("/ln_" in p or "norm" in p)
            and not p.startswith("text/")
            and "adapter_norm" not in p
        )
    if method == "attention":
        return lambda p: "/attn/" in p and not p.startswith("text/")
    if method == "lora":
        return lambda p: "adapter" in p
    if method == "lora_fix_one":
        return lambda p: "adapter1" in p
    if method in ("lora_moe", "lora_adapter", "lora_drop_adapter"):
        return lambda p: "adapter" in p or "moe" in p
    if method == "lora_compacter":
        return lambda p: "adapter" in p or "compacter" in p
    if method == "first_attention":
        return lambda p: "blocks_1/attn" in p
    if method == "first_mlp":
        return lambda p: "blocks_1/mlp" in p
    if method == "adapter":
        return lambda p: "/adapter/" in p
    if method == "adapterdrop":
        # Only executing adapters train: skipped blocks receive exactly zero
        # gradient, so narrowing the mask changes nothing.
        if adapter_layers:
            frags = tuple(f"blocks_{i}/adapter/" for i in adapter_layers)
            return lambda p: any(f in p for f in frags)
        return lambda p: "/adapter/" in p
    if method == "compacter":
        return lambda p: "compacter" in p
    if method == "kadaptation":
        return lambda p: bool(
            re.search(r"(phm_rule|W_left\d|W_right\d|phmb)", p)
        )
    if method == "rpb":
        return lambda p: "relative_position_bias_table" in p
    if method == "lepe":
        return lambda p: "get_v" in p
    if method == "transformer_probe":
        return lambda p: f"blocks_{num_layers}/" in p
    if method == "vpt":
        return lambda p: "prompt_embeddings" in p
    if method == "finetune_contrast":
        # text tower frozen; image tower + fresh logit_scale train
        return lambda p: not p.startswith("text/")
    if method == "linear_probe_contrast":
        # conv1/ln_pre/transformer frozen; ln_post, proj, class/positional
        # embeddings and logit_scale stay trainable
        return lambda p: (
            p.endswith("logit_scale")
            or "ln_post" in p
            or p.endswith("backbone/proj")
            or "cls_token" in p
            or "class_embedding" in p
            or "pos_embed" in p
            or "positional_embedding" in p
        )
    if method == "intrinsic":
        # the intrinsic vector lives outside the model; inside the model
        # nothing trains except the head
        return lambda p: False
    raise ValueError(f"No trainable filter for method {method!r}")


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def build_mask(
    params: Params,
    method: str,
    num_layers: int = 12,
    train_head: bool = True,
    extra_regex: str = "",
    adapter_layers=None,
) -> Dict[str, bool]:
    """``{name: trainable}`` over the parameters of a module (or a
    name-keyed dict of them).  ``extra_regex`` searches the JAX-style path."""
    pred = _method_predicate(method, num_layers, adapter_layers)
    extra = re.compile(extra_regex) if extra_regex else None
    mask = {}
    for name, p in _named(params).items():
        path = jax_path(name, p.dim())
        m = pred(path)
        if train_head and _is_head(path):
            m = True
        if extra is not None and extra.search(path):
            m = True
        mask[name] = m
    return mask


def split_params(
    model: nn.Module, mask: Mapping[str, bool]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Set ``requires_grad`` of every parameter of ``model`` from ``mask`` and
    return ``(trainable, frozen)``, name-keyed dicts of the model's own
    tensors."""
    named = _named(model)
    if set(named) != set(mask):
        raise ValueError("the mask does not name the model's parameters: "
                         f"{sorted(set(named) ^ set(mask))[:5]} ...")
    trainable, frozen = {}, {}
    for name, p in named.items():
        p.requires_grad_(bool(mask[name]))
        (trainable if mask[name] else frozen)[name] = p
    return trainable, frozen


def merge_params(
    train: Mapping[str, torch.Tensor], frozen: Mapping[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    return {**frozen, **train}


def count_trainable(params: Params, mask: Mapping[str, bool]) -> int:
    return int(sum(p.numel() for name, p in _named(params).items() if mask[name]))


def describe_mask(params: Params, mask: Mapping[str, bool]) -> str:
    """Human-readable list of trainable parameter names (the analog of the
    reference's ``=> name ... requires grad`` log lines)."""
    named = _named(params)
    lines = [f"{k}  {tuple(named[k].shape)}" for k in sorted(named) if mask[k]]
    total = count_trainable(named, mask)
    lines.append(f"Number of trainable params: {total / 1e6}M.")
    return "\n".join(lines)
