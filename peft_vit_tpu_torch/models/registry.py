"""Custom-model extension contract (counterpart of
``peft_vit_tpu/models/registry.py``).

The reference documents how users plug their own architectures into the
benchmark (models/cls_example.py:4-17, models/clip_example.py:4-23): a
builder registered under a name, or a ``module:function`` path in
``MODEL.NAME``, owns the whole model construction.

A builder has the port's factory contract::

    def build(cfg, spec: PEFTSpec, num_classes: int, device: torch.device,
              seed: int) -> (model, params, encode_text_or_None)

* ``model`` — an ``nn.Module`` on ``device`` whose ``forward(images)`` maps
  (B, H, W, 3) images to logits (the classifier contract), and which may
  expose ``backbone`` for the feature-extraction paths;
* ``params`` — its named parameters (``dict(model.named_parameters())``);
* ``encode_text`` — a function of (N, context) token ids -> (N, D) text
  features for zero-shot evaluation (``models.text.TextEncoder``), or
  ``None`` for a supervised-only model.

Usage::

    from peft_vit_tpu_torch.models.registry import register_model

    @register_model("my_tiny_net")
    def build_my_tiny_net(cfg, spec, num_classes, device, seed):
        ...
        return model, dict(model.named_parameters()), None

    # cfg.MODEL.NAME = "my_tiny_net"        (a registered name), or
    # cfg.MODEL.NAME = "mypkg.nets:build"   (an import path, no registration)
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Optional

_BUILDERS: Dict[str, Callable] = {}


def register_model(name: str) -> Callable:
    """Decorator: register ``builder(cfg, spec, num_classes, device, seed)``
    under ``name`` for ``MODEL.NAME`` dispatch.  The last registration wins."""

    def deco(fn: Callable) -> Callable:
        _BUILDERS[str(name)] = fn
        return fn

    return deco


def get_custom_builder(name: str) -> Optional[Callable]:
    """``name``'s registered builder, or the function of a
    ``module:function`` path; None when ``name`` is no custom model (the
    factory goes on to its own families)."""
    if name in _BUILDERS:
        return _BUILDERS[name]
    if ":" in name:
        mod, _, attr = name.partition(":")
        return getattr(importlib.import_module(mod), attr)
    return None
