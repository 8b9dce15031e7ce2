"""CLIP: the visual tower, the text tower and the logit scale (counterpart
of ``peft_vit_tpu/models/clip.py``).

The architecture comes from the config (``clip_from_config``: MODEL.SPEC,
``TRAIN.IMAGE_SIZE``, ``TPU.COMPUTE_DTYPE``) and the weights from the JAX
layout through ``models.convert``; the module names mirror the JAX tree
(``visual``, ``text``, ``logit_scale``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..peft.spec import PEFTSpec
from .text import TextTransformer
from .vit import VisionTransformer


class CLIP(nn.Module):
    def __init__(self, embed_dim: int = 512, image_size: int = 224, patch_size: int = 32,
                 vision_width: int = 768, vision_layers: int = 12, vision_heads: int = 12,
                 vocab_size: int = 49408, context_length: int = 77, text_width: int = 512,
                 text_layers: int = 12, text_heads: int = 8, spec: PEFTSpec = PEFTSpec(),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.visual = VisionTransformer(
            image_size=image_size, patch_size=patch_size, width=vision_width,
            layers=vision_layers, heads=vision_heads, output_dim=embed_dim, spec=spec,
            dtype=dtype, device=device)
        self.text = TextTransformer(
            vocab_size=vocab_size, context_length=context_length, width=text_width,
            layers=text_layers, heads=text_heads, output_dim=embed_dim, dtype=dtype,
            device=device)
        # CLIP's init: ln(1 / 0.07)
        self.logit_scale = nn.Parameter(torch.full((), math.log(1.0 / 0.07), device=device))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)

    def forward(self, image: torch.Tensor, tokens: torch.Tensor,
                normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(logits_per_image, logits_per_text)``: ``exp(logit_scale)`` times
        the cosines (``normalize``) of the image and text features, in fp32
        (the JAX product of an fp32 scale with the compute-dtype features
        promotes to fp32)."""
        img = self.encode_image(image)
        txt = self.encode_text(tokens)
        if normalize:
            img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
            txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        scale = torch.exp(self.logit_scale.to(torch.float32))
        logits_per_image = scale * img.to(torch.float32) @ txt.to(torch.float32).t()
        return logits_per_image, logits_per_image.t()


def clip_from_config(cfg, spec: Optional[PEFTSpec] = None, device=None, **overrides) -> CLIP:
    """A ``CLIP`` of the reference-style MODEL.SPEC config group, its compute
    dtype from ``models.factory.compute_dtype`` on ``device`` (None: the
    card)."""
    from ..utils import resolve_device
    from .factory import compute_dtype

    device = resolve_device(device)
    s = cfg.MODEL.SPEC
    kw = dict(
        embed_dim=int(s.EMBED_DIM),
        image_size=int(cfg.TRAIN.IMAGE_SIZE[0]),
        patch_size=int(s.VISION.PATCH_SIZE),
        vision_width=int(s.VISION.WIDTH),
        vision_layers=int(s.VISION.LAYERS),
        vision_heads=int(s.VISION.HEADS),
        vocab_size=int(s.TEXT.VOCAB_SIZE),
        context_length=int(s.TEXT.CONTEXT_LENGTH),
        text_width=int(s.TEXT.WIDTH),
        text_layers=int(s.TEXT.LAYERS),
        text_heads=int(s.TEXT.HEADS),
        spec=spec or PEFTSpec(),
        dtype=compute_dtype(cfg, device),
        device=device,
    )
    kw.update(overrides)
    return CLIP(**kw)
