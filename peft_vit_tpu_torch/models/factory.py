"""Model builders (counterpart of ``peft_vit_tpu/models/factory.py``)."""

from __future__ import annotations

import torch

from ..peft.spec import PEFTSpec
from ..utils import resolve_device
from .classifier import ImageClassifier
from .vit import VisionTransformer


def flagship(
    width: int = 768,
    layers: int = 12,
    heads: int = 12,
    image: int = 224,
    patch: int = 16,
    num_classes: int = 100,
    dtype: torch.dtype = torch.bfloat16,
    use_bn: bool = False,
    ln_fp32: bool = True,
    device=None,
) -> ImageClassifier:
    """The flagship classifier: CLIP-style ViT (ViT-B/16 at the defaults,
    output_dim 512) with LoRA rank 4, alpha 128 on q and v with the
    post-scale-q quirk, and a linear head (``use_bn``: channel BN first).
    The same model as the JAX package's ``__graft_entry__._flagship``:
    ``dtype`` is the compute dtype, every weight is stored in fp32, and
    ``ln_fp32=False`` normalizes in the compute dtype.  ``device=None``
    builds on the card."""
    device = resolve_device(device)
    spec = PEFTSpec(
        method="lora",
        attn_delta="lora",
        lora_rank=4,
        lora_alpha=128.0,
        lora_post_scale_q=True,
    )
    vit = VisionTransformer(
        image_size=image,
        patch_size=patch,
        width=width,
        layers=layers,
        heads=heads,
        output_dim=512,
        spec=spec,
        ln_fp32=ln_fp32,
        dtype=dtype,
        device=device,
    )
    return ImageClassifier(
        vit, num_classes=num_classes, use_bn=use_bn, dtype=dtype, device=device
    )
