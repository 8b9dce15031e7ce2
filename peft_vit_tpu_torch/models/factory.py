"""Model builders (counterpart of ``peft_vit_tpu/models/factory.py``)."""

from __future__ import annotations

import torch

from typing import Sequence

from ..ops.int8 import INT8_TARGET_MODULES
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
    int8: bool = False,
    int8_train: bool = False,
    int8_targets: Sequence[str] = INT8_TARGET_MODULES,
    patch_gemm: bool = False,
    device=None,
) -> ImageClassifier:
    """The flagship classifier: CLIP-style ViT (ViT-B/16 at the defaults,
    output_dim 512) with LoRA rank 4, alpha 128 on q and v with the
    post-scale-q quirk, and a linear head (``use_bn``: channel BN first).
    The same model as the JAX package's ``__graft_entry__._flagship``:
    ``dtype`` is the compute dtype, every weight is stored in fp32, and
    ``ln_fp32=False`` normalizes in the compute dtype.  ``int8`` runs the
    frozen tower's GEMMs (``int8_targets``) int8 on eval forwards,
    ``int8_train`` on training forwards too; ``patch_gemm`` computes the patch
    embedding as one matrix product.  ``device=None`` builds on the card."""
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
        int8=int8,
        int8_train=int8_train,
        int8_targets=int8_targets,
        patch_gemm=patch_gemm,
        dtype=dtype,
        device=device,
    )
    return ImageClassifier(
        vit, num_classes=num_classes, use_bn=use_bn, dtype=dtype, device=device
    )
