"""Image preprocessing (counterpart of ``peft_vit_tpu/data/transforms.py``):
the host half the few-shot splits need, and ``normalize_batch`` on tensors.
The device-side augmentations (random crop and flip) wait with
``data/augment.py``.  What follows is the JAX module's own account.

Reference eval transform (feature.py:516-530): Resize(size, BICUBIC) ->
CenterCrop(size) -> ToTensor -> Normalize(mean, std).  Train-time augments
(full-shot AUG group): RandomResizedCrop + flip (+ color jitter in timm
mode).

Two tiers:

* host (numpy/PIL) — decode + resize on the CPU feeder threads;
* device (jax) — `normalize_batch` and random crop/flip run on-TPU inside
  the step (HBM-friendly: uint8 in, bf16 out; 4x less host->device
  traffic than shipping fp32).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# -- host side ---------------------------------------------------------------


def resize_center_crop(img, size: int):
    """PIL path: Resize(shorter=size, bicubic) -> CenterCrop(size)."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    w, h = img.size
    short = min(w, h)
    nw, nh = round(w * size / short), round(h * size / short)
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img.convert("RGB"), np.uint8)


def to_normalized_array(
    img_u8: np.ndarray,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> np.ndarray:
    x = img_u8.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


# -- device side -------------------------------------------------------------


def normalize_batch(
    batch_u8: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 NHWC -> normalized ``dtype`` on the tensor's device."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=batch_u8.device) * 255.0
    inv_std = 1.0 / (torch.tensor(std, dtype=torch.float32, device=batch_u8.device) * 255.0)
    return ((batch_u8.to(torch.float32) - mean_t) * inv_std).to(dtype)
