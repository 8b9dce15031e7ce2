"""Image preprocessing (counterpart of ``peft_vit_tpu/data/transforms.py``):
the host half the few-shot splits need, and ``normalize_batch``,
``random_flip`` and ``random_crop_resize`` on tensors, each random one split
into a draw (an explicit ``torch.Generator``) and the arithmetic.  What
follows is the JAX module's own account.

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

import math
from typing import Dict, Sequence, Tuple

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


def draw_flip(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch,) bool: flip each image with probability 1/2."""
    return torch.rand(batch, generator=generator) < 0.5


def random_flip(batch: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """NHWC images flipped along W where ``flip`` (B,) says."""
    return torch.where(flip.to(batch.device).view(-1, 1, 1, 1), batch.flip(2), batch)


def draw_crop_resize(generator: torch.Generator, batch: int,
                     scale: Tuple[float, float] = (0.08, 1.0),
                     ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)) -> Dict[str, torch.Tensor]:
    """The draws of ``random_crop_resize``, each (batch,): the area fraction,
    the log aspect ratio and the box's position in its free range."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator)

    return {"area": uniform(*scale), "log_ratio": uniform(math.log(ratio[0]), math.log(ratio[1])),
            "uy": torch.rand(batch, generator=generator),
            "ux": torch.rand(batch, generator=generator)}


def random_crop_resize(batch: torch.Tensor, area: torch.Tensor, log_ratio: torch.Tensor,
                       uy: torch.Tensor, ux: torch.Tensor) -> torch.Tensor:
    """RandomResizedCrop on the tensors' device: each image's box (``area``
    of the image, aspect exp(``log_ratio``), at (``uy``, ``ux``) of its free
    range) resized bilinearly back to the input size.  Static shapes: the
    crop is a scale and translate of the resize, not a slice."""
    b, h, w, _ = batch.shape
    r = torch.exp(log_ratio)
    ch = torch.clamp(torch.sqrt(area / r), max=1.0)
    cw = torch.clamp(torch.sqrt(area * r), max=1.0)
    ty, tx = uy * (1.0 - ch), ux * (1.0 - cw)

    def grid(n, start, frac):
        at = torch.arange(n, dtype=torch.float32, device=batch.device) + 0.5
        n_t = torch.full((), float(n), dtype=torch.float32, device=batch.device)
        return (start[:, None] + frac[:, None] * at / n_t) * n - 0.5

    return torch.stack([_bilinear_gather(batch[i], ys, xs)
                        for i, (ys, xs) in enumerate(zip(grid(h, ty, ch), grid(w, tx, cw)))])


def _bilinear_gather(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    h, w, _ = img.shape
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[None, :, None]
    a, b_ = img[y0][:, x0], img[y0][:, x1]
    c_, d = img[y1][:, x0], img[y1][:, x1]
    top = a * (1 - wx) + b_ * wx
    bot = c_ * (1 - wx) + d * wx
    return top * (1 - wy) + bot * wy
