"""Mixup and CutMix (counterpart of ``peft_vit_tpu/engine/mixup.py``).

Reference: full_shot/main/lib/core/mixup.py:5-16 (the beta-sampled convex
mix), lib/core/mixcut.py (the box cut) and timm's ``Mixup`` (the switch
between them; lib/core/function.py:46-80).  The outputs are the mixed NHWC
images and soft target distributions for ``soft_target_cross_entropy``.

Each function is split into a draw and the arithmetic.  A draw takes an
explicit ``torch.Generator`` and returns plain numbers: lam, the switch and
the box centre.  The arithmetic takes those numbers as tensors or Python
values, so that a captured step reads them as inputs of its replay, and a
test can feed it the JAX package's own draws.  As in the JAX function, mixup
and cutmix share one key in ``mixup_cutmix``: the port draws both lams
either way, and both mixes run, the switch choosing one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .loss import one_hot

Number = Union[float, int, torch.Tensor]


def _numpy_rng(generator: torch.Generator) -> np.random.Generator:
    """A numpy generator seeded from ``generator``: Beta draws (which
    PyTorch's samplers take no generator for) that still follow the
    explicit stream."""
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    return np.random.default_rng(seed)


def draw_beta(generator: torch.Generator, alpha: float) -> float:
    """lam ~ Beta(alpha, alpha)."""
    return float(np.float32(_numpy_rng(generator).beta(alpha, alpha)))


def draw_cutmix(generator: torch.Generator, alpha: float, h: int, w: int) -> Tuple[float, int, int]:
    """(lam, cy, cx): lam ~ Beta(alpha, alpha) and the box centre, uniform
    over the rows and columns."""
    lam = draw_beta(generator, alpha)
    cy, cx = (int(v) for v in torch.randint(0, h, (1,), generator=generator).tolist()
              + torch.randint(0, w, (1,), generator=generator).tolist())
    return lam, cy, cx


def draw_mixup_cutmix(generator: torch.Generator, mixup_alpha: float, cutmix_alpha: float,
                      switch_prob: float, h: int, w: int) -> Dict[str, Number]:
    """One step's draws of ``mixup_cutmix``: ``use_cutmix`` (True with
    ``switch_prob``), mixup's ``lam_mix``, cutmix's ``lam_cut`` and box
    centre ``cy``, ``cx``."""
    use = bool(torch.rand((), generator=generator) < switch_prob)
    lam_mix = draw_beta(generator, mixup_alpha)
    lam_cut, cy, cx = draw_cutmix(generator, cutmix_alpha, h, w)
    return {"use_cutmix": use, "lam_mix": lam_mix, "lam_cut": lam_cut, "cy": cy, "cx": cx}


def one_hot_smooth(target: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    oh = one_hot(target, num_classes)
    if smoothing > 0:
        oh = oh * (1.0 - smoothing) + smoothing / num_classes
    return oh


def _scalar(v: Number, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``v`` as a 0-dim tensor on ``like``'s device, made there (a captured
    step may not copy a host number to the card)."""
    if torch.is_tensor(v):
        return v.to(device=like.device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=like.device)


def _roll(t: torch.Tensor) -> torch.Tensor:
    return torch.roll(t, 1, 0)


def mixup(images: torch.Tensor, target: torch.Tensor, num_classes: int, lam: Number,
          smoothing: float = 0.0, roll: Callable = _roll) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch mixup: x = lam x + (1 - lam) roll(x, 1), the targets alike
    (``roll``: of the global batch, where a rank holds some of its rows)."""
    lam = _scalar(lam, images)
    mixed = lam * images + (1.0 - lam) * roll(images)
    y1 = one_hot_smooth(target, num_classes, smoothing)
    y2 = roll(y1)
    return mixed.to(images.dtype), lam * y1 + (1.0 - lam) * y2


def cutmix(images: torch.Tensor, target: torch.Tensor, num_classes: int, lam: Number,
           cy: Number, cx: Number, smoothing: float = 0.0,
           roll: Callable = _roll) -> Tuple[torch.Tensor, torch.Tensor]:
    """CutMix: the box of side sqrt(1 - lam) times the image's (truncated),
    centred at (cy, cx) and clipped to the image, pasted from the rolled
    batch; the targets mix by the box's true area."""
    b, h, w, c = images.shape
    lam = _scalar(lam, images)
    cy, cx = _scalar(cy, images, torch.int32), _scalar(cx, images, torch.int32)
    cut_ratio = torch.sqrt(1.0 - lam)
    cut_h = (h * cut_ratio).to(torch.int32)
    cut_w = (w * cut_ratio).to(torch.int32)
    y1 = torch.clamp(cy - torch.div(cut_h, 2, rounding_mode="floor"), 0, h)
    y2 = torch.clamp(cy + torch.div(cut_h, 2, rounding_mode="floor"), 0, h)
    x1 = torch.clamp(cx - torch.div(cut_w, 2, rounding_mode="floor"), 0, w)
    x2 = torch.clamp(cx + torch.div(cut_w, 2, rounding_mode="floor"), 0, w)
    rows = torch.arange(h, device=images.device)[None, :, None, None]
    cols = torch.arange(w, device=images.device)[None, None, :, None]
    box = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    mixed = torch.where(box, roll(images), images)
    area = ((y2 - y1) * (x2 - x1)).to(torch.float32)
    lam_adj = 1.0 - area / _scalar(h * w, images)
    t1 = one_hot_smooth(target, num_classes, smoothing)
    t2 = roll(t1)
    return mixed.to(images.dtype), lam_adj * t1 + (1.0 - lam_adj) * t2


def mixup_cutmix(images: torch.Tensor, target: torch.Tensor, num_classes: int,
                 draws: Dict[str, Number], smoothing: float = 0.0, roll: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """timm's switch: cutmix where ``draws['use_cutmix']``, else mixup, on the
    draws of ``draw_mixup_cutmix`` (Python values or 0-dim tensors);
    ``roll`` as in ``mixup``."""
    roll = roll or _roll
    mi, mt = mixup(images, target, num_classes, draws["lam_mix"], smoothing, roll)
    ci, ct = cutmix(images, target, num_classes, draws["lam_cut"], draws["cy"], draws["cx"],
                    smoothing, roll)
    use = _scalar(draws["use_cutmix"], images, torch.bool)
    return torch.where(use, ci, mi), torch.where(use, ct, mt)
