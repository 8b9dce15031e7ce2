"""Device-side RandAugment + RandomErasing, the ``AUG.TIMM_AUG`` suite
(counterpart of ``peft_vit_tpu/data/augment.py``).

The reference's full-shot trainer uses the timm loader's CPU-side
augmentation (``AUTO_AUGMENT`` rand-m9-mstd0.5-inc1, ``RE_PROB`` / ``RE_MODE``
random erasing).  As in the JAX package, every op here is tensor arithmetic
on the raw [0, 255] float batch inside the train step: the host ships uint8
and the card does the pixel math.

Each function is split into a draw and the arithmetic.  The draws (the flip,
each image's ``num_ops`` op indices, signed magnitudes ``clip(m + mstd N(0,
1), 0, 10)``, the erase's p, area, log-ratio and corner) come from an
explicit ``torch.Generator`` on the host (``TrainTransform.draw``, which
also computes the geometric ops' matrices from them there) and enter the
step as tensors; the erase's pixel noise is drawn inside the step from a
generator on the batch's device (``TrainTransform.noise``).  The arithmetic
is a plain function of tensors, so a test can feed it the JAX package's own
draws.

JAX picks an op per image with ``lax.switch`` under ``vmap``, which computes
every branch and selects.  So does ``apply_op``, with no host branch and no
data-dependent shape, so that it can be captured: the eleven pixel ops run on
the whole batch, each selected where an image drew it, and the five
geometric ops (rotate, shear x/y, translate x/y) share one bilinear
resample through a per-image inverse affine matrix (the identity where an
image drew another op).  ``equalize``'s histograms count in int64, so a
captured step equals its eager run bit for bit.  Divisions are by tensors
(a CUDA tensor divided by a Python number is multiplied by its reciprocal).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

_FILL = 128.0

OPS = ("identity", "autocontrast", "equalize", "invert", "rotate", "posterize", "solarize",
       "solarize_add", "color", "contrast", "brightness", "sharpness", "shear_x", "shear_y",
       "translate_x", "translate_y")
# the ops whose magnitude sign matters (rotation, shear, translate, enhance)
SIGNED = (0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1)
AFFINE = (4, 12, 13, 14, 15)


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as an fp32 0-dim tensor on ``like``'s device, made there."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _channels(values, like: torch.Tensor) -> torch.Tensor:
    """(C,) ``values`` x 255 made on ``like``'s device (a captured step may
    copy no host tensor to the card)."""
    return torch.stack([_c(float(v), like) for v in values]) * 255.0


def _per_image(m: torch.Tensor) -> torch.Tensor:
    return m.reshape(-1, 1, 1, 1)


def _blend(a, b, factor):
    return torch.clamp(b + (a - b) * factor, 0.0, 255.0)


def _enhance_factor(m):
    return 1.0 + m / _c(10.0, m) * 0.9


# -- pixel ops: x (B, H, W, 3) fp32 in [0, 255], m (B,) signed magnitudes ----


def identity(x, m):
    return x


def invert(x, m):
    return 255.0 - x


def autocontrast(x, m):
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    scale = _c(255.0, x) / torch.clamp(hi - lo, min=1e-6)
    return torch.where(hi > lo, torch.clamp((x - lo) * scale, 0.0, 255.0), x)


def equalize(x, m):
    """Per-image, per-channel histogram equalisation through a 256-bin CDF
    LUT, the histograms counted in int64 (exact, in any order)."""
    b, h, w, c = x.shape
    v = x.to(torch.int32).to(torch.int64)  # JAX's astype(int32): toward zero
    inb = (v >= 0) & (v < 256)
    # bin (image, channel, value); an out-of-range value counts nowhere, as
    # JAX's scatter drops it, and reads the clamped bin, as its gather does
    base = (torch.arange(b, device=x.device).view(b, 1, 1, 1) * c
            + torch.arange(c, device=x.device).view(1, 1, 1, c)) * 256
    slot = (base + v.clamp(0, 255)).reshape(-1)
    hist = torch.zeros(b * c * 256, dtype=torch.int64, device=x.device)
    hist.index_add_(0, slot, inb.reshape(-1).to(torch.int64))
    hist = hist.view(b, c, 256)
    cdf = torch.cumsum(hist, -1).to(torch.float32)
    n = cdf[..., -1:]
    first = torch.argmax((hist > 0).to(torch.int32), dim=-1, keepdim=True)
    cdf_min = torch.gather(cdf, -1, first)
    lut = torch.clamp((cdf - cdf_min) / torch.clamp(n - cdf_min, min=1.0) * 255.0, 0.0, 255.0)
    return torch.gather(lut.reshape(-1), 0, slot).view(b, h, w, c)


def posterize(x, m):
    # '-inc1': more magnitude keeps fewer bits (4 -> 0)
    bits = 4.0 - (_per_image(m) / _c(10.0, x) * 4.0)
    q = torch.exp2(torch.clamp(8.0 - bits, 0.0, 8.0))
    return torch.floor(x / q) * q


def solarize(x, m):
    thresh = 256.0 - _per_image(m) / _c(10.0, x) * 256.0
    return torch.where(x < thresh, x, 255.0 - x)


def solarize_add(x, m):
    add = _per_image(m) / _c(10.0, x) * 110.0
    return torch.where(x < 128.0, torch.clamp(x + add, 0.0, 255.0), x)


def color(x, m):
    grey = (x[..., 0:1] + x[..., 1:2] + x[..., 2:3]) / _c(3.0, x)
    return _blend(x, grey, _enhance_factor(_per_image(m)))


def contrast(x, m):
    mean = x.sum(dim=(1, 2, 3), keepdim=True) / _c(float(x[0].numel()), x)
    return _blend(x, mean, _enhance_factor(_per_image(m)))


def brightness(x, m):
    return _blend(x, torch.zeros_like(x), _enhance_factor(_per_image(m)))


def sharpness(x, m):
    """A 3x3 smoothing ([[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13, zero padding,
    as JAX's SAME convolution) summed in a fixed order, then the blend."""
    b, h, w, c = x.shape
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                     dtype=torch.float32) / 13.0
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    smoothed = None
    for i in range(3):
        for j in range(3):
            term = padded[:, i:i + h, j:j + w, :] * float(k[i, j])
            smoothed = term if smoothed is None else smoothed + term
    return _blend(x, smoothed, _enhance_factor(_per_image(m)))


_PIXEL = {1: autocontrast, 2: equalize, 3: invert, 5: posterize, 6: solarize,
          7: solarize_add, 8: color, 9: contrast, 10: brightness, 11: sharpness}


# -- geometric ops: inverse-affine bilinear resample, grey fill --------------


def affine(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C); ``mat`` (B, 2, 3) the INVERSE affine of each image
    (output -> input coordinates about the centre), bilinear, grey fill."""
    b, h, w, c = x.shape
    yy = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = yy - cy, xx - cx
    m = mat.view(b, 6, 1, 1)
    in_x = m[:, 0] * xs + m[:, 1] * ys + m[:, 2] + cx
    in_y = m[:, 3] * xs + m[:, 4] * ys + m[:, 5] + cy
    x0, y0 = torch.floor(in_x), torch.floor(in_y)
    fx, fy = (in_x - x0)[..., None], (in_y - y0)[..., None]
    flat = x.reshape(b, h * w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1).to(torch.int64) * w + xi.clamp(0, w - 1).to(torch.int64))
        vals = torch.gather(flat, 1, idx.view(b, h * w, 1).expand(b, h * w, c))
        return torch.where(valid[..., None], vals.view(b, h, w, c), _FILL)

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def affine_matrices(op: torch.Tensor, m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 2, 3): each image's inverse matrix for the geometric op it drew
    (rotate by m/10*30 degrees, shear by m/10*0.3, translate by m/10*0.45 of
    the side), the identity for any other op."""
    one, zero = torch.ones_like(m), torch.zeros_like(m)
    ten = _c(10.0, m)
    rad = m / ten * 30.0 * math.pi / _c(180.0, m)
    cos, sin = torch.cos(rad), torch.sin(rad)
    sh = m / ten * 0.3
    tx, ty = m / ten * 0.45 * w, m / ten * 0.45 * h
    rows = {4: (cos, -sin, zero, sin, cos, zero),
            12: (one, sh, zero, zero, one, zero),
            13: (one, zero, zero, sh, one, zero),
            14: (one, zero, tx, zero, one, zero),
            15: (one, zero, zero, zero, one, ty)}
    mat = torch.stack((one, zero, zero, zero, one, zero), -1)
    for k, entries in rows.items():
        mat = torch.where((op == k)[:, None], torch.stack(entries, -1), mat)
    return mat.view(-1, 2, 3)


def apply_op(x: torch.Tensor, op: torch.Tensor, m: torch.Tensor,
             mat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each image of ``x`` through the op it drew (``op`` (B,) int in
    [0, 16)) at its signed magnitude ``m`` (B,): every op on the batch, each
    selected where it was drawn.  ``mat``: ``affine_matrices`` of ``op``
    and ``m``, computed elsewhere (None: here)."""
    sel = op.view(-1, 1, 1, 1)
    out = x
    for k, fn in _PIXEL.items():
        out = torch.where(sel == k, fn(x, m), out)
    geometric = torch.zeros_like(sel, dtype=torch.bool)
    for k in AFFINE:
        geometric = geometric | (sel == k)
    if mat is None:
        mat = affine_matrices(op, m, x.shape[1], x.shape[2])
    return torch.where(geometric, affine(x, mat.to(x.device)), out)


def rand_augment(x: torch.Tensor, ops: torch.Tensor, mags: torch.Tensor,
                 mats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """rand-m-mstd over a (B, H, W, 3) [0, 255] batch: ``ops`` (B, num_ops)
    and ``mags`` (B, num_ops), the signed magnitudes, applied slot by slot;
    ``mats`` (B, num_ops, 2, 3) their geometric matrices (None: computed
    here, on ``x``'s device)."""
    x = x.to(torch.float32)
    for s in range(ops.shape[1]):
        x = apply_op(x, ops[:, s], mags[:, s], None if mats is None else mats[:, s])
    return x


def slot_matrices(ops: torch.Tensor, mags: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, num_ops, 2, 3): ``affine_matrices`` of each slot's draws."""
    return torch.stack([affine_matrices(ops[:, s], mags[:, s], h, w)
                        for s in range(ops.shape[1])], 1)


def draw_rand_augment(generator: torch.Generator, batch: int, num_ops: int, magnitude: float,
                      mag_std: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ops, signed magnitudes), each (batch, num_ops): ops uniform over the
    16, magnitudes ``clip(magnitude + mag_std N(0, 1), 0, 10)``, negated
    with probability 1/2 for the signed ops."""
    ops = torch.randint(0, len(OPS), (batch, num_ops), generator=generator)
    mag = torch.clamp(magnitude + mag_std * torch.randn((batch, num_ops), generator=generator),
                      0.0, 10.0)
    negate = (torch.rand((batch, num_ops), generator=generator) < 0.5) & torch.tensor(
        SIGNED, dtype=torch.bool)[ops]
    return ops, torch.where(negate, -mag, mag)


# -- random erasing -----------------------------------------------------------

AREA_RANGE = (0.02, 1.0 / 3.0)
LOG_RATIO = (math.log(0.3), math.log(1 / 0.3))


def random_erasing(x: torch.Tensor, p: torch.Tensor, area: torch.Tensor,
                   log_ratio: torch.Tensor, uy: torch.Tensor, ux: torch.Tensor,
                   prob: float = 0.25, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """timm RandomErasing on a (B, H, W, C) batch: where ``p`` (B,) < prob, a
    rectangle of ``area`` (B,, a fraction of the image) and aspect
    exp(``log_ratio``), its corner at (``uy``, ``ux``) of the free range, is
    filled with ``clip(128 + 50 noise, 0, 255)`` ('pixel' mode, ``noise`` of
    the batch's shape) or grey (``noise`` None, 'const' mode)."""
    x = x.to(torch.float32)
    b, h, w, c = x.shape
    area = float(h * w) * area
    ratio = torch.exp(log_ratio)
    eh = torch.clamp(torch.sqrt(area * ratio), 1.0, h - 1.0)
    ew = torch.clamp(torch.sqrt(area / ratio), 1.0, w - 1.0)
    y0, x0 = uy * (h - eh), ux * (w - ew)
    yy = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w)
    y0, x0, eh, ew = (t.view(b, 1, 1) for t in (y0, x0, eh, ew))
    inside = ((yy >= y0) & (yy < y0 + eh) & (xx >= x0) & (xx < x0 + ew))[..., None]
    fill = (torch.clamp(128.0 + 50.0 * noise, 0.0, 255.0) if noise is not None
            else torch.full_like(x, _FILL))
    erased = torch.where(inside, fill, x)
    return torch.where(_per_image(p) < prob, erased, x)


def draw_erasing(generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
    """The erase's host draws, each (batch,): p, the area fraction, the log
    aspect ratio and the corner's position in the free range."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator)

    return {"p": torch.rand(batch, generator=generator), "area": uniform(*AREA_RANGE),
            "log_ratio": uniform(*LOG_RATIO), "uy": torch.rand(batch, generator=generator),
            "ux": torch.rand(batch, generator=generator)}


# -- the train transform ------------------------------------------------------


@dataclass(frozen=True)
class TrainTransform:
    """hflip -> RandAugment -> random erasing -> normalise, per
    ``AUG.TIMM_AUG``: ``draw`` takes a step's host draws, ``noise`` the
    erase's pixel noise on the batch's device, ``__call__`` the arithmetic."""

    num_ops: int
    magnitude: float
    mag_std: float
    rand_augment: bool
    re_prob: float
    re_mode: str
    hflip: float
    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    def draw(self, generator: torch.Generator, shape) -> Dict[str, torch.Tensor]:
        """A step's host draws for a (B, H, W, C) batch; the geometric ops'
        matrices are computed here from them, on the host, so that every
        device resamples at the same coordinates (the card's cos and sin
        differ from the host's in the last bit, and a pixel's slope of up to
        255 turns that into 4e-3)."""
        batch, h, w = shape[0], shape[1], shape[2]
        out: Dict[str, torch.Tensor] = {}
        if self.hflip > 0:
            out["flip"] = torch.rand(batch, generator=generator) < self.hflip
        if self.rand_augment:
            out["ops"], out["mags"] = draw_rand_augment(generator, batch, self.num_ops,
                                                        self.magnitude, self.mag_std)
            out["mats"] = slot_matrices(out["ops"], out["mags"], h, w)
        if self.re_prob > 0:
            out.update({f"erase_{k}": v for k, v in draw_erasing(generator, batch).items()})
        return out

    @property
    def needs_noise(self) -> bool:
        return self.re_prob > 0 and self.re_mode == "pixel"

    def noise(self, shape, generator: torch.Generator) -> Optional[torch.Tensor]:
        """The erase's N(0, 1) pixel noise, drawn on ``generator``'s device."""
        if not self.needs_noise:
            return None
        return torch.randn(shape, generator=generator, device=generator.device)

    def __call__(self, x: torch.Tensor, draws: Dict[str, torch.Tensor],
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.hflip > 0:
            x = torch.where(_per_image(draws["flip"]), x.flip(2), x)
        if self.rand_augment:
            x = rand_augment(x, draws["ops"], draws["mags"], draws.get("mats"))
        if self.re_prob > 0:
            x = random_erasing(x, draws["erase_p"], draws["erase_area"],
                               draws["erase_log_ratio"], draws["erase_uy"], draws["erase_ux"],
                               self.re_prob, noise if self.re_mode == "pixel" else None)
        return (x - _channels(self.mean, x)) / _channels(self.std, x)


def parse_auto_augment(aa: str) -> Tuple[int, float, float]:
    """(num_ops, magnitude, mag_std) of a timm string such as
    ``rand-m9-mstd0.5-inc1`` (defaults 2, 9, 0.5)."""
    num_ops, mag, mstd = 2, 9.0, 0.5
    for part in aa.split("-"):
        if part.startswith("m") and part[1:].replace(".", "").isdigit():
            mag = float(part[1:])
        elif part.startswith("mstd"):
            mstd = float(part[4:])
        elif part.startswith("n") and part[1:].isdigit():
            num_ops = int(part[1:])
    return num_ops, mag, mstd


def make_train_transform(cfg) -> Optional[TrainTransform]:
    """The ``AUG.TIMM_AUG`` transform of ``cfg``; None when it is off."""
    t = cfg.AUG.TIMM_AUG
    if not (bool(t.get("USE_TRANSFORM", False)) or bool(t.get("USE_LOADER", False))):
        return None
    aa = str(t.get("AUTO_AUGMENT", "rand-m9-mstd0.5-inc1") or "")
    num_ops, mag, mstd = parse_auto_augment(aa)
    return TrainTransform(num_ops=num_ops, magnitude=mag, mag_std=mstd, rand_augment=bool(aa),
                          re_prob=float(t.get("RE_PROB", 0.0)),
                          re_mode=str(t.get("RE_MODE", "pixel")),
                          hflip=float(t.get("HFLIP", 0.5)),
                          mean=tuple(float(v) for v in cfg.INPUT.MEAN),
                          std=tuple(float(v) for v in cfg.INPUT.STD))
