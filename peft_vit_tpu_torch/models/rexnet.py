"""ReXNet (counterpart of ``peft_vit_tpu/models/rexnet.py``; the reference's
lib/models/cls_rexnet.py).

Linear bottlenecks: 1x1 expand (SiLU) -> 3x3 depthwise -> BN (+ ReXNet's
own SE in later blocks) -> ReLU6 -> 1x1 linear projection, and ReXNet's
partial residual: at stride 1 the input adds onto the FIRST ``in_ch``
channels of the projection (channels grow block to block).

ReLU6 is ``relu6``: ``minimum(maximum(x, 0), 6)``, whose gradient at
exactly 0 or 6 is split 0.5 / 0.5 between the two sides, as the JAX
module's ``jnp.clip`` splits it (``torch.clamp`` would pass all of it).
Module names follow the JAX module's; NCHW inside, NHWC images at the
entry; every convolution ``resnet._Conv2d``, the pools ``mean``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm2d, Conv2d


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 6)`` with its gradient: ``torch.maximum`` and
    ``torch.minimum`` split a tie's gradient in halves, as ``jnp.maximum``
    and ``jnp.minimum`` do.  The bounds are made on the device (no host
    copy inside a captured step)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))


class ReXNetSE(nn.Module):
    """ReXNet's SE (cls_rexnet.py:72-87): the spatial mean -> ``fc1`` (1x1
    conv with a bias) -> BatchNorm ``bn`` -> ReLU -> ``fc2`` -> sigmoid gate;
    hidden = max(channels // se_ratio, 1)."""

    def __init__(self, channels: int, se_ratio: int = 12, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        hidden = max(channels // se_ratio, 1)
        self.fc1 = Conv2d(channels, hidden, 1, dtype=dtype, device=device, bias=True)
        self.bn = BatchNorm2d(hidden, device)
        self.fc2 = Conv2d(hidden, channels, 1, dtype=dtype, device=device, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.bn(self.fc1(s))))
        return x * torch.sigmoid(s)


class LinearBottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, expand_ratio: float = 6.0,
                 use_se: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.in_ch, self.stride = in_ch, stride
        mid = in_ch
        if expand_ratio != 1.0:
            mid = int(round(in_ch * expand_ratio))
            self.expand = Conv2d(in_ch, mid, 1, dtype=dtype, device=device)
            self.bn_expand = BatchNorm2d(mid, device)
        self.dw = Conv2d(mid, mid, 3, stride, mid, dtype=dtype, device=device)
        self.bn_dw = BatchNorm2d(mid, device)
        if use_se:
            self.se = ReXNetSE(mid, dtype=dtype, device=device)
        self.project = Conv2d(mid, out_ch, 1, dtype=dtype, device=device)
        self.bn_project = BatchNorm2d(out_ch, device)
        self.residual = stride == 1 and in_ch <= out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if hasattr(self, "expand"):
            h = F.silu(self.bn_expand(self.expand(h)))
        h = self.bn_dw(self.dw(h))
        if hasattr(self, "se"):
            h = self.se(h)
        h = self.bn_project(self.project(relu6(h)))
        if self.residual:
            # the partial residual: the input onto the first in_ch channels
            c = self.in_ch
            h = torch.cat([h[:, :c] + x[:, :c], h[:, c:]], dim=1)
        return h


def _rexnet_channels(width_mult: float = 1.0, depth_mult: float = 1.0, input_ch: int = 16,
                     final_ch: int = 180) -> List[Tuple[int, int, int, float, bool]]:
    """(in, out, stride, expand, use_se) per block: the reference's schedule
    (cls_rexnet.py ReXNetV1.__init__:131-170), as the JAX function gives it."""
    layers = [math.ceil(e * depth_mult) for e in [1, 2, 2, 3, 3, 5]]
    strides_flat = sum([[s] + [1] * (n - 1) for s, n in zip([1, 2, 2, 2, 1, 2], layers)], [])
    se_flat = sum([[se] * n for se, n in zip([False, False, True, True, True, True], layers)],
                  [])
    depth = sum(layers)
    ts = [1.0] * layers[0] + [6.0] * (depth - layers[0])
    stem_raw = 32 / width_mult if width_mult < 1.0 else 32
    inplanes = input_ch / width_mult if width_mult < 1.0 else input_ch
    cfg = []
    for i in range(depth):
        if i == 0:
            cin = int(round(stem_raw * width_mult))
            cout = int(round(inplanes * width_mult))
        else:
            cin = int(round(inplanes * width_mult))
            inplanes += final_ch / depth
            cout = int(round(inplanes * width_mult))
        cfg.append((cin, cout, strides_flat[i], ts[i], se_flat[i]))
    return cfg


def rexnet_stem_channels(width_mult: float) -> int:
    stem_raw = 32 / width_mult if width_mult < 1.0 else 32
    return int(round(stem_raw * width_mult))


class ReXNet(nn.Module):
    """(B, H, W, 3) images -> (B, num_features) pooled features; the JAX
    module's fields."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        stem = rexnet_stem_channels(width_mult)
        self.stem = Conv2d(3, stem, 3, 2, dtype=dtype, device=device)
        self.stem_bn = BatchNorm2d(stem, device)
        cfg = _rexnet_channels(width_mult, depth_mult)
        for i, (cin, cout, s, t, se) in enumerate(cfg):
            setattr(self, f"block{i}", LinearBottleneck(cin, cout, s, t, se, dtype, device))
        self.depth = len(cfg)
        head = int(1280 * width_mult)  # the reference floors (:172)
        self.head_conv = Conv2d(cfg[-1][1], head, 1, dtype=dtype, device=device)
        self.head_bn = BatchNorm2d(head, device)
        self.num_features = head

    def forward(self, x: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
        if start_layer:
            raise ValueError("ReXNet has no cached-prefix cut (start_layer)")
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.silu(self.stem_bn(self.stem(x)))
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = F.silu(self.head_bn(self.head_conv(x)))
        return x.mean(dim=(2, 3))
