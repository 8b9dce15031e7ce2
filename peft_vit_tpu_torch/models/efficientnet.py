"""EfficientNet (counterpart of ``peft_vit_tpu/models/efficientnet.py``).

timm's plain (non-``tf_``) EfficientNet, B0 by default, as the reference
evaluates ``efficientnet_b0`` (a probe backbone returning pooled features,
evaluation/feature.py:227-231):

* stem 3x3 s2 -> 7 MBConv stages -> 1x1 head conv -> the spatial mean;
* stage 0 is the depthwise-separable block (``DsConv``: no expansion, a
  pointwise projection ``conv_pw``); later stages are inverted residuals
  (``MBConv``: ``conv_pw`` expand -> ``conv_dw`` -> SE -> ``conv_pwl``);
* squeeze-excitation reduces to ``int(block_input * 0.25)`` channels (timm:
  a ratio of the block's input, not of the expanded width);
* SiLU, BatchNorm eps 1e-3 (``resnet.batch_norm``, flax's momentum 0.9),
  symmetric k // 2 padding.

Module names follow the JAX module's (``conv_stem``, ``bn1``,
``blocks_<s>_<i>``, ``conv_head``, ``bn2``), so ``convert.params_from_jax``
and ``timm_effnet_state_dict_to_tree`` carry weights across.  Images arrive
NHWC and are made NCHW once; every convolution, the depthwise ones included,
is ``resnet._Conv2d``; the SE gate and the head pool with ``mean``, as the
JAX module does.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm2d, Conv2d

# (expand, channels, repeats, kernel, stride): the B0 table
B0_BLOCKS: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 3, 1),
    (6, 24, 2, 3, 2),
    (6, 40, 2, 5, 2),
    (6, 80, 3, 3, 2),
    (6, 112, 3, 5, 1),
    (6, 192, 4, 5, 2),
    (6, 320, 1, 3, 1),
)
BN_EPS = 1e-3


def round_channels(ch: float, mult: float, divisor: int = 8) -> int:
    """timm's round_channels: scale, then round to the divisor, never
    dropping more than 10 %."""
    ch *= mult
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return int(new)


class SqueezeExcite(nn.Module):
    """The spatial mean -> ``conv_reduce`` -> SiLU -> ``conv_expand`` ->
    sigmoid gate (1x1 convolutions with a bias)."""

    def __init__(self, channels: int, reduced: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.conv_reduce = Conv2d(channels, reduced, 1, dtype=dtype, device=device, bias=True)
        self.conv_expand = Conv2d(reduced, channels, 1, dtype=dtype, device=device, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class DsConv(nn.Module):
    """The stage-0 depthwise-separable block (timm DepthwiseSeparableConv):
    conv_dw -> bn1 -> SiLU -> SE -> conv_pw -> bn2, the residual when the
    shape is kept."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 se_reduced: int = 8, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv_dw = Conv2d(in_ch, in_ch, kernel, stride, in_ch, dtype=dtype, device=device)
        self.bn1 = BatchNorm2d(in_ch, device, BN_EPS)
        self.se = SqueezeExcite(in_ch, se_reduced, dtype, device)
        self.conv_pw = Conv2d(in_ch, out_ch, 1, dtype=dtype, device=device)
        self.bn2 = BatchNorm2d(out_ch, device, BN_EPS)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.se(F.silu(self.bn1(self.conv_dw(x))))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class MBConv(nn.Module):
    """The inverted residual (timm InvertedResidual): conv_pw expand -> bn1
    -> SiLU -> conv_dw -> bn2 -> SiLU -> SE -> conv_pwl -> bn3."""

    def __init__(self, in_ch: int, out_ch: int, expand: int = 6, kernel: int = 3,
                 stride: int = 1, se_reduced: int = 8, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        mid = in_ch * expand
        self.conv_pw = Conv2d(in_ch, mid, 1, dtype=dtype, device=device)
        self.bn1 = BatchNorm2d(mid, device, BN_EPS)
        self.conv_dw = Conv2d(mid, mid, kernel, stride, mid, dtype=dtype, device=device)
        self.bn2 = BatchNorm2d(mid, device, BN_EPS)
        self.se = SqueezeExcite(mid, se_reduced, dtype, device)
        self.conv_pwl = Conv2d(mid, out_ch, 1, dtype=dtype, device=device)
        self.bn3 = BatchNorm2d(out_ch, device, BN_EPS)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = self.se(F.silu(self.bn2(self.conv_dw(h))))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


class EfficientNet(nn.Module):
    """(B, H, W, 3) images -> the (B, num_features) pooled feature (the
    reference's EvalModel); the JAX module's fields, same names and
    defaults."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 blocks: Sequence[Tuple[int, int, int, int, int]] = B0_BLOCKS,
                 stem_ch: int = 32, head_ch: int = 1280, se_ratio: float = 0.25,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        cin = round_channels(stem_ch, width_mult)
        self.conv_stem = Conv2d(3, cin, 3, 2, dtype=dtype, device=device)
        self.bn1 = BatchNorm2d(cin, device, BN_EPS)
        self._blocks = []
        for s, (t, c, n, k, stride) in enumerate(blocks):
            out_ch = round_channels(c, width_mult)
            for i in range(int(math.ceil(n * depth_mult))):
                st = stride if i == 0 else 1
                se_red = max(1, int(cin * se_ratio))
                if t == 1:
                    block = DsConv(cin, out_ch, k, st, se_red, dtype, device)
                else:
                    block = MBConv(cin, out_ch, t, k, st, se_red, dtype, device)
                name = f"blocks_{s}_{i}"
                setattr(self, name, block)
                self._blocks.append(name)
                cin = out_ch
        # timm: the head is not width-scaled at mult <= 1.0 (B0)
        head = head_ch if width_mult <= 1.0 else round_channels(head_ch, width_mult)
        self.conv_head = Conv2d(cin, head, 1, dtype=dtype, device=device)
        self.bn2 = BatchNorm2d(head, device, BN_EPS)
        self.num_features = head

    def forward(self, x: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
        if start_layer:
            raise ValueError("EfficientNet has no cached-prefix cut (start_layer)")
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.silu(self.bn1(self.conv_stem(x)))
        for name in self._blocks:
            x = getattr(self, name)(x)
        x = F.silu(self.bn2(self.conv_head(x)))
        return x.mean(dim=(2, 3))
