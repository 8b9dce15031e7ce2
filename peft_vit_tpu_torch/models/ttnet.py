"""TTNet v2 / v3 (counterpart of ``peft_vit_tpu/models/ttnet.py``): the
ShuffleNet-v2-style mobile backbones of the reference's
lib/models/cls_ttnet_v2.py (the hardcoded MobileShuffleV2Net) and
cls_ttnet_v3.py (the config-driven TTNetV3).

Every block is the ShuffleNet-v2 InvertedResidual with 1x1-BN-ReLU / k x k
depthwise-BN-ReLU / 1x1-BN branches (v2: k = 5; v3: k per stage); block
types 1 (bottom: a branch on the whole input, concatenated with it), 2
(downsample: each half its own branch) and 3 (normal: the first half's
branch, the second half passed); each block's output channel-shuffled with
groups 2 in sub-groups of ``mini_size`` 4.

NCHW inside (NHWC images at the entry): ``channel_shuffle`` is the
reference's own NCHW view (cls_ttnet_v2.py:25-40), the same permutation of
the channel index as the JAX module's NHWC reshape.  Module names follow the
JAX module's; every convolution ``resnet._Conv2d``, the pool ``mean``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense
from .resnet import BatchNorm2d, Conv2d


def channel_shuffle(x: torch.Tensor, groups: int, mini_size: int = 4) -> torch.Tensor:
    """Channel c = g * cpg + m * mini + s moves to m * groups * mini + g *
    mini + s (NCHW)."""
    b, c, h, w = x.shape
    mn = c // groups // mini_size
    return x.reshape(b, groups, mn, mini_size, h, w).transpose(1, 2).reshape(b, c, h, w)


def channel_unshuffle(x: torch.Tensor, groups: int, mini_size: int = 4) -> torch.Tensor:
    """The inverse permutation (cls_ttnet_v2.py:43-58)."""
    b, c, h, w = x.shape
    mn = c // groups // mini_size
    return x.reshape(b, mn, groups, mini_size, h, w).transpose(1, 2).reshape(b, c, h, w)


class _Branch(nn.Module):
    """pw 1x1 -> BN -> ReLU -> dw k x k (stride) -> BN -> ReLU -> pw 1x1 ->
    BN: one InvertedResidual branch."""

    def __init__(self, cin: int, neck: int, out: int, stride: int, kernel: int = 5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv1 = Conv2d(cin, neck, 1, dtype=dtype, device=device)
        self.bn1 = BatchNorm2d(neck, device)
        self.conv2 = Conv2d(neck, neck, kernel, stride, neck, dtype=dtype, device=device)
        self.bn2 = BatchNorm2d(neck, device)
        self.conv3 = Conv2d(neck, out, 1, dtype=dtype, device=device)
        self.bn3 = BatchNorm2d(out, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return self.bn3(self.conv3(x))


class TTNetBlock(nn.Module):
    """The InvertedResidual (cls_ttnet_v2.py:62-167 / cls_ttnet_v3.py:84-230)."""

    def __init__(self, channel_in: int, channel_out: int, channel_neck: int, stride: int = 1,
                 block_type: int = 3, mini_size: int = 4, kernel: int = 5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        cin, cout, neck = channel_in, channel_out, channel_neck
        self.block_type, self.mini_size, self.half = block_type, mini_size, cin // 2
        if block_type == 1:
            assert stride == 1
            self.branch1 = _Branch(cin, neck, cout - cin, stride, kernel, dtype, device)
        elif block_type == 2:
            self.branch1 = _Branch(self.half, neck, cout - cin, stride, kernel, dtype, device)
            self.branch2 = _Branch(cin - self.half, neck, cin, stride, kernel, dtype, device)
        elif block_type == 3:
            assert stride == 1
            self.branch1 = _Branch(self.half, neck, cout - self.half, stride, kernel, dtype,
                                   device)
        else:
            raise ValueError(f"unsupported block type {block_type}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.block_type == 1:
            out = torch.cat([self.branch1(x), x], dim=1)
        else:
            x1, x2 = x[:, :self.half], x[:, self.half:]
            other = self.branch2(x2) if self.block_type == 2 else x2
            out = torch.cat([self.branch1(x1), other], dim=1)
        return channel_shuffle(out, 2, self.mini_size)


def _conv_bn_relu(owner: nn.Module, name: str, cin: int, cout: int, kernel: int, stride: int,
                  dtype, device) -> None:
    """The JAX ``_conv_bn_relu``'s modules, ``<name>_conv`` and ``<name>_bn``,
    on ``owner`` (``_run_conv_bn_relu`` runs them)."""
    setattr(owner, f"{name}_conv", Conv2d(cin, cout, kernel, stride, dtype=dtype, device=device))
    setattr(owner, f"{name}_bn", BatchNorm2d(cout, device))


def _run_conv_bn_relu(owner: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.relu(getattr(owner, f"{name}_bn")(getattr(owner, f"{name}_conv")(x)))


class _Stage(nn.Module):
    """A stride-2 type-2 block, then type-3 repeats."""

    def __init__(self, channel_in: int, channel_out: int, repeats: int, kernel: int = 5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.repeats = repeats
        self.block_0 = TTNetBlock(channel_in, channel_out, channel_in, 2, 2, kernel=kernel,
                                  dtype=dtype, device=device)
        for i in range(1, repeats):
            setattr(self, f"block_{i}", TTNetBlock(channel_out, channel_out, channel_out, 1, 3,
                                                   kernel=kernel, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.repeats):
            x = getattr(self, f"block_{i}")(x)
        return x


class _TTNet(nn.Module):
    """The stem, the stages, the optional final 1x1 conv, the pool and (unless
    ``features_only``) the ``fc`` head."""

    stem_name = "conv1"
    block_name = "block1"

    def __init__(self, stem: int, start: int, neck: int, stem_kernel: int,
                 stages: Sequence[tuple], final: int, num_classes: int, features_only: bool,
                 dtype: torch.dtype, device):
        super().__init__()
        self.dtype, self.features_only, self.n_stages = dtype, features_only, len(stages)
        _conv_bn_relu(self, self.stem_name, 3, stem, 3, 2, dtype, device)
        setattr(self, self.block_name, TTNetBlock(stem, start, neck, 1, 1, kernel=stem_kernel,
                                                  dtype=dtype, device=device))
        cin = start
        for i, (cout, reps, k) in enumerate(stages, start=1):
            setattr(self, f"stage_{i}", _Stage(cin, cout, reps, int(k), dtype, device))
            cin = cout
        self.final = final
        if final:
            _conv_bn_relu(self, "final", cin, final, 1, 1, dtype, device)
            cin = final
        self.num_features = cin
        if not features_only:
            self.fc = Dense(cin, num_classes, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
        if start_layer:
            raise ValueError("TTNet has no cached-prefix cut (start_layer)")
        x = _run_conv_bn_relu(self, self.stem_name, x.permute(0, 3, 1, 2).to(self.dtype))
        x = getattr(self, self.block_name)(x)
        for i in range(1, self.n_stages + 1):
            x = getattr(self, f"stage_{i}")(x)
        if self.final:
            x = _run_conv_bn_relu(self, "final", x)
        x = x.mean(dim=(2, 3))
        return x if self.features_only else self.fc(x)


class TTNetV2(_TTNet):
    """cls_ttnet_v2.py MobileShuffleV2Net: conv1 3->8 s2; a bottom block
    8->16 (neck 16); stages (32, 64, 128, 1024) x (3, 5, 10, 5) repeats at
    k = 5; the pool; ``fc`` (the reference hardcodes Linear(1024, 1000))."""

    STAGE_CHANNELS = (32, 64, 128, 1024)
    STAGE_REPEATS = (3, 5, 10, 5)

    def __init__(self, num_classes: int = 1000, features_only: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        stages = [(c, r, 5) for c, r in zip(self.STAGE_CHANNELS, self.STAGE_REPEATS)]
        super().__init__(8, 16, 16, 5, stages, 0, num_classes, features_only, dtype, device)


class TTNetV3(_TTNet):
    """cls_ttnet_v3.py TTNetV3: the config's stem and stages, a 1x1-BN-ReLU
    to ``channel_final``, the pool, ``fc``."""

    stem_name = "stem"
    block_name = "stem_block"

    def __init__(self, num_classes: int, stem_kickoff: int = 8, stem_start: int = 16,
                 stem_expand: int = 2, stem_kernel: int = 3,
                 stage_channels: Sequence[int] = (32, 64, 128),
                 stage_repeats: Sequence[int] = (3, 5, 10),
                 stage_kernels: Sequence[int] = (3, 3, 3), channel_final: int = 1024,
                 features_only: bool = False, dtype: torch.dtype = torch.float32, device=None):
        stages = list(zip(stage_channels, stage_repeats, stage_kernels))
        super().__init__(stem_kickoff, stem_start, stem_kickoff * stem_expand, stem_kernel,
                         stages, channel_final, num_classes, features_only, dtype, device)


def ttnet_v3_from_config(cfg, num_classes: int, dtype: torch.dtype = torch.float32,
                         features_only: bool = False, device=None) -> TTNetV3:
    """TTNetV3 from the reference's ``MODEL.EXTRA`` (cls_ttnet_v3.py:249-287:
    ``STEM.{NUM_CHANNEL_KICKOFF, NUM_CHANNEL_STEM_START, EXPAND_STEM_START,
    KERNEL_SIZE}``, ``STAGES.{NUM_CHANNEL_OUTPUT, NUM_BLOCK_REPEATS,
    KERNEL_SIZE}``, ``NUM_CHANNEL_FINAL``)."""
    extra = cfg.MODEL.EXTRA
    stem, stages = extra.STEM, extra.STAGES
    return TTNetV3(
        num_classes=num_classes,
        stem_kickoff=int(stem.NUM_CHANNEL_KICKOFF),
        stem_start=int(stem.NUM_CHANNEL_STEM_START),
        stem_expand=int(stem.EXPAND_STEM_START),
        stem_kernel=int(stem.KERNEL_SIZE),
        stage_channels=tuple(int(c) for c in stages.NUM_CHANNEL_OUTPUT),
        stage_repeats=tuple(int(r) for r in stages.NUM_BLOCK_REPEATS),
        stage_kernels=tuple(int(k) for k in stages.KERNEL_SIZE),
        channel_final=int(extra.NUM_CHANNEL_FINAL),
        features_only=features_only,
        dtype=dtype,
        device=device,
    )
