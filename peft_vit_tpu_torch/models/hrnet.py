"""HRNet (counterpart of ``peft_vit_tpu/models/hrnet.py``): the reference's
cls_hrnet.py (``HRNet``) and the cls_hrnet_v2 / v2_share / v3 / v4 family
(``HRNetV``).

``HRNet``: a stem of two stride-2 3x3 convs; stage 1, four bottlenecks at
256; stages 2-4 of parallel branches at widths W, 2W, 4W, 8W, each module
four basic blocks a branch and a fuse of every pair of resolutions (1x1 conv
+ nearest upsample going up, chains of stride-2 3x3 convs going down); the
head: a bottleneck a branch to (128, 256, 512, 1024), a strided
downsample-add chain (its convs with a bias), a 1x1 conv with a bias to
2048, the spatial mean.

``HRNetV``: the lighter stems (v2: convs + SE bottlenecks; v3: convs +
inverted residuals; v4: chosen by ``stem_spec``, some with a max pool),
BASIC / BOTTLENECK / INVERTED blocks with optional SE (``SEBlockLinear``:
bias-free linears), the chained fuse (one stride-2 conv chain down the
branches, one 1x1 + upsample chain up, ReLU on the running sums), v2's
last-block ReLU drop, v2_share's branch stacks shared across resolutions
(one module, hence one parameter, run on each resolution's channel split:
its gradient is the sum), v3 / v4's transitions from the last branch, and
the head (relu before each downsample, an optional 1x1 projection).  Every
quirk of the JAX module is kept; see its docstrings.

NCHW inside, NHWC images at the entry.  The module tree has the JAX module's
names (a BatchNorm of the v1 helpers sits under ``<name>.bn``, as flax's
``_BN`` wrapper nests it), so ``convert.params_from_jax`` carries its
variables across.  A module's channel counts, which the JAX module reads off
its input, are worked out here at construction.  Every convolution is
``resnet._Conv2d``; ``_upsample_nearest`` is an ``expand`` and a
``reshape`` (its backward a fixed-order sum); the SE gates and the heads
pool with ``mean``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense
from .resnet import BatchNorm2d, Conv2d, _make_divisible


def _conv(cin: int, ch: int, k: int, s: int, dtype, device, groups: int = 1,
          use_bias: bool = False) -> Conv2d:
    return Conv2d(cin, ch, k, s, groups, dtype=dtype, device=device, bias=use_bias)


def _upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, factor, w, factor)
    return x.reshape(b, c, h * factor, w * factor)


class _BN(nn.Module):
    """The JAX ``_BN`` wrapper: a BatchNorm named ``bn`` inside."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.bn = BatchNorm2d(c, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class BasicBlock(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv1 = _conv(channels, channels, 3, 1, dtype, device)
        self.bn1 = _BN(channels, device)
        self.conv2 = _conv(channels, channels, 3, 1, dtype, device)
        self.bn2 = _BN(channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(x + self.bn2(self.conv2(h)))


class BottleneckBlock(nn.Module):
    """1-3-1 to ``out_channels`` (4x the 3x3's width), a projected shortcut
    when the shape changes."""

    def __init__(self, cin: int, out_channels: int, stride: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        width = out_channels // 4
        self.conv1 = _conv(cin, width, 1, 1, dtype, device)
        self.bn1 = _BN(width, device)
        self.conv2 = _conv(width, width, 3, stride, dtype, device)
        self.bn2 = _BN(width, device)
        self.conv3 = _conv(width, out_channels, 1, 1, dtype, device)
        self.bn3 = _BN(out_channels, device)
        if cin != out_channels or stride != 1:
            self.downsample = _conv(cin, out_channels, 1, stride, dtype, device)
            self.bn_down = _BN(out_channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        shortcut = self.bn_down(self.downsample(x)) if hasattr(self, "downsample") else x
        return F.relu(shortcut + h)


class FuseLayer(nn.Module):
    """out[i] = relu(sum_j resample(x[j] -> i)), summed in j order."""

    def __init__(self, widths: Sequence[int], dtype=torch.float32, device=None):
        super().__init__()
        self.n = n = len(widths)
        for i in range(n):
            for j in range(n):
                if j > i:
                    setattr(self, f"up_{j}_{i}", _conv(widths[j], widths[i], 1, 1, dtype, device))
                    setattr(self, f"up_bn_{j}_{i}", _BN(widths[i], device))
                elif j < i:
                    for k in range(i - j):
                        ch = widths[i] if k == i - j - 1 else widths[j]
                        setattr(self, f"down_{j}_{i}_{k}",
                                _conv(widths[j], ch, 3, 2, dtype, device))
                        setattr(self, f"down_bn_{j}_{i}_{k}", _BN(ch, device))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i in range(self.n):
            acc = None
            for j in range(self.n):
                y = xs[j]
                if j > i:
                    y = getattr(self, f"up_bn_{j}_{i}")(getattr(self, f"up_{j}_{i}")(y))
                    y = _upsample_nearest(y, 2 ** (j - i))
                elif j < i:
                    for k in range(i - j):
                        y = getattr(self, f"down_bn_{j}_{i}_{k}")(
                            getattr(self, f"down_{j}_{i}_{k}")(y))
                        if k != i - j - 1:
                            y = F.relu(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRModule(nn.Module):
    def __init__(self, widths: Sequence[int], blocks_per_branch: int = 4, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n, self.blocks = len(widths), blocks_per_branch
        for bi, w in enumerate(widths):
            for k in range(blocks_per_branch):
                setattr(self, f"branch{bi}_block{k}", BasicBlock(w, dtype, device))
        self.fuse = FuseLayer(widths, dtype, device)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = []
        for bi, x in enumerate(xs):
            for k in range(self.blocks):
                x = getattr(self, f"branch{bi}_block{k}")(x)
            ys.append(x)
        return self.fuse(ys)


class HRNet(nn.Module):
    """HRNet-W``width`` (cls_hrnet): (B, H, W, 3) -> the pooled 2048-d
    feature; ``stage_modules`` the modules of stages 2-4."""

    def __init__(self, width: int = 18, stage_modules: Sequence[int] = (1, 4, 3),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.stage_modules = dtype, tuple(int(m) for m in stage_modules)
        widths = [width, 2 * width, 4 * width, 8 * width]
        conv = lambda ci, co, k, s, bias=False: _conv(ci, co, k, s, dtype, device,  # noqa: E731
                                                      use_bias=bias)
        self.stem_conv1, self.stem_bn1 = conv(3, 64, 3, 2), _BN(64, device)
        self.stem_conv2, self.stem_bn2 = conv(64, 64, 3, 2), _BN(64, device)
        for k in range(4):
            setattr(self, f"layer1_block{k}",
                    BottleneckBlock(64 if k == 0 else 256, 256, dtype=dtype, device=device))
        chans = [256]
        # per stage: each branch's transition, "" (kept), "same" (a 3x3 s1 from
        # its own branch) or "new" (a 3x3 s2 from the last branch)
        self._transitions = []
        for si, n_modules in enumerate(self.stage_modules):
            kinds = []
            for bi in range(si + 2):
                if bi < len(chans):
                    kind, cin = ("same" if chans[bi] != widths[bi] else ""), chans[bi]
                else:
                    kind, cin = "new", chans[-1]
                if kind:
                    setattr(self, f"transition{si}_{bi}",
                            conv(cin, widths[bi], 3, 2 if kind == "new" else 1))
                    setattr(self, f"transition{si}_bn{bi}", _BN(widths[bi], device))
                kinds.append(kind)
            self._transitions.append(kinds)
            chans = widths[:si + 2]
            for mi in range(n_modules):
                setattr(self, f"stage{si + 2}_module{mi}",
                        HRModule(chans, dtype=dtype, device=device))
        incre = [128, 256, 512, 1024]
        self.n_branches = len(chans)
        self.incre0 = BottleneckBlock(chans[0], incre[0], dtype=dtype, device=device)
        for i in range(1, len(chans)):
            setattr(self, f"incre{i}", BottleneckBlock(chans[i], incre[i], dtype=dtype,
                                                       device=device))
            # the head's downsampling convs carry a bias (cls_hrnet.py:379-386)
            setattr(self, f"down{i}", conv(incre[i - 1], incre[i], 3, 2, True))
            setattr(self, f"down_bn{i}", _BN(incre[i], device))
        self.final_conv = conv(incre[len(chans) - 1], 2048, 1, 1, True)
        self.final_bn = _BN(2048, device)
        self.num_features = 2048

    def forward(self, x: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
        if start_layer:
            raise ValueError("HRNet has no cached-prefix cut (start_layer)")
        divisor = 4 * 2 ** len(self.stage_modules)
        if x.shape[1] % divisor or x.shape[2] % divisor:
            raise ValueError(f"HRNet needs input H/W divisible by {divisor} (multi-resolution "
                             f"fusion), got {x.shape[1]}x{x.shape[2]}")
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.stem_bn1(self.stem_conv1(x)))
        x = F.relu(self.stem_bn2(self.stem_conv2(x)))
        for k in range(4):
            x = getattr(self, f"layer1_block{k}")(x)
        branches = [x]
        for si, n_modules in enumerate(self.stage_modules):
            new = []
            for bi, kind in enumerate(self._transitions[si]):
                y = branches[bi] if kind != "new" else branches[-1]
                if kind:
                    y = getattr(self, f"transition{si}_{bi}")(y)
                    y = F.relu(getattr(self, f"transition{si}_bn{bi}")(y))
                new.append(y)
            branches = new
            for mi in range(n_modules):
                branches = getattr(self, f"stage{si + 2}_module{mi}")(branches)
        y = self.incre0(branches[0])
        for i in range(1, len(branches)):
            z = getattr(self, f"incre{i}")(branches[i])
            y = F.relu(getattr(self, f"down_bn{i}")(getattr(self, f"down{i}")(y)))
            y = y + z
        y = F.relu(self.final_bn(self.final_conv(y)))
        return y.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# The v2-v4 family


class SEBlockLinear(nn.Module):
    """The reference SELayer (lib/layers/se_layer.py): pooled -> ``fc0``
    (bias-free) -> ReLU -> ``fc2`` (bias-free) -> sigmoid gate; ``reduction``
    by integer division."""

    def __init__(self, c: int, reduction: int = 16, dtype=torch.float32, device=None):
        super().__init__()
        self.fc0 = Dense(c, c // reduction, bias=False, dtype=dtype, device=device)
        self.fc2 = Dense(c // reduction, c, bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc2(F.relu(self.fc0(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


class _Residual(nn.Module):
    """A block with the JAX ``_maybe_downsample`` shortcut: a bias-free 1x1
    conv (stride) + BN ``downsample`` / ``bn_down`` when the shape changes."""

    def _shortcut_init(self, cin: int, out: int, stride: int, dtype, device) -> None:
        if stride != 1 or cin != out:
            self.downsample = _conv(cin, out, 1, stride, dtype, device)
            self.bn_down = _BN(out, device)

    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn_down(self.downsample(x)) if hasattr(self, "downsample") else x


class BasicBlockV(_Residual):
    """3x3-3x3, optional SE (reduction 1), optional final ReLU."""

    def __init__(self, cin: int, channels: int, stride: int = 1, with_se: bool = False,
                 with_relu: bool = True, groups: int = 1, dtype=torch.float32, device=None):
        super().__init__()
        self.with_relu = with_relu
        self.conv1 = _conv(cin, channels, 3, stride, dtype, device, groups)
        self.bn1 = _BN(channels, device)
        self.conv2 = _conv(channels, channels, 3, 1, dtype, device, groups)
        self.bn2 = _BN(channels, device)
        if with_se:
            self.se = SEBlockLinear(channels, 1, dtype, device)
        self._shortcut_init(cin, channels, stride, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if hasattr(self, "se"):
            h = self.se(h)
        h = h + self._shortcut(x)
        return F.relu(h) if self.with_relu else h


class BottleneckV(_Residual):
    """1-3-1 at 4x expansion, optional SE (reduction 16) on the expanded
    channels, ``groups`` on the 3x3 only."""

    def __init__(self, cin: int, planes: int, stride: int = 1, with_se: bool = False,
                 with_relu: bool = True, groups: int = 1, dtype=torch.float32, device=None):
        super().__init__()
        out = planes * 4
        self.with_relu = with_relu
        self.conv1 = _conv(cin, planes, 1, 1, dtype, device)
        self.bn1 = _BN(planes, device)
        self.conv2 = _conv(planes, planes, 3, stride, dtype, device, groups)
        self.bn2 = _BN(planes, device)
        self.conv3 = _conv(planes, out, 1, 1, dtype, device)
        self.bn3 = _BN(out, device)
        if with_se:
            self.se = SEBlockLinear(out, 16, dtype, device)
        self._shortcut_init(cin, out, stride, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if hasattr(self, "se"):
            h = self.se(h)
        h = h + self._shortcut(x)
        return F.relu(h) if self.with_relu else h


class InvertedResidual(_Residual):
    """pw-expand -> dw 3x3 -> SE (reduction 4 on the expanded width) ->
    pw-linear, every conv with a bias; a linear output plus the residual."""

    def __init__(self, cin: int, out_channels: int, stride: int = 1, exp_ratio: float = 6.0,
                 with_se: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        mid = _make_divisible(cin * exp_ratio, 8)
        self.conv_pw = _conv(cin, mid, 1, 1, dtype, device, use_bias=True)
        self.bn1 = _BN(mid, device)
        self.conv_dw = _conv(mid, mid, 3, stride, dtype, device, groups=mid, use_bias=True)
        self.bn2 = _BN(mid, device)
        if with_se:
            self.se = SEBlockLinear(mid, 4, dtype, device)
        self.conv_pwl = _conv(mid, out_channels, 1, 1, dtype, device, use_bias=True)
        self.bn3 = _BN(out_channels, device)
        self._shortcut_init(cin, out_channels, stride, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv_pw(x)))
        h = F.relu(self.bn2(self.conv_dw(h)))
        if hasattr(self, "se"):
            h = self.se(h)
        h = self.bn3(self.conv_pwl(h))
        return h + self._shortcut(x)


_EXPANSION = {"BASIC": 1, "BOTTLENECK": 4, "INVERTED": 1}


def _make_block(block: str, cin: int, planes: int, with_se: bool, with_relu: bool, groups: int,
                dtype, device, stride: int = 1) -> nn.Module:
    if block == "BASIC":
        return BasicBlockV(cin, planes, stride, with_se, with_relu, groups, dtype, device)
    if block == "BOTTLENECK":
        return BottleneckV(cin, planes, stride, with_se, with_relu, groups, dtype, device)
    if block == "INVERTED":
        return InvertedResidual(cin, planes, stride, 6.0, with_se, dtype, device)
    raise ValueError(f"unknown HRNet block {block!r}")


class HRModuleV2(nn.Module):
    """One v2-v4 HighResolutionModule: the branch stacks and the chained fuse
    (cls_hrnet_v4.py:314-380); ``in_ch`` the branches' input channels."""

    def __init__(self, in_ch: Sequence[int], num_channels: Sequence[int], block: str,
                 num_blocks: Sequence[int], with_se: bool = False, groups: Sequence[int] = (),
                 v2_relu: bool = False, share: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        n = self.n = len(in_ch)
        exp = _EXPANSION[block]
        out_ch = [c * exp for c in num_channels]
        groups = tuple(groups) or (1,) * n
        self.share, self.num_blocks = share, tuple(num_blocks)
        for b in range(n):
            if share:
                planes = num_channels[b] - (num_channels[b - 1] if b else 0)
                cin = in_ch[b] - (in_ch[b - 1] if b else 0)
            else:
                planes, cin = num_channels[b], in_ch[b]
            for k in range(num_blocks[b]):
                last = k == num_blocks[b] - 1
                setattr(self, f"branch{b}_block{k}", _make_block(
                    block, cin, planes, with_se, not (v2_relu and last), groups[b], dtype,
                    device))
                cin = planes * exp
        self.split = [in_ch[0]] + [in_ch[j] - in_ch[j - 1] for j in range(1, n)]
        for i in range(n - 1):
            setattr(self, f"fuse_down{i}", _conv(out_ch[i], out_ch[i + 1], 3, 2, dtype, device))
            setattr(self, f"fuse_down_bn{i}", _BN(out_ch[i + 1], device))
            setattr(self, f"fuse_up{i}",
                    _conv(out_ch[n - 1 - i], out_ch[n - 2 - i], 1, 1, dtype, device))
            setattr(self, f"fuse_up_bn{i}", _BN(out_ch[n - 2 - i], device))

    def _run(self, b: int, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_blocks[b]):
            x = getattr(self, f"branch{b}_block{k}")(x)
        return x

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        n = self.n
        if self.share:
            # branch i's input split into the cumulative deltas, each through
            # the (shared) stack of its resolution (cls_hrnet_v2_share.py:302-310)
            ys = [self._run(0, xs[0])]
            for i in range(1, n):
                splits = torch.split(xs[i], self.split[:i + 1], dim=1)
                ys.append(torch.cat([self._run(j, splits[j]) for j in range(i + 1)], dim=1))
        else:
            ys = [self._run(b, xs[b]) for b in range(n)]
        if n == 1:
            return [F.relu(ys[0])]
        x_down, x_up = [None], [None]
        for i in range(n - 1):
            d_in = ys[i] if x_down[i] is None else x_down[i] + ys[i]
            d = getattr(self, f"fuse_down{i}")(F.relu(d_in))
            x_down.append(getattr(self, f"fuse_down_bn{i}")(d))
            u_in = ys[n - 1 - i] if x_up[i] is None else ys[n - 1 - i] + x_up[i]
            u = getattr(self, f"fuse_up_bn{i}")(getattr(self, f"fuse_up{i}")(F.relu(u_in)))
            x_up.append(_upsample_nearest(u, 2))
        outs = []
        for i in range(n):
            s = ys[i]
            if x_down[i] is not None:
                s = s + x_down[i]
            if x_up[n - 1 - i] is not None:
                s = s + x_up[n - 1 - i]
            outs.append(F.relu(s))
        return outs


# the v4 stems: (conv-BN-ReLU layers as (channels, stride), a max pool after
# them, the inverted residuals as (channels, stride, expansion, SE forced on))
_V4_STEMS = {
    "conv16s2conv24s2inv24e6x2": (((16, 2), (24, 2)), False, ((24, 1, 6.0, False),) * 2),
    "conv32s2maxpools2": (((32, 2),), True, ()),
    "conv32s2maxpools2inv32e6x1": (((32, 2),), True, ((32, 1, 6.0, False),)),
    # the reference builds this block without with_se=False (cls_hrnet_v4.py:482),
    # so its SE is on despite the name
    "conv32s2maxpools2inv32e2wosex1": (((32, 2),), True, ((32, 1, 2.0, True),)),
    "conv32s2inv32e6s2x1": (((32, 2),), False, ((32, 2, 6.0, False),)),
    "conv24s2inv24e6s2x1": (((24, 2),), False, ((24, 2, 6.0, False),)),
}


class HRNetV(nn.Module):
    """cls_hrnet_v2 / v2_share / v3 / v4 -> the pooled feature; the JAX
    module's fields, same names and defaults."""

    def __init__(self, version: str = "v4", stem_spec: str = "conv32s2maxpools2inv32e6x1",
                 num_modules: Sequence[int] = (1, 2, 1), num_branches: Sequence[int] = (2, 3, 4),
                 num_blocks: Sequence[Sequence[int]] = ((2, 2), (2, 2, 2), (2, 2, 2, 2)),
                 num_channels: Sequence[Sequence[int]] = ((18, 36), (18, 36, 72),
                                                          (18, 36, 72, 144)),
                 block: Sequence[str] = ("INVERTED", "INVERTED", "INVERTED"),
                 groups: Sequence[Sequence[int]] = (),
                 head_block: Sequence[str] = ("INVERTED",) * 4,
                 head_channels: Sequence[int] = (32, 64, 128, 256), head_proj: int = 2048,
                 with_se: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.version = dtype, version
        self.num_modules = tuple(int(m) for m in num_modules)
        conv = lambda ci, co, k, s, bias=False: _conv(ci, co, k, s, dtype, device,  # noqa: E731
                                                      use_bias=bias)
        # the stem: conv-BN-ReLU layers, then a max pool or not, then blocks
        if version in ("v2", "v2_share", "v3"):
            chs = (64, 64) if version != "v3" else (16, 24)
            convs, pool = tuple((c, 2) for c in chs), False
        elif version == "v4":
            if stem_spec not in _V4_STEMS:
                raise ValueError(f"unknown STEM_SPEC {stem_spec!r}")
            convs, pool, inverted = _V4_STEMS[stem_spec]
        else:
            raise ValueError(f"unknown HRNet version {version!r}")
        cin = 3
        for idx, (ch, stride) in enumerate(convs, start=1):
            setattr(self, f"stem_conv{idx}", conv(cin, ch, 3, stride))
            setattr(self, f"stem_bn{idx}", _BN(ch, device))
            cin = ch
        self.n_stem_convs, self.stem_pool = len(convs), pool
        if version in ("v2", "v2_share"):
            stem_blocks = [BottleneckV(cin if k == 0 else 256, 64, with_se=with_se, dtype=dtype,
                                       device=device) for k in range(4)]
            cin = 256
        elif version == "v3":
            stem_blocks = [InvertedResidual(24, 24, with_se=with_se, dtype=dtype, device=device)
                           for _ in range(2)]
        else:
            stem_blocks = []
            for ch, stride, e, se_on in inverted:
                stem_blocks.append(InvertedResidual(cin, ch, stride, e, with_se or se_on, dtype,
                                                    device))
                cin = ch
        for k, blk in enumerate(stem_blocks):
            setattr(self, f"layer1_block{k}", blk)
        self.n_stem_blocks = len(stem_blocks)

        # the stages: each branch's transition ("" kept, "conv" a 3x3 s1 from
        # its own branch (v2) or the last (v3 / v4), or a chain's length)
        prev = [cin]
        self._transitions = []
        for i in range(len(self.num_modules)):
            cur = [int(c) for c in num_channels[i]]
            kinds = []
            for j in range(int(num_branches[i])):
                if j < len(prev):
                    if prev[j] != cur[j]:
                        src = j if version in ("v2", "v2_share") else len(prev) - 1
                        setattr(self, f"transition{i + 1}_{j}", conv(prev[src], cur[j], 3, 1))
                        setattr(self, f"transition{i + 1}_bn{j}", _BN(cur[j], device))
                        kinds.append(("conv", src))
                    else:
                        kinds.append(("", j))
                else:
                    steps = j + 1 - len(prev)
                    ci = prev[-1]
                    for k in range(steps):
                        ch = cur[j] if k == steps - 1 else prev[-1]
                        setattr(self, f"transition{i + 1}_{j}_{k}", conv(ci, ch, 3, 2))
                        setattr(self, f"transition{i + 1}_bn{j}_{k}", _BN(ch, device))
                        ci = ch
                    kinds.append(("chain", steps))
            self._transitions.append(kinds)
            in_ch = cur
            for m in range(self.num_modules[i]):
                setattr(self, f"stage{i + 2}_m{m}", HRModuleV2(
                    in_ch, cur, str(block[i]), tuple(num_blocks[i]), with_se=with_se,
                    groups=tuple(groups[i]) if groups else (),
                    v2_relu=version in ("v2", "v2_share"), share=version == "v2_share",
                    dtype=dtype, device=device))
                in_ch = [c * _EXPANSION[block[i]] for c in cur]
            prev = [c * _EXPANSION[block[i]] for c in cur]

        # the head (v2's incre blocks keep their relu: the flag never reaches a
        # single-block layer's first block, cls_hrnet_v2.py:476-477)
        hexp = [_EXPANSION[b] for b in head_block]
        self.n_branches = n = len(prev)
        self.incre0 = _make_block(head_block[0], prev[0], head_channels[0], with_se, True, 1,
                                  dtype, device)
        ych = head_channels[0] * hexp[0]
        for i in range(n - 1):
            setattr(self, f"incre{i + 1}", _make_block(
                head_block[i + 1], prev[i + 1], head_channels[i + 1], with_se, True, 1, dtype,
                device))
            # biased downsample convs (cls_hrnet_v4.py:541-550)
            out = head_channels[i + 1] * hexp[i]
            setattr(self, f"down{i + 1}", conv(ych, out, 3, 2, True))
            setattr(self, f"down_bn{i + 1}", _BN(out, device))
            ych = out
        self.head_proj = int(head_proj)
        if self.head_proj > 0:
            self.final_conv = conv(ych, self.head_proj, 1, 1, True)
            self.final_bn = _BN(self.head_proj, device)
            ych = self.head_proj
        self.num_features = ych

    def forward(self, x: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
        if start_layer:
            raise ValueError("HRNet has no cached-prefix cut (start_layer)")
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for idx in range(1, self.n_stem_convs + 1):
            x = F.relu(getattr(self, f"stem_bn{idx}")(getattr(self, f"stem_conv{idx}")(x)))
        if self.stem_pool:
            x = F.max_pool2d(x, 3, 2, 1)
        for k in range(self.n_stem_blocks):
            x = getattr(self, f"layer1_block{k}")(x)
        ys = [x]
        for i, kinds in enumerate(self._transitions):
            xs = []
            for j, (kind, arg) in enumerate(kinds):
                if kind == "conv":
                    t = getattr(self, f"transition{i + 1}_{j}")(ys[arg])
                    xs.append(F.relu(getattr(self, f"transition{i + 1}_bn{j}")(t)))
                elif kind == "chain":
                    t = ys[-1]
                    for k in range(arg):
                        t = getattr(self, f"transition{i + 1}_{j}_{k}")(t)
                        t = F.relu(getattr(self, f"transition{i + 1}_bn{j}_{k}")(t))
                    xs.append(t)
                else:
                    xs.append(ys[arg])
            for m in range(self.num_modules[i]):
                xs = getattr(self, f"stage{i + 2}_m{m}")(xs)
            ys = xs
        y = self.incre0(ys[0])
        for i in range(len(ys) - 1):
            z = getattr(self, f"incre{i + 1}")(ys[i + 1])
            d = getattr(self, f"down{i + 1}")(F.relu(y))
            y = z + getattr(self, f"down_bn{i + 1}")(d)
        y = F.relu(y)
        if self.head_proj > 0:
            y = F.relu(self.final_bn(self.final_conv(y)))
        return y.mean(dim=(2, 3))


def hrnet_v_spec(version: str, spec) -> dict:
    """``HRNetV``'s fields from the reference experiment yaml's surface (the
    JAX ``_build_hrnet_backbone``): v2 / v2_share read ``MODEL.SPEC``
    (``WITH_SE``, ``STAGES``, ``HEAD``), v3 / v4 ``MODEL.EXTRA``
    (``WITH_SE``, ``STEM_SPEC``, ``STAGES_SPEC``, ``HEAD_SPEC``); ``spec``
    is that node."""
    if version in ("v2", "v2_share"):
        stages, head = spec.STAGES, spec.HEAD
    else:
        stages, head = spec.STAGES_SPEC, spec.HEAD_SPEC
    groups = stages.get("GROUPS", None)
    return dict(
        version=version,
        stem_spec=str(spec.get("STEM_SPEC", "")),
        num_modules=tuple(int(m) for m in stages.NUM_MODULES),
        num_branches=tuple(int(b) for b in stages.NUM_BRANCHES),
        num_blocks=tuple(tuple(int(x) for x in b) for b in stages.NUM_BLOCKS),
        num_channels=tuple(tuple(int(x) for x in c) for c in stages.NUM_CHANNELS),
        block=tuple(str(b) for b in stages.BLOCK),
        groups=tuple(tuple(int(x) for x in g) for g in groups) if groups else (),
        head_block=tuple(str(b) for b in head.BLOCK),
        head_channels=tuple(int(c) for c in head.NUM_CHANNELS),
        head_proj=int(head.NUM_CHANNELS_PROJ),
        with_se=bool(spec.get("WITH_SE", False)),
    )
