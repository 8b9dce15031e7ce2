"""The ResNet backbone family (counterpart of ``peft_vit_tpu/models/resnet.py``).

One implementation with switches, as in the JAX module (the reference's
cls_resnet.py, cls_resnet_v2.py, cls_resnetD.py and the SE / ResNeXt /
resnetP variants):

* ``version``: ``'v1'`` (post-activation), ``'v2'`` (pre-activation, a
  final ``bn_final`` + ReLU) or ``'d'`` (cls_resnetD's PreActBottleneck:
  ``act0`` on the block input, the downsample fed from act0's output, DropBlock
  after every conv and on the shortcut, SE before the add, ``bn3`` AFTER the
  residual add, and one ``final_act`` before the pool);
* the stems: the 7x7 conv + maxpool; ``deep_stem`` (three 3x3 convs); the
  'd' stems (deep: 3x3 convs strided 2/1/2 and no maxpool; ``stem_kernel``
  3: two strided 3x3 convs; 7: conv7-bn-act-maxpool, the evident intent of
  the reference's broken forward);
* ``cardinality`` / ``base_width`` (ResNeXt), ``se_ratio`` and
  ``se_stages`` (bias-free SE, hidden = channels * ratio), ``avg_down``
  (ResNet-D shortcut: a 2x2 average pool, then a stride-1 1x1 conv; v1 pools
  with flax's SAME padding counting the padded zeros, 'd' without counting
  them), ``with_relu`` (no post-residual ReLU), ``proj_dims`` and
  ``proj_dropout`` (resnetP's projection chain after the pool);
* the norm: BatchNorm (flax's: the batch's biased variance normalizes AND
  is blended into ``bn_var`` at momentum 0.9), GroupNorm with
  weight-standardized convs (BiT), or ``FrozenBatchNorm`` (``frozen_bn``:
  fixed statistics that are parameters, ``mean`` and ``var``, as in the JAX
  tree);
* ``dy_relu``: DYReLU2 activations in the 'd' blocks and stem;
* DropBlock on ``dropblock_stages`` (``ops.dropblock``), annealed by the
  call's ``progress`` and drawn from the call's ``generator``.

Images arrive NHWC, as in the JAX package, and are made NCHW once at the
entry; every module inside is NCHW, with OIHW conv weights.  Weights are
stored in fp32 and cast to the compute ``dtype`` at use; the norms compute
in fp32 and return the compute dtype.  The BatchNorm statistics are the
buffers ``bn_mean`` / ``bn_var`` (the JAX ``batch_stats``): a train-mode
forward writes the blended statistics into the tensors it is given
(``batch_norm`` returns them), so that a functional step carries them as
state, one copy per cell in a sweep round.

The convolutions, pools and norms are cuDNN / ATen calls, as the JAX module
leaves them to XLA outside any Pallas kernel.  Every convolution runs
through ``_Conv2d``: fp32 operands compute in fp32 (cuDNN would take TF32
for them), each flag scoped to its one call.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropblock import drop_block, scheduled_keep_prob, stage_keep_prob
from ..utils import dist as _dist
from .layers import Dense

def _cudnn(dtype: torch.dtype, deterministic: bool = False):
    """cuDNN's flags for one call: enabled, no benchmark search, TF32 only
    for operands that are not fp32, and ``deterministic`` as asked."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=deterministic,
                                      allow_tf32=dtype != torch.float32)


def deterministic_backward(dtype: torch.dtype) -> bool:
    """Whether ``_Conv2d``'s gradients of ``dtype`` operands take cuDNN's
    deterministic algorithms: fp32 and float64 do (their default algorithms
    did not repeat the input or weight gradient of 21 of HRNet v2's 33
    convolutions on the H100, ``chip_smoke.py::zoo_determinism``); bf16 keeps
    the default ones, which repeated every gradient of the ResNet, RN50,
    EfficientNet-B0, ReXNet, TTNet v2 and HRNet-W18 steps and rounds."""
    return dtype != torch.bfloat16


class _Conv2d(torch.autograd.Function):
    """``F.conv2d(x, w, None, stride, padding, 1, groups)`` (NCHW, OIHW, no
    bias) and its input and weight gradients (``torch.nn.grad.conv2d_input``
    / ``conv2d_weight``), each under ``_cudnn``, the gradients with the
    algorithms ``deterministic_backward`` picks for the operands' dtype,
    scoped to the call (``chip_smoke.py``'s determinism probes hold each
    convolution of the paths to repeating bit for bit under them; PERF.md
    §6).  The batching rule folds a sweep round's cells into the batch for a
    shared weight; a batched (trainable) weight makes the round one grouped
    convolution, the cells' channels side by side."""

    @staticmethod
    def forward(x, w, stride, padding, groups):
        with _cudnn(x.dtype):
            return F.conv2d(x, w, None, stride, padding, 1, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, stride, padding, groups = inputs
        need_dx, need_dw = ctx.needs_input_grad[:2]
        ctx.conv = (stride, padding, groups)
        ctx.shapes = (x.shape, w.shape)
        ctx.save_for_backward(x if need_dw else None, w if need_dx else None)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conv
        x_shape, w_shape = ctx.shapes
        dx = dw = None
        with _cudnn(g.dtype, deterministic_backward(g.dtype)):
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(x_shape, w, g, stride, padding, 1, groups)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(x, w_shape, g, stride, padding, 1, groups)
        return dx, dw, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, stride, padding, groups):
        cells = info.batch_size
        x_dim, w_dim = in_dims[:2]
        if w_dim is None:
            x = x.movedim(x_dim, 0)
            out = _Conv2d.apply(x.reshape(-1, *x.shape[2:]), w, stride, padding, groups)
            return out.unflatten(0, (cells, -1)), 0
        w = w.movedim(w_dim, 0)
        x = (x.movedim(x_dim, 1) if x_dim is not None
             else x.unsqueeze(1).expand(-1, cells, *x.shape[1:]))
        folded = x.reshape(x.shape[0], -1, *x.shape[3:])
        out = _Conv2d.apply(folded, w.reshape(-1, *w.shape[2:]), stride, padding,
                            groups * cells)
        return out.unflatten(1, (cells, -1)).movedim(1, 0), 0


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    return _Conv2d.apply(x, w, stride, padding, groups)


def _stat_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype the norms compute in: at least fp32 (flax's
    ``force_float32_reductions``), float64 for a float64 model."""
    return torch.promote_types(t.dtype, torch.float32)


def _lecun_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at 2 std, of variance
    1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


class Conv2d(nn.Module):
    """A k x k convolution, padding k // 2 (flax ``nn.Conv`` with explicit
    symmetric padding), its OIHW ``weight`` stored in fp32 and cast to the
    compute dtype at use; ``standardize`` (BiT's StdConv) first standardizes
    the weight over (in, kh, kw) with the biased variance and eps 1e-10, in
    fp32.  ``bias``: a zero-initialised fp32 ``bias``, added in the compute
    dtype after the convolution, as flax adds it."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 standardize: bool = False, dtype: torch.dtype = torch.float32, device=None,
                 padding: Optional[int] = None, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(_lecun_normal_(
            torch.empty(cout, cin // groups, k, k, device=device), cin // groups * k * k))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None
        self.stride, self.groups, self.standardize = stride, groups, standardize
        self.padding = k // 2 if padding is None else padding
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.standardize:
            w = w.to(_stat_dtype(w))
            m = w.mean(dim=(1, 2, 3), keepdim=True)
            v = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
            w = (w - m) * torch.rsqrt(v + 1e-10)
        dt = self.compute_dtype
        y = conv2d(x.to(dt), w.to(dt), self.stride, self.padding, self.groups)
        return y if self.bias is None else y + self.bias.to(dt).reshape(1, -1, 1, 1)


def _affine(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's ``_normalize`` over NCHW channels: (x - mean) * (rsqrt(var +
    eps) * weight) + bias in fp32, returned in x's dtype."""
    c = (1, -1, 1, 1)
    y = x.to(_stat_dtype(x)) - mean.reshape(c)
    y = y * (torch.rsqrt(var + eps) * weight).reshape(c) + bias.reshape(c)
    return y.to(x.dtype)


def _group_moments(x32: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean and biased variance over ``dims`` of the global batch whose
    rows this rank holds (``utils.dist.data_shard``): Σx with the count in
    one sum over the group, then Σ(x - m)^2."""
    count = torch.full((1,), float(x32.numel() // x32.shape[1]), dtype=x32.dtype,
                       device=x32.device)
    sums = _dist.sum_over_data(torch.cat([x32.sum(dim=dims), count]))
    m = sums[:-1] / sums[-1]
    shape = [1] * x32.dim()
    shape[1] = -1
    v = _dist.sum_over_data((x32 - m.reshape(shape)).square().sum(dim=dims)) / sums[-1]
    return m, v


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
               var: torch.Tensor, train: bool, momentum: float = 0.9,
               eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the NCHW
    ``x``: ``(y, new_mean, new_var)``.  In training the batch's mean and
    biased variance (fp32) normalize, and the new statistics are
    ``momentum * old + (1 - momentum) * batch``; in eval the running
    ``mean`` / ``var`` normalize and come back unchanged.  The variance is
    taken in two passes, the mean of (x - mean)^2: flax's one pass,
    E[x^2] - E[x]^2, is the same quantity with more cancellation, and on
    the executed reference's epoch loop (``refexec_trainer_epoch_resnet``)
    its rounding put the third epoch's loss 7e-3 from PyTorch's, where the
    two passes stand within 1e-6.

    Under ``utils.dist.data_shard`` (a step over a data group) the moments
    are the global batch's, as flax takes them from the sharded global
    array: Σx and the count summed over the group, then Σ(x - m)^2, each
    sum's gradient summed over the group too."""
    if not train:
        return _affine(x, mean, var, weight, bias, eps), mean, var
    x32 = x.to(_stat_dtype(x))
    if _dist.current_shard() is None:
        m = x32.mean(dim=(0, 2, 3))
        v = (x32 - m.reshape(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    else:
        m, v = _group_moments(x32, (0, 2, 3))
    y = _affine(x, m, v, weight, bias, eps)
    return y, momentum * mean + (1 - momentum) * m, momentum * var + (1 - momentum) * v


class BatchNorm2d(nn.Module):
    """``batch_norm`` with fp32 ``weight`` / ``bias`` (flax ``scale`` /
    ``bias``) and the statistics in the buffers ``bn_mean`` / ``bn_var``; a
    train-mode forward writes the new statistics into them (into the
    tensors ``functional_call`` substitutes for them).  ``eps``: flax's
    ``epsilon`` (1e-5; EfficientNet's 1e-3)."""

    def __init__(self, c: int, device=None, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("bn_mean", torch.zeros(c, device=device))
        self.register_buffer("bn_var", torch.ones(c, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, m, v = batch_norm(x, self.weight, self.bias, self.bn_mean, self.bn_var, self.training,
                             eps=self.eps)
        if self.training:
            with torch.no_grad():
                self.bn_mean.copy_(m)
                self.bn_var.copy_(v)
        return y


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics (lib/layers/batch_norm.py:12-148):
    ``x * inv + (bias - mean * inv)``, ``inv = rsqrt(var + eps) * weight``,
    in fp32.  ``mean`` and ``var`` are parameters, as in the JAX tree, so
    that a mask selects them as it selects the JAX leaves."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.mean = nn.Parameter(torch.zeros(c, device=device))
        self.var = nn.Parameter(torch.ones(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = (1, -1, 1, 1)
        inv = torch.rsqrt(self.var + 1e-5) * self.weight
        y = x.to(_stat_dtype(x)) * inv.reshape(c) + (self.bias - self.mean * inv).reshape(c)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(epsilon=1e-5)`` with the groups chosen from the
    channel count (32 when it divides, else the largest divisor <= 32): the
    groups' mean and biased variance in fp32 (two passes, as
    ``batch_norm``), then ``_affine``."""

    def __init__(self, c: int, device=None):
        super().__init__()
        g = min(32, c)
        while c % g:
            g -= 1
        self.groups = g
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        xg = x.to(_stat_dtype(x)).reshape(n, self.groups, -1)
        m = xg.mean(dim=2)
        v = (xg - m[:, :, None]).square().mean(dim=2)
        rep = c // self.groups
        m = m.repeat_interleave(rep, dim=1)[:, :, None, None]
        v = v.repeat_interleave(rep, dim=1)[:, :, None, None]
        y = (x.to(_stat_dtype(x)) - m) * (torch.rsqrt(v + 1e-5) * self.weight[:, None, None])
        return (y + self.bias[:, None, None]).to(x.dtype)


def make_norm(kind: str, c: int, device=None) -> nn.Module:
    """``'frozen'`` -> FrozenBatchNorm, ``'gn'`` -> GroupNorm, else
    BatchNorm2d (the JAX ``_norm``)."""
    if kind == "frozen":
        return FrozenBatchNorm(c, device)
    if kind == "gn":
        return GroupNorm(c, device)
    return BatchNorm2d(c, device)


class DyReLUSpec(NamedTuple):
    """DYReLU2's hyperparameters (``MODEL.SPEC.DY_RELU``, cls_resnetD.py:20-37)."""

    reduction: int = 4
    lambda_a: float = 1.0
    k2: bool = True
    use_bias: bool = True
    init_a: Tuple[float, float] = (1.0, 0.0)
    init_b: Tuple[float, float] = (0.0, 0.0)


def _make_divisible(v, divisor, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class DyReLU(nn.Module):
    """DYReLU2 (lib/layers/dy_relu.py:28-97): a channel-attention MLP (the
    fp32 spatial mean -> ``fc1`` -> ReLU -> ``fc2`` -> h_sigmoid) gives
    per-channel coefficients of ``max(x a1 + b1, x a2 + b2)`` (K2 with bias;
    the other variants as in the JAX module)."""

    def __init__(self, channels: int, spec: DyReLUSpec = DyReLUSpec(),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        s = spec
        self.spec, self.channels = s, channels
        self.exp = (4 if s.use_bias else 2) if s.k2 else (2 if s.use_bias else 1)
        squeeze = (channels // s.reduction if s.reduction == 4
                   else _make_divisible(channels // s.reduction, 4))
        self.fc1 = Dense(channels, squeeze, dtype=dtype, device=device)
        self.fc2 = Dense(squeeze, channels * self.exp, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, c = self.spec, self.channels
        y = x.to(_stat_dtype(x)).mean(dim=(2, 3))
        y = self.fc2(F.relu(self.fc1(y)))
        y = (F.relu6(y + 3.0) / 6.0)[:, :, None, None].to(x.dtype)
        lam = s.lambda_a * 2.0
        if self.exp == 4:
            a1 = (y[:, :c] - 0.5) * lam + s.init_a[0]
            b1 = y[:, c:2 * c] - 0.5 + s.init_b[0]
            a2 = (y[:, 2 * c:3 * c] - 0.5) * lam + s.init_a[1]
            b2 = y[:, 3 * c:] - 0.5 + s.init_b[1]
            return torch.maximum(x * a1 + b1, x * a2 + b2)
        if self.exp == 2:
            a1 = (y[:, :c] - 0.5) * lam + s.init_a[0]
            if s.use_bias:
                return x * a1 + (y[:, c:] - 0.5 + s.init_b[0])
            a2 = (y[:, c:] - 0.5) * lam + s.init_a[1]
            return torch.maximum(x * a1, x * a2)
        return x * ((y - 0.5) * lam + s.init_a[0])


class SqueezeExcite(nn.Module):
    """SE (lib/layers/se_layer.py:4-19): bias-free ``fc1`` / ``fc2``, hidden
    = max(int(channels * ratio), 1), the mean in the compute dtype."""

    def __init__(self, channels: int, ratio: float = 1.0 / 16.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        hidden = max(int(channels * ratio), 1)
        self.fc1 = Dense(channels, hidden, bias=False, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, channels, bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None]


def _same_pad(size: int, k: int) -> Tuple[int, int]:
    """flax's SAME padding of a k-window, stride-k axis: (low, high)."""
    out = -(-size // k)
    total = max((out - 1) * k + k - size, 0)
    return total // 2, total - total // 2


def avg_pool_same(x: torch.Tensor, k: int, count_include_pad: bool) -> torch.Tensor:
    """flax ``nn.avg_pool(x, (k, k), strides=(k, k), padding="SAME")``:
    the window sums over a zero-padded map (the pad at the end when the map
    is odd), divided by k^2 or, without ``count_include_pad``, by the
    window's count of unpadded elements."""
    (t, b), (le, r) = _same_pad(x.shape[2], k), _same_pad(x.shape[3], k)
    pad = (le, r, t, b)
    s = F.avg_pool2d(F.pad(x, pad), k, k, divisor_override=1)
    if count_include_pad:
        return s / (k * k)
    ones = F.pad(torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device), pad)
    return s / F.avg_pool2d(ones, k, k, divisor_override=1)


class Bottleneck(nn.Module):
    """The bottleneck block of ``version`` v1, v2 or d (see the module
    docstring), with ``out_channels`` the expanded width."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 version: str = "v1", cardinality: int = 1, base_width: int = 64,
                 se_ratio: float = 0.0, norm: str = "bn", weight_standardization: bool = False,
                 avg_down: bool = False, with_relu: bool = True,
                 dy_relu: Optional[DyReLUSpec] = None, use_dropblock: bool = False,
                 dropblock_size: int = 7, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        width = int(out_channels / 4 * (base_width / 64.0) * cardinality)
        self.version, self.stride, self.avg_down, self.with_relu = (version, stride, avg_down,
                                                                     with_relu)
        self.use_dropblock, self.dropblock_size = use_dropblock, dropblock_size
        self.needs_proj = stride != 1 or in_channels != out_channels
        conv = lambda ci, co, k, s, groups=1: Conv2d(  # noqa: E731
            ci, co, k, s, groups, weight_standardization, dtype, device)
        norm_ = lambda c: make_norm(norm, c, device)  # noqa: E731

        def act(c: int) -> Optional[nn.Module]:
            return DyReLU(c, dy_relu, dtype, device) if dy_relu is not None else None

        if version == "d":
            self.act0 = act(in_channels)
        if version == "v2":
            self.bn_pre = norm_(in_channels)
        self.conv1 = conv(in_channels, width, 1, 1)
        self.bn1 = norm_(width)
        self.conv2 = conv(width, width, 3, stride, cardinality)
        self.bn2 = norm_(width)
        self.conv3 = conv(width, out_channels, 1, 1)
        if version != "v2":
            self.bn3 = norm_(out_channels)
        if version == "d":
            self.act1, self.act2 = act(width), act(width)
        if se_ratio > 0:
            self.se = SqueezeExcite(out_channels, se_ratio, dtype, device)
        if self.needs_proj:
            pooled = avg_down and stride > 1
            self.downsample = conv(in_channels, out_channels, 1, 1 if pooled else stride)
            if version != "v2":
                self.bn_down = norm_(out_channels)

    def _act(self, name: str, h: torch.Tensor) -> torch.Tensor:
        m = getattr(self, name, None)
        return F.relu(h) if m is None else m(h)

    def forward(self, x: torch.Tensor, db_keep=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        on = self.use_dropblock and self.training and db_keep is not None

        def db(h: torch.Tensor) -> torch.Tensor:
            # each site draws its own mask, as the reference's repeated calls do
            if not on:
                return h
            if generator is None:
                raise ValueError("a train-mode forward through DropBlock needs its generator "
                                 "(the JAX module's 'dropblock' PRNG stream; the few-shot "
                                 "step passes none, as the JAX step passes no stream)")
            return drop_block(h, block_size=self.dropblock_size, keep_prob=db_keep,
                              generator=generator)

        se = getattr(self, "se", None)
        if self.version == "d":
            out = self._act("act0", x)
            shortcut = x
            if self.needs_proj:
                s_in = out
                if self.avg_down and self.stride > 1:
                    s_in = avg_pool_same(out, self.stride, count_include_pad=False)
                shortcut = self.bn_down(self.downsample(s_in))
            h = db(self.conv1(out))
            h = self._act("act1", self.bn1(h))
            h = db(self.conv2(h))
            h = self._act("act2", self.bn2(h))
            h = db(self.conv3(h))
            if se is not None:
                h = se(h)
            return self.bn3(h + db(shortcut))
        if self.version == "v2":
            pre = F.relu(self.bn_pre(x))
            h = F.relu(self.bn1(self.conv1(pre)))
            h = F.relu(self.bn2(self.conv2(h)))
            h = self.conv3(h)
            shortcut = self.downsample(pre) if self.needs_proj else x
            if se is not None:
                h = se(h)
            return shortcut + h
        h = db(F.relu(self.bn1(self.conv1(x))))
        h = db(F.relu(self.bn2(self.conv2(h))))
        h = db(self.bn3(self.conv3(h)))
        if se is not None:
            h = se(h)
        shortcut = x
        if self.needs_proj:
            s_in = x
            if self.avg_down and self.stride > 1:
                s_in = avg_pool_same(x, 2, count_include_pad=True)
            shortcut = self.bn_down(self.downsample(s_in))
        out = db(shortcut) + h
        return F.relu(out) if self.with_relu else out


class ResNet(nn.Module):
    """ResNet-{50,101,152} / ResNeXt / SE / -D / v2 / resnetD ('d') /
    resnetP (``proj_dims``): (B, H, W, 3) images -> (B, num_features) pooled
    features.  The JAX module's fields, same names and defaults."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 version: str = "v1", cardinality: int = 1, base_width: int = 64,
                 se_ratio: float = 0.0, se_stages: Optional[Sequence[bool]] = None,
                 deep_stem: bool = False, stem_kernel: int = 7, avg_down: bool = False,
                 frozen_bn: bool = False, norm: str = "bn",
                 weight_standardization: bool = False, with_relu: bool = True,
                 proj_dims: Sequence[int] = (), proj_dropout: float = 0.0,
                 dy_relu: Optional[DyReLUSpec] = None, dropblock_stages: Sequence[int] = (),
                 dropblock_keep_prob: float = 1.0, dropblock_block_size: int = 7,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.layers = tuple(int(n) for n in layers)
        self.version, self.dtype, self.proj_dropout = version, dtype, float(proj_dropout)
        self.dropblock_keep_prob = float(dropblock_keep_prob)
        kind = "frozen" if frozen_bn else norm
        dy = dy_relu if version == "d" else None
        conv = lambda ci, co, k, s: Conv2d(  # noqa: E731
            ci, co, k, s, 1, weight_standardization, dtype, device)
        norm_ = lambda c: make_norm(kind, c, device)  # noqa: E731

        def act(c: int) -> Optional[nn.Module]:
            return DyReLU(c, dy, dtype, device) if dy is not None else None

        w = int(width)
        # the stem's layers: (conv, norm, activation, in, out, kernel, stride);
        # the activation a DyReLU module's name ('d' with DY_RELU, else ReLU),
        # "" for ReLU, None for none (the 'd' stems end un-activated)
        if version == "d" and deep_stem:
            stem = [("stem_conv1", "stem_bn1", "stem_act1", 3, w // 2, 3, 2),
                    ("stem_conv2", "stem_bn2", "stem_act2", w // 2, w, 3, 1),
                    ("stem_conv3", "stem_bn3", None, w, w, 3, 2)]
        elif version == "d" and stem_kernel == 3:
            stem = [("stem_conv1", "stem_bn1", "stem_act1", 3, w, 3, 2),
                    ("stem_conv2", "stem_bn2", None, w, w, 3, 2)]
        elif version == "d":
            stem = [("conv1", "bn1", "stem_act1", 3, w, 7, 2)]
        elif deep_stem:
            stem = [("stem_conv1", "stem_bn1", "", 3, w // 2, 3, 2),
                    ("stem_conv2", "stem_bn2", "", w // 2, w // 2, 3, 1),
                    ("stem_conv3", "stem_bn3", "", w // 2, w, 3, 1)]
        else:
            stem = [("conv1", "bn1", "", 3, w, 7, 2)]
        for conv_name, norm_name, act_name, ci, co, k, s in stem:
            setattr(self, conv_name, conv(ci, co, k, s))
            setattr(self, norm_name, norm_(co))
            if act_name and dy is not None:
                setattr(self, act_name, act(co))
        self._stem = [(c, n, a) for c, n, a, *_ in stem]
        # the 'd' deep and kernel-3 stems own their downsampling (no maxpool)
        self.stem_pool = not (version == "d" and (deep_stem or stem_kernel == 3))

        self._stages = []
        cin, ch = w, w * 4
        for si, depth in enumerate(self.layers):
            stage_se = se_ratio if (se_stages is None or se_stages[si]) else 0.0
            stage_db = (si + 1) in tuple(dropblock_stages) and self.dropblock_keep_prob < 1.0
            names = []
            for bi in range(depth):
                name = f"layer{si + 1}_block{bi}"
                setattr(self, name, Bottleneck(
                    cin, ch, stride=2 if (bi == 0 and si > 0) else 1, version=version,
                    cardinality=cardinality, base_width=base_width, se_ratio=stage_se,
                    norm=kind, weight_standardization=weight_standardization,
                    avg_down=avg_down, with_relu=with_relu, dy_relu=dy,
                    use_dropblock=stage_db, dropblock_size=dropblock_block_size, dtype=dtype,
                    device=device))
                names.append(name)
                cin = ch
            self._stages.append((si + 1, stage_db, names))
            ch *= 2
        if version == "v2":
            self.bn_final = norm_(cin)
        elif version == "d" and dy is not None:
            self.final_act = act(cin)
        for pi, dim in enumerate(proj_dims):
            setattr(self, f"proj{pi + 1}", Dense(cin, int(dim), dtype=dtype, device=device))
            cin = int(dim)
        self.n_proj = len(tuple(proj_dims))
        self.num_features = cin

    def _act(self, name: str, h: torch.Tensor) -> torch.Tensor:
        m = getattr(self, name, None) if name else None
        return F.relu(h) if m is None else m(h)

    def forward(self, x: torch.Tensor, start_layer: int = 0, progress=1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``progress``: the DropBlock anneal's position in [0, 1] (a fp32
        device tensor inside a captured step); ``generator``: the DropBlock
        draws' generator, which a train-mode forward through a DropBlock
        stage needs."""
        if start_layer:
            raise ValueError("the ResNet has no cached-prefix cut (start_layer)")
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for conv_name, norm_name, act_name in self._stem:
            x = getattr(self, norm_name)(getattr(self, conv_name)(x))
            if act_name is not None:
                x = self._act(act_name, x)
        if self.stem_pool:
            x = F.max_pool2d(x, 3, 2, 1)
        for stage, on, names in self._stages:
            keep = (scheduled_keep_prob(stage_keep_prob(self.dropblock_keep_prob, stage),
                                        progress) if on else None)
            for name in names:
                x = getattr(self, name)(x, keep, generator)
        if self.version == "v2":
            x = F.relu(self.bn_final(x))
        elif self.version == "d":
            x = self._act("final_act", x)
        feats = x.mean(dim=(2, 3))
        for pi in range(self.n_proj):
            if self.proj_dropout > 0:
                if self.training and generator is None:
                    raise ValueError("a train-mode forward through the projection's dropout "
                                     "needs its generator")
                if self.training:
                    keep = _dist.draw_rows(lambda s: torch.rand(s, generator=generator,
                                                                device=feats.device),
                                           feats.shape) >= self.proj_dropout
                    feats = torch.where(keep, feats / (1.0 - self.proj_dropout),
                                        torch.zeros_like(feats))
            feats = getattr(self, f"proj{pi + 1}")(feats)
        return feats


def resnet50(**kw) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(layers=(3, 4, 23, 3), **kw)


def resnext50_32x4d(**kw) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), cardinality=32, base_width=4, **kw)


def resnext101_64x4d(**kw) -> ResNet:
    return ResNet(layers=(3, 4, 23, 3), cardinality=64, base_width=4, **kw)


def bit_resnet50(**kw) -> ResNet:
    """BiT-R50: pre-activation v2, GroupNorm, weight-standardized convs."""
    return ResNet(layers=(3, 4, 6, 3), version="v2", norm="gn", weight_standardization=True,
                  **kw)


def se_resnext50_32x4d(**kw) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), cardinality=32, base_width=4, se_ratio=1.0 / 16.0, **kw)
