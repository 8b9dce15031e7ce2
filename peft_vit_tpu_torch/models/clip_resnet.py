"""CLIP's ModifiedResNet visual tower, RN50 / RN101 / RN50x4 / RN50x16
(counterpart of ``peft_vit_tpu/models/clip_resnet.py``; the reference's
evaluation/model.py:13-160).

Against a torchvision ResNet:

* a 3-conv stem (a stride-2 3x3, two 3x3) with a 2x2 average pool in place
  of the maxpool;
* anti-aliased strides: a stride > 1 bottleneck pools (k x k average) after
  ``conv2``, and its shortcut is that pool, then a stride-1 1x1 conv and BN;
* the pool is one multi-head attention over the grid with a prepended mean
  token and a learned positional embedding, read out at the mean token
  (``AttentionPool2d``).  As in the JAX module only the mean token's query
  row is computed: (B, H, 1, 64) against (B, H, N + 1, 64) keys, the scores
  in fp32, a plain softmax.  It is no shape of the attention kernels (K1
  takes q, k and v of one length), and the JAX module computes it outside
  any Pallas kernel too.

The BatchNorms are ``resnet.BatchNorm2d`` (flax's statistics, ``bn_mean`` /
``bn_var``) and the convolutions ``resnet.Conv2d``.  Module names follow the
JAX module (``conv1`` / ``bn1`` ... ``layer<s>_<i>``, ``downsample_conv`` /
``downsample_bn``, ``attnpool`` with ``q_proj`` / ``k_proj`` / ``v_proj`` /
``c_proj``), so that ``convert.params_from_jax`` maps the JAX tree and
``convert.clip_rn_state_dict`` an OpenAI checkpoint.  Images arrive NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense
from .resnet import BatchNorm2d, Conv2d


class ClipBottleneck(nn.Module):
    """model.py:13-56: stride-1 convs; a stride > 1 is an average pool after
    ``conv2``, and the shortcut is pool -> 1x1 conv -> BN."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 1, dtype=dtype, device=device)
        self.bn1 = BatchNorm2d(planes, device)
        self.conv2 = Conv2d(planes, planes, 3, dtype=dtype, device=device)
        self.bn2 = BatchNorm2d(planes, device)
        self.conv3 = Conv2d(planes, out, 1, dtype=dtype, device=device)
        self.bn3 = BatchNorm2d(out, device)
        self.has_downsample = stride > 1 or inplanes != out
        if self.has_downsample:
            self.downsample_conv = Conv2d(inplanes, out, 1, dtype=dtype, device=device)
            self.downsample_bn = BatchNorm2d(out, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        identity = x
        if self.has_downsample:
            identity = x if self.stride == 1 else F.avg_pool2d(x, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """model.py:59-95: the mean token prepended to the (B, C, gh, gw) grid,
    the positional embedding added, and one multi-head attention read out at
    the mean token only, then ``c_proj``."""

    def __init__(self, grid: int, embed_dim: int, num_heads: int, output_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.positional_embedding = nn.Parameter(
            torch.randn(grid * grid + 1, embed_dim, device=device) / embed_dim**0.5)
        self.q_proj = Dense(embed_dim, embed_dim, dtype=dtype, device=device)
        self.k_proj = Dense(embed_dim, embed_dim, dtype=dtype, device=device)
        self.v_proj = Dense(embed_dim, embed_dim, dtype=dtype, device=device)
        self.c_proj = Dense(embed_dim, output_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, N, C)
        n = tokens.shape[1]
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        h = self.num_heads
        hd = c // h
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, h, hd).transpose(1, 2)
        k = self.k_proj(tokens).reshape(b, n + 1, h, hd).transpose(1, 2)
        v = self.v_proj(tokens).reshape(b, n + 1, h, hd).transpose(1, 2)
        # the products of the compute dtype's values, summed in fp32 (the
        # JAX einsum's preferred_element_type; float64 for a float64 model)
        dt = torch.promote_types(q.dtype, torch.float32)
        scores = torch.matmul(q.to(dt), k.to(dt).transpose(2, 3)) * hd**-0.5
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    """The CLIP RN visual tower (model.py:96-160): (B, H, W, 3) images ->
    the attention-pooled (B, output_dim) embedding.  ``heads`` 0 is
    width * 32 // 64, the OpenAI convention."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_dim: int = 1024,
                 heads: int = 0, image_size: int = 224, width: int = 64,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.layers = tuple(int(n) for n in layers)
        self.dtype = dtype
        self.num_features = int(output_dim)
        w = int(width)
        self.conv1 = Conv2d(3, w // 2, 3, 2, dtype=dtype, device=device)
        self.bn1 = BatchNorm2d(w // 2, device)
        self.conv2 = Conv2d(w // 2, w // 2, 3, dtype=dtype, device=device)
        self.bn2 = BatchNorm2d(w // 2, device)
        self.conv3 = Conv2d(w // 2, w, 3, dtype=dtype, device=device)
        self.bn3 = BatchNorm2d(w, device)
        self._blocks = []
        inplanes = w
        for stage, blocks in enumerate(self.layers):
            planes = w * 2**stage
            for i in range(blocks):
                name = f"layer{stage + 1}_{i}"
                setattr(self, name, ClipBottleneck(
                    inplanes, planes, 2 if (stage > 0 and i == 0) else 1, dtype, device))
                self._blocks.append(name)
                inplanes = planes * ClipBottleneck.expansion
        self.attnpool = AttentionPool2d(int(image_size) // 32, w * 32, int(heads) or w * 32 // 64,
                                        int(output_dim), dtype, device)

    def forward(self, x: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
        if start_layer:
            raise ValueError("the ModifiedResNet has no cached-prefix cut (start_layer)")
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for name in self._blocks:
            x = getattr(self, name)(x)
        return self.attnpool(x)
