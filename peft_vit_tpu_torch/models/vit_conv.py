"""ViT variants with residual attention scores and conv token mixers
(counterpart of ``peft_vit_tpu/models/vit_conv.py``): the reference's
``cls_vit_cswin.py`` (a plain global-attention ViT with LePE's depthwise
``get_v`` and the ``res_score`` chain, no cross-shaped windows) and
``cls_vit_conv.py`` (blocks with attention / MLP / the pw-glu-dw-bn-swish-pw
conv mixer, ``ADD_CLS`` adding the mixer's pooled response to the class
token).

The attention here stays plain PyTorch: fp32 scores and softmax as in the
JAX module, because ``res_score`` carries each block's (B, H, N, N) scores
into the next, which no flash kernel forms (the JAX module leaves it to XLA
likewise).  So K1-K7 launch nothing on this tower.

The mixer's BatchNorm is ``resnet.BatchNorm2d`` (flax's momentum 0.9, the
statistics in the buffers ``bn_mean`` / ``bn_var``, written by a train-mode
forward into the tensors ``functional_call`` gives it); the depthwise 3x3
convolutions (the mixer's ``dw``, LePE's ``get_v``) are ``resnet.conv2d``
(cuDNN flags scoped to the call, TF32 off for fp32), the mixer's 1x1
convolutions one GEMM over the channels, the patch embedding
``vit.PatchEmbed`` (a fixed-order weight gradient).  Drop path draws from the forward's explicit
``generator``.  Images are NHWC; module names are the JAX tree's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm, Mlp
from .resnet import BatchNorm2d, Conv2d, _lecun_normal_, conv2d
from .swin import _drop_path
from .vit import PatchEmbed


class ConvMixer(nn.Module):
    """pw-glu-dw-bn-swish-pw over the (B, g, g, D) patch grid
    (cls_vit_conv.py:199-216): 1x1 ``pw1`` -> exact GELU -> depthwise 3x3
    ``dw`` -> ``bn`` -> swish -> 1x1 ``pw2``, bias-free convs; NHWC in and
    out.  The 1x1 convs keep their OIHW conv weights and run as one matrix
    product over the channels of the NHWC grid (the same sums): cuDNN's
    weight gradient of these 1x1 convs in fp32 did not repeat between a
    captured step and its eager run on the H100, a GEMM's does."""

    def __init__(self, dim: int, ratio: float = 1.0, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        hidden = int(dim * ratio)
        self.pw1 = Conv2d(dim, hidden, 1, dtype=dtype, device=device)
        self.dw = Conv2d(hidden, hidden, 3, groups=hidden, dtype=dtype, device=device)
        self.bn = BatchNorm2d(hidden, device=device)
        self.pw2 = Conv2d(hidden, dim, 1, dtype=dtype, device=device)
        self.compute_dtype = dtype

    def _pointwise(self, conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), conv.weight.to(dt).flatten(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self._pointwise(self.pw1, x)).permute(0, 3, 1, 2)
        h = F.silu(self.bn(self.dw(h))).permute(0, 2, 3, 1)
        return self._pointwise(self.pw2, h)


class DepthwiseConvBias(nn.Module):
    """LePE's ``get_v``: a 3x3 depthwise convolution with a bias (SAME
    padding) of (B, g, g, D) NHWC tokens, through ``resnet.conv2d``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(_lecun_normal_(torch.empty(dim, 1, 3, 3, device=device), 9))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), 1, 1, x.shape[-1])
        return y.permute(0, 2, 3, 1) + self.bias.to(dt)


class ScoreAttention(nn.Module):
    """Global multi-head attention with LePE and residual attention scores
    (cls_vit_cswin.py Attention:57-117): fp32 scores ``q k^T / sqrt(hd)``,
    plus the previous block's scores under ``res_score``, an fp32 softmax;
    ``ref_qkv_scramble`` takes q, k and v from the executed reference's
    flat (B, N, 3, H, hd) view of the permuted projection (get_v still reads
    the clean v).  Returns the output and the scores to carry."""

    def __init__(self, width: int, heads: int, grid_size: int, n_prefix: int = 1,
                 lepe: bool = False, res_score: bool = False, ref_qkv_scramble: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.heads, self.grid, self.n_prefix = heads, grid_size, n_prefix
        self.lepe, self.res_score, self.ref_qkv_scramble = lepe, res_score, ref_qkv_scramble
        self.compute_dtype = dtype
        self.qkv = Dense(width, 3 * width, dtype=dtype, device=device)
        if lepe:
            self.get_v = DepthwiseConvBias(width, dtype=dtype, device=device)
        self.out_proj = Dense(width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, n, d = x.shape
        h = self.heads
        hd = d // h
        qkv = self.qkv(x)
        q, k, v = qkv.chunk(3, dim=-1)
        if self.ref_qkv_scramble:
            scr = qkv.reshape(b, n, 3, d).permute(2, 0, 1, 3).reshape(b, n, 3, h, hd)
            qh, kh, vh = scr.permute(2, 0, 3, 1, 4).unbind(0)
        else:
            qh, kh, vh = (t.reshape(b, n, h, hd).transpose(1, 2) for t in (q, k, v))
        scores = torch.matmul(qh.to(torch.float32), kh.to(torch.float32).transpose(-1, -2))
        scores = scores * hd ** -0.5
        if self.res_score and prev is not None:
            scores = scores + prev
        attn = torch.softmax(scores, dim=-1).to(self.compute_dtype)
        out = torch.matmul(attn, vh.to(self.compute_dtype)).transpose(1, 2).reshape(b, n, d)
        if self.lepe:
            g, p = self.grid, self.n_prefix
            lepe = self.get_v(v[:, p:, :].reshape(b, g, g, d)).reshape(b, g * g, d)
            out = torch.cat([out[:, :p], out[:, p:] + lepe.to(out.dtype)], dim=1)
        return self.out_proj(out), (scores if self.res_score else None)


class ConvViTBlock(nn.Module):
    """Pre-LN block with optional attention, MLP and conv-mixer branches
    (cls_vit_conv.py:218-240): the mixer runs on ``ln_3`` of the patch
    tokens with a residual on the normalised grid; the prefix tokens become
    ``ln_3``'s, plus the mixer's mean response with ``add_cls``."""

    def __init__(self, width: int, heads: int, grid_size: int, mlp_ratio: float = 4.0,
                 n_prefix: int = 1, has_attn: bool = True, has_mlp: bool = True,
                 has_conv: bool = False, add_cls: bool = False, conv_ratio: float = 1.0,
                 lepe: bool = False, res_score: bool = False, ref_qkv_scramble: bool = False,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.grid, self.n_prefix, self.add_cls = grid_size, n_prefix, add_cls
        self.has_attn, self.has_mlp, self.has_conv = has_attn, has_mlp, has_conv
        self.drop_path = float(drop_path)
        if has_attn:
            self.ln_1 = LayerNorm(width, device=device)
            self.attn = ScoreAttention(width, heads, grid_size, n_prefix=n_prefix, lepe=lepe,
                                       res_score=res_score, ref_qkv_scramble=ref_qkv_scramble,
                                       dtype=dtype, device=device)
        if has_mlp:
            self.ln_2 = LayerNorm(width, device=device)
            self.mlp = Mlp(width, int(width * mlp_ratio), act="gelu", dtype=dtype, device=device)
        if has_conv:
            self.ln_3 = LayerNorm(width, device=device)
            self.conv = ConvMixer(width, conv_ratio, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        rate, training = self.drop_path, self.training
        if self.has_attn:
            a, prev = self.attn(self.ln_1(x), prev)
            x = x + _drop_path(a, rate, training, generator)
        if self.has_mlp:
            x = x + _drop_path(self.mlp(self.ln_2(x)), rate, training, generator)
        if self.has_conv:
            g, p = self.grid, self.n_prefix
            b, _, d = x.shape
            x_ln = self.ln_3(x)
            grid = x_ln[:, p:, :].reshape(b, g, g, d)
            res = _drop_path(self.conv(grid), rate, training, generator)
            new_grid = (grid + res).reshape(b, g * g, d)
            if p > 0:
                cls = x_ln[:, :p, :]
                if self.add_cls:
                    cls = cls + res.mean(dim=(1, 2))[:, None, :]
                x = torch.cat([cls, new_grid], dim=1)
            else:
                x = new_grid
        return x, prev


class ConvViT(nn.Module):
    """The ConvViT / CSwin-named tower: the biased patch embedding,
    ``norm_embed``, a zero class token, the positional embedding (std 0.02),
    the blocks, ``ln_post``; pooled as the class token, or the tokens' mean
    without one (cls_vit_cswin.py:419-423)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, width: int = 384,
                 layers: int = 8, heads: int = 6, mlp_ratio: float = 4.0,
                 use_cls_token: bool = True, norm_embed: bool = False, has_attn: bool = True,
                 has_mlp: bool = True, has_conv: bool = False, add_cls: bool = False,
                 conv_ratio: float = 1.0, lepe: bool = False, res_score: bool = False,
                 ref_qkv_scramble: bool = False, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        g = image_size // patch_size
        self.grid, self.width, self.layers = g, width, layers
        self.use_cls_token, self.use_norm_embed = bool(use_cls_token), bool(norm_embed)
        self.drop_path_rate = float(drop_path_rate)
        self.compute_dtype = dtype
        self.patch_embed = PatchEmbed(width, patch_size, dtype, bias=True, device=device)
        if self.use_norm_embed:
            self.norm_embed = LayerNorm(width, device=device)
        n_prefix = 1 if self.use_cls_token else 0
        if self.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(width, device=device))
        self.pos_embed = nn.Parameter(torch.randn(g * g + n_prefix, width, device=device) * 0.02)
        dpr = np.linspace(0.0, self.drop_path_rate, max(layers, 1))
        self.blocks = nn.ModuleList(
            ConvViTBlock(width, heads, g, mlp_ratio=mlp_ratio, n_prefix=n_prefix,
                         has_attn=has_attn, has_mlp=has_mlp, has_conv=has_conv,
                         add_cls=add_cls and self.use_cls_token, conv_ratio=conv_ratio,
                         lepe=lepe, res_score=res_score, ref_qkv_scramble=ref_qkv_scramble,
                         drop_path=float(dpr[i]), dtype=dtype, device=device)
            for i in range(layers))
        self.ln_post = LayerNorm(width, device=device)
        self.num_features = width

    def forward(self, x: torch.Tensor, start_layer: int = 0, progress=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the drop path's draws in training mode;
        ``start_layer`` must be 0 and ``progress`` is not read."""
        if start_layer:
            raise ValueError("the ConvViT tower is not cut at a block (start_layer must be 0)")
        b = x.shape[0]
        dt = self.compute_dtype
        x = self.patch_embed(x.to(dt))
        if self.use_norm_embed:
            x = self.norm_embed(x)
        if self.use_cls_token:
            x = torch.cat([self.cls_token.to(dt).expand(b, 1, self.width), x], dim=1)
        x = x + self.pos_embed.to(dt)[None]
        prev = None
        for block in self.blocks:
            x, prev = block(x, prev, generator)
        x = self.ln_post(x)
        return x[:, 0, :] if self.use_cls_token else x.mean(dim=1)
