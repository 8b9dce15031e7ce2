"""The Vision Transformer, CLIP style (counterpart of ``peft_vit_tpu/models/vit.py``).

conv1 patch embed (VALID, stride = patch, no bias) -> class token and
positional embedding -> ``ln_pre`` -> QuickGELU blocks -> ``ln_post`` on
the class token -> ``@ proj``.  Images are NHWC, as in the JAX package.
Weights are stored in fp32 and cast to the compute ``dtype`` at use.
``int8`` / ``int8_train`` route the blocks' frozen GEMMs (``int8_targets``)
through the int8 path (``layers.Block``); ``patch_gemm`` computes the patch
embedding as one matrix product.  The timm style, prompts, the extra probe
block and int8 attention are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..peft.spec import PEFTSpec
from ..ops.int8 import INT8_TARGET_MODULES
from .layers import Block, LayerNorm


class PatchEmbed(nn.Conv2d):
    """The patch embedding of (B, H, W, 3) images -> (B, gh * gw, width)
    tokens, row-major over the grid: a convolution (VALID, stride = patch, no
    bias), its weight stored in fp32 and cast to the compute ``dtype`` at use.

    ``gemm=True`` (counterpart of the JAX ``_PatchEmbedGEMM``) computes the
    same contraction as one matrix product over the (3, patch, patch) axes of
    the patchified image.  The parameter is the convolution's either way, so
    checkpoints and converters see no difference."""

    def __init__(self, width: int, patch_size: int, dtype: torch.dtype, gemm: bool = False,
                 device=None):
        super().__init__(3, width, patch_size, stride=patch_size, bias=False,
                         device=device, dtype=torch.float32)
        self.compute_dtype = dtype
        self.gemm = gemm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if not self.gemm:
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
            # (B, width, gh, gw) -> (B, gh*gw, width)
            y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride)
            return y.flatten(2).transpose(1, 2)
        b, hh, ww, c = x.shape
        p = self.kernel_size[0]
        gh, gw = hh // p, ww // p
        # (B, gh, p, gw, p, C) -> (B, gh*gw, C*p*p), the weight's (C, p, p) order
        patches = x.to(dt).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
        return torch.matmul(patches.reshape(b, gh * gw, c * p * p),
                            self.weight.to(dt).reshape(self.out_channels, -1).t())


class VisionTransformer(nn.Module):
    def __init__(
        self,
        image_size: int = 224,
        patch_size: int = 16,
        width: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp_ratio: float = 4.0,
        output_dim: Optional[int] = None,
        spec: PEFTSpec = PEFTSpec(),
        drop_path_rate: float = 0.0,
        ln_fp32: bool = True,
        int8: bool = False,
        int8_train: bool = False,
        int8_attn: bool = False,
        int8_attn_pv: bool = False,
        int8_targets: Sequence[str] = INT8_TARGET_MODULES,
        patch_gemm: bool = False,
        softmax_fp32: bool = True,
        attn_batch_chunk: int = 0,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        """``drop_path_rate`` is the last block's stochastic-depth rate: block
        i of L gets ``linspace(0, rate, L)[i]``, drawn in training mode from
        ``generator``.  ``int8``: int8 GEMMs on eval forwards; ``int8_train``:
        on training forwards too (see ``layers.Block``).  ``softmax_fp32`` and
        ``attn_batch_chunk`` go to every block's attention."""
        super().__init__()
        self.dtype = self.compute_dtype = dtype
        self.num_features = output_dim if output_dim is not None else width
        g = image_size // patch_size
        pkw = dict(device=device, dtype=torch.float32)
        self.conv1 = PatchEmbed(width, patch_size, dtype, gemm=patch_gemm, device=device)
        self.class_embedding = nn.Parameter(torch.randn(width, **pkw) * width**-0.5)
        self.positional_embedding = nn.Parameter(torch.randn(g * g + 1, width, **pkw) * 0.01)
        self.ln_pre = LayerNorm(width, compute_fp32=ln_fp32, device=device)
        dpr = np.linspace(0.0, drop_path_rate, max(layers, 1))
        self.blocks = nn.ModuleList(
            Block(width, heads, mlp_ratio=mlp_ratio, act="quick_gelu", spec=spec,
                  drop_path=float(dpr[i]), ln_fp32=ln_fp32, int8=int8, int8_train=int8_train,
                  int8_attn=int8_attn, int8_attn_pv=int8_attn_pv, int8_targets=int8_targets,
                  softmax_fp32=softmax_fp32, attn_batch_chunk=attn_batch_chunk, dtype=dtype,
                  generator=generator, device=device)
            for i in range(layers)
        )
        self.ln_post = LayerNorm(width, compute_fp32=ln_fp32, device=device)
        if output_dim is not None:
            self.proj = nn.Parameter(torch.randn(width, output_dim, **pkw) * width**-0.5)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, num_features) pooled features."""
        b = x.shape[0]
        dt = self.dtype
        x = self.conv1(x)
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x)
        for block in self.blocks:
            x = block(x)
        pooled = self.ln_post(x[:, 0, :])
        if self.proj is not None:
            pooled = pooled @ self.proj.to(dt)
        return pooled
