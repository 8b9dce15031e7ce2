"""The Vision Transformer, CLIP style (counterpart of ``peft_vit_tpu/models/vit.py``).

conv1 patch embed (VALID, stride = patch, no bias) -> class token and
positional embedding -> ``ln_pre`` -> QuickGELU blocks -> ``ln_post`` on
the class token -> ``@ proj``.  Images are NHWC, as in the JAX package.
The timm style, prompts and the extra probe block are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..peft.spec import PEFTSpec
from .layers import Block, LayerNorm


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
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.num_features = output_dim if output_dim is not None else width
        g = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False,
                               device=device, dtype=dtype)
        self.class_embedding = nn.Parameter(
            torch.randn(width, device=device, dtype=dtype) * width**-0.5)
        self.positional_embedding = nn.Parameter(
            torch.randn(g * g + 1, width, device=device, dtype=dtype) * 0.01)
        self.ln_pre = LayerNorm(width, device=device)
        self.blocks = nn.ModuleList(
            Block(width, heads, mlp_ratio=mlp_ratio, act="quick_gelu", spec=spec,
                  dtype=dtype, device=device)
            for _ in range(layers)
        )
        self.ln_post = LayerNorm(width, device=device)
        if output_dim is not None:
            self.proj = nn.Parameter(
                torch.randn(width, output_dim, device=device, dtype=dtype) * width**-0.5)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, num_features) pooled features."""
        b = x.shape[0]
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW
        # (B, width, gh, gw) -> (B, gh*gw, width), row-major over the grid
        x = self.conv1(x).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x)
        for block in self.blocks:
            x = block(x)
        pooled = self.ln_post(x[:, 0, :])
        if self.proj is not None:
            pooled = pooled @ self.proj.to(dt)
        return pooled
