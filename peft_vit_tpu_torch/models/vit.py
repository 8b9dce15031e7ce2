"""The Vision Transformer, CLIP style (counterpart of ``peft_vit_tpu/models/vit.py``).

conv1 patch embed (VALID, stride = patch, no bias) -> class token and
positional embedding -> ``ln_pre`` -> QuickGELU blocks -> ``ln_post`` on
the class token -> ``@ proj``.  Images are NHWC, as in the JAX package.
Weights are stored in fp32 and cast to the compute ``dtype`` at use.
``int8`` / ``int8_train`` route the blocks' frozen GEMMs (``int8_targets``)
through the int8 path (``layers.Block``); ``patch_gemm`` computes the patch
embedding as one matrix product.

Beyond the blocks' own hooks (``layers``):

* VPT prompt tokens (``spec.prompt_tokens``): ``prompt_embeddings`` sit
  between the class token and the patches and carry no positional
  embedding; with ``spec.prompt_deep`` the ``deep_prompt_embeddings`` of
  block i - 1 overwrite the prompt rows before each block i of 1 ... L - 1;
* ``spec.extra_block`` (the transformer probe): an (L + 1)-th ``Block``,
  ``blocks.<L>`` (``blocks_<L>`` in the JAX tree), after the L blocks of
  ``layers``.

The timm style and int8 attention are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..peft.spec import PEFTSpec
from ..ops.int8 import INT8_TARGET_MODULES
from .layers import Block, LayerNorm, _cell


class _PatchConv(torch.autograd.Function):
    """``F.conv2d(x, w, stride=p)`` over non-overlapping p x p patches (NCHW
    x, OIHW w), whose weight gradient is one matrix product of the
    cotangent with the patches: the same sums as the convolution's, in a
    fixed order.  cuDNN's weight-gradient algorithms may add with atomics,
    and a captured step that trains the patch embedding (the full
    fine-tune) must equal its eager run bit for bit.  The batching rule
    folds a sweep round's cells into the batch for a shared weight and runs
    a batched (trainable) weight one cell at a time."""

    @staticmethod
    def forward(x, w, p):
        return F.conv2d(x, w, None, p)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, p = inputs
        need_dx, need_dw = ctx.needs_input_grad[:2]
        ctx.p, ctx.x_shape = p, x.shape
        ctx.save_for_backward(x if need_dw else None, w if need_dx else None)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = ctx.p
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(ctx.x_shape, w, g, p)
        if ctx.needs_input_grad[1]:
            b, c, hh, ww = x.shape
            patches = x.reshape(b, c, hh // p, p, ww // p, p).permute(0, 2, 4, 1, 3, 5)
            g2d = g.permute(0, 2, 3, 1).reshape(-1, g.shape[1])
            dw = g2d.t().matmul(patches.reshape(g2d.shape[0], -1)).reshape(-1, c, p, p)
        return dx, dw, None

    @staticmethod
    def vmap(info, in_dims, x, w, p):
        x_dim, w_dim = in_dims[:2]
        if w_dim is None:
            x = x.movedim(x_dim, 0)
            out = _PatchConv.apply(x.reshape(-1, *x.shape[2:]), w, p)
            return out.unflatten(0, (info.batch_size, -1)), 0
        return torch.stack([_PatchConv.apply(_cell(x, x_dim, i), _cell(w, w_dim, i), p)
                            for i in range(info.batch_size)]), 0


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
            y = _PatchConv.apply(x.to(dt), self.weight.to(dt), self.kernel_size[0])
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
        i of L (L + 1 with the extra block) gets ``linspace(0, rate, L)[i]``, drawn in training mode from
        ``generator``.  ``int8``: int8 GEMMs on eval forwards; ``int8_train``:
        on training forwards too (see ``layers.Block``).  ``softmax_fp32`` and
        ``attn_batch_chunk`` go to every block's attention."""
        super().__init__()
        self.dtype = self.compute_dtype = dtype
        self.layers = layers
        self.num_prompts = spec.prompt_tokens
        self.num_features = output_dim if output_dim is not None else width
        g = image_size // patch_size
        pkw = dict(device=device, dtype=torch.float32)
        self.conv1 = PatchEmbed(width, patch_size, dtype, gemm=patch_gemm, device=device)
        self.class_embedding = nn.Parameter(torch.randn(width, **pkw) * width**-0.5)
        self.positional_embedding = nn.Parameter(torch.randn(g * g + 1, width, **pkw) * 0.01)
        if self.num_prompts > 0:
            self.prompt_embeddings = nn.Parameter(torch.randn(self.num_prompts, width, **pkw)
                                                  * 0.02)
            if spec.prompt_deep and layers > 1:
                self.deep_prompt_embeddings = nn.Parameter(
                    torch.randn(layers - 1, self.num_prompts, width, **pkw) * 0.02)
        self.ln_pre = LayerNorm(width, compute_fp32=ln_fp32, device=device)
        total = layers + (1 if spec.extra_block else 0)
        dpr = np.linspace(0.0, drop_path_rate, max(total, 1))
        self.blocks = nn.ModuleList(
            Block(width, heads, mlp_ratio=mlp_ratio, act="quick_gelu", spec=spec, layer_idx=i,
                  grid_size=g, n_prefix=1 + self.num_prompts, drop_path=float(dpr[i]),
                  ln_fp32=ln_fp32, int8=int8, int8_train=int8_train, int8_attn=int8_attn,
                  int8_attn_pv=int8_attn_pv, int8_targets=int8_targets,
                  softmax_fp32=softmax_fp32, attn_batch_chunk=attn_batch_chunk, dtype=dtype,
                  generator=generator, device=device)
            for i in range(total)
        )
        self.ln_post = LayerNorm(width, compute_fp32=ln_fp32, device=device)
        if output_dim is not None:
            self.proj = nn.Parameter(torch.randn(width, output_dim, **pkw) * width**-0.5)
        else:
            self.proj = None

    def _prompts(self, x: torch.Tensor, prompts: torch.Tensor, replace: bool) -> torch.Tensor:
        """``prompts`` (P, width) after the class token of every row of ``x``:
        inserted, or in place of the rows there (``replace``)."""
        p = prompts.to(self.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([x[:, :1], p, x[:, 1 + (self.num_prompts if replace else 0):]], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, num_features) pooled features."""
        b = x.shape[0]
        dt = self.dtype
        x = self.conv1(x)
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        if self.num_prompts > 0:
            x = self._prompts(x, self.prompt_embeddings, replace=False)
        x = self.ln_pre(x)
        deep = getattr(self, "deep_prompt_embeddings", None)
        for i, block in enumerate(self.blocks):
            if deep is not None and 0 < i < self.layers:
                x = self._prompts(x, deep[i - 1], replace=True)
            x = block(x)
        pooled = self.ln_post(x[:, 0, :])
        if self.proj is not None:
            pooled = pooled @ self.proj.to(dt)
        return pooled
