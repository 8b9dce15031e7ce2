"""The Vision Transformer (counterpart of ``peft_vit_tpu/models/vit.py``), in
the JAX module's two styles:

* ``style="clip"``: conv1 patch embed (VALID, stride = patch, no bias) ->
  class token and positional embedding -> ``ln_pre`` -> QuickGELU blocks ->
  ``ln_post`` on the class token -> ``@ proj``;
* ``style="timm"`` (the supervised ViT of the full-shot trainer): a biased
  patch embed, a zero-initialised class token and a positional embedding of
  std 0.02, no ``ln_pre``, exact-erf GELU blocks, ``ln_post`` over every
  token, then the class token, or the tokens' mean with
  ``use_cls_token=False`` (no class token; the positional embedding has
  g * g rows).  No projection: ``output_dim`` is ignored.  The LayerNorms
  keep the JAX module's settings (eps 1e-5), not timm's.

Images are NHWC, as in the JAX package.
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
  ``layers``;
* ``int8_attn`` / ``int8_attn_pv``: every block's int8 attention scores;
* ``start_layer`` / ``stop_layer``: the tower cut at a block, for the
  cached-prefix sweep (``engine.cached``).
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
    """``F.conv2d(x, w, b, stride=p)`` over non-overlapping p x p patches
    (NCHW x, OIHW w; the bias ``b`` optional, after ``p``), whose weight
    gradient is one matrix product of the cotangent with the patches and
    whose bias gradient is one sum of the cotangent's rows: the same sums as
    the convolution's, in a fixed order.  cuDNN's weight-gradient algorithms
    may add with atomics, and a captured step that trains the patch
    embedding (the full fine-tune) must equal its eager run bit for bit.  The
    batching rule folds a sweep round's cells into the batch for a shared
    weight and runs a batched (trainable) weight one cell at a time."""

    @staticmethod
    def forward(x, w, p, b=None):
        return F.conv2d(x, w, b, p)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, p = inputs[:3]
        need_dx, need_dw = ctx.needs_input_grad[:2]
        ctx.p, ctx.x_shape, ctx.n_inputs = p, x.shape, len(inputs)
        ctx.save_for_backward(x if need_dw else None, w if need_dx else None)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = ctx.p
        dx = dw = db = None
        g2d = g.permute(0, 2, 3, 1).reshape(-1, g.shape[1])
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(ctx.x_shape, w, g, p)
        if ctx.needs_input_grad[1]:
            n, c, hh, ww = x.shape
            patches = x.reshape(n, c, hh // p, p, ww // p, p).permute(0, 2, 4, 1, 3, 5)
            dw = g2d.t().matmul(patches.reshape(g2d.shape[0], -1)).reshape(-1, c, p, p)
        if ctx.n_inputs > 3 and ctx.needs_input_grad[3]:
            db = g2d.sum(0)
        return (dx, dw, None, db)[:ctx.n_inputs]

    @staticmethod
    def vmap(info, in_dims, x, w, p, b=None):
        x_dim, w_dim = in_dims[:2]
        b_dim = in_dims[3] if len(in_dims) > 3 else None
        if w_dim is None and b_dim is None:
            x = x.movedim(x_dim, 0)
            out = _PatchConv.apply(x.reshape(-1, *x.shape[2:]), w, p, b)
            return out.unflatten(0, (info.batch_size, -1)), 0
        return torch.stack([_PatchConv.apply(_cell(x, x_dim, i), _cell(w, w_dim, i), p,
                                             _cell(b, b_dim, i))
                            for i in range(info.batch_size)]), 0


class PatchEmbed(nn.Conv2d):
    """The patch embedding of (B, H, W, 3) images -> (B, gh * gw, width)
    tokens, row-major over the grid: a convolution (VALID, stride = patch,
    a zero-initialised bias with ``bias=True``, the timm style), its weights
    stored in fp32 and cast to the compute ``dtype`` at use.

    ``gemm=True`` (counterpart of the JAX ``_PatchEmbedGEMM``) computes the
    same contraction as one matrix product over the (3, patch, patch) axes of
    the patchified image.  The parameters are the convolution's either way,
    so checkpoints and converters see no difference."""

    def __init__(self, width: int, patch_size: int, dtype: torch.dtype, gemm: bool = False,
                 bias: bool = False, device=None):
        super().__init__(3, width, patch_size, stride=patch_size, bias=bias,
                         device=device, dtype=torch.float32)
        if bias:
            nn.init.zeros_(self.bias)
        self.compute_dtype = dtype
        self.gemm = gemm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        if not self.gemm:
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
            # (B, width, gh, gw) -> (B, gh*gw, width)
            y = _PatchConv.apply(x.to(dt), self.weight.to(dt), self.kernel_size[0], b)
            return y.flatten(2).transpose(1, 2)
        bsz, hh, ww, c = x.shape
        p = self.kernel_size[0]
        gh, gw = hh // p, ww // p
        # (B, gh, p, gw, p, C) -> (B, gh*gw, C*p*p), the weight's (C, p, p) order
        patches = x.to(dt).reshape(bsz, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
        out = torch.matmul(patches.reshape(bsz, gh * gw, c * p * p),
                           self.weight.to(dt).reshape(self.out_channels, -1).t())
        return out if b is None else out + b


class VisionTransformer(nn.Module):
    def __init__(
        self,
        image_size: int = 224,
        patch_size: int = 16,
        width: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp_ratio: float = 4.0,
        style: str = "clip",
        use_cls_token: bool = True,
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
        """``style``: "clip" or "timm" (see the module docstring);
        ``use_cls_token`` applies to the timm style only.
        ``drop_path_rate`` is the last block's stochastic-depth rate: block
        i of L (L + 1 with the extra block) gets ``linspace(0, rate, L)[i]``, drawn in training mode from
        ``generator``.  ``int8``: int8 GEMMs on eval forwards; ``int8_train``:
        on training forwards too (see ``layers.Block``).  ``softmax_fp32`` and
        ``attn_batch_chunk`` go to every block's attention."""
        super().__init__()
        if style not in ("clip", "timm"):
            raise ValueError(f"unknown ViT style {style!r}")
        clip = style == "clip"
        self.style = style
        self.use_cls = bool(use_cls_token) or clip
        self.dtype = self.compute_dtype = dtype
        self.layers = layers
        self.num_prompts = spec.prompt_tokens
        self.num_features = output_dim if (clip and output_dim is not None) else width
        g = image_size // patch_size
        pkw = dict(device=device, dtype=torch.float32)
        self.conv1 = PatchEmbed(width, patch_size, dtype, gemm=patch_gemm, bias=not clip,
                                device=device)
        n_cls = 1 if self.use_cls else 0
        if self.use_cls:
            init = torch.randn(width, **pkw) * width**-0.5 if clip else torch.zeros(width, **pkw)
            self.class_embedding = nn.Parameter(init)
        self.positional_embedding = nn.Parameter(
            torch.randn(g * g + n_cls, width, **pkw) * (0.01 if clip else 0.02))
        if self.num_prompts > 0:
            self.prompt_embeddings = nn.Parameter(torch.randn(self.num_prompts, width, **pkw)
                                                  * 0.02)
            if spec.prompt_deep and layers > 1:
                self.deep_prompt_embeddings = nn.Parameter(
                    torch.randn(layers - 1, self.num_prompts, width, **pkw) * 0.02)
        if clip:
            self.ln_pre = LayerNorm(width, compute_fp32=ln_fp32, device=device)
        total = layers + (1 if spec.extra_block else 0)
        dpr = np.linspace(0.0, drop_path_rate, max(total, 1))
        self.blocks = nn.ModuleList(
            Block(width, heads, mlp_ratio=mlp_ratio, act="quick_gelu" if clip else "gelu",
                  spec=spec, layer_idx=i, grid_size=g, n_prefix=n_cls + self.num_prompts,
                  drop_path=float(dpr[i]),
                  ln_fp32=ln_fp32, int8=int8, int8_train=int8_train, int8_attn=int8_attn,
                  int8_attn_pv=int8_attn_pv, int8_targets=int8_targets,
                  softmax_fp32=softmax_fp32, attn_batch_chunk=attn_batch_chunk, dtype=dtype,
                  generator=generator, device=device)
            for i in range(total)
        )
        self.ln_post = LayerNorm(width, compute_fp32=ln_fp32, device=device)
        if clip and output_dim is not None:
            self.proj = nn.Parameter(torch.randn(width, output_dim, **pkw) * width**-0.5)
        else:
            self.proj = None

    def _prompts(self, x: torch.Tensor, prompts: torch.Tensor, replace: bool) -> torch.Tensor:
        """``prompts`` (P, width) after the class token (if any) of every row
        of ``x``: inserted, or in place of the rows there (``replace``)."""
        k0 = 1 if self.use_cls else 0
        p = prompts.to(self.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([x[:, :k0], p, x[:, k0 + (self.num_prompts if replace else 0):]], dim=1)

    def forward(self, x: torch.Tensor, start_layer: int = 0,
                stop_layer: Optional[int] = None) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, num_features) pooled features.

        ``start_layer`` > 0: ``x`` is the (B, N, width) token sequence after
        block ``start_layer - 1`` (the cached-prefix sweep: the frozen
        prefix computed once, cast to the compute dtype here), and the
        forward resumes at that block.  ``stop_layer``: the tokens after block
        ``stop_layer - 1``, without the head."""
        dt = self.dtype
        if start_layer > 0:
            x = x.to(dt)
        else:
            b = x.shape[0]
            x = self.conv1(x)
            if self.use_cls:
                cls = self.class_embedding.to(dt).expand(b, 1, -1)
                x = torch.cat([cls, x], dim=1)
            x = x + self.positional_embedding.to(dt)
            if self.num_prompts > 0:
                x = self._prompts(x, self.prompt_embeddings, replace=False)
            if self.style == "clip":
                x = self.ln_pre(x)
        deep = getattr(self, "deep_prompt_embeddings", None)
        end = len(self.blocks) if stop_layer is None else stop_layer
        for i in range(start_layer, end):
            if deep is not None and 0 < i < self.layers:
                x = self._prompts(x, deep[i - 1], replace=True)
            x = self.blocks[i](x)
        if stop_layer is not None:
            return x
        if self.style == "timm":
            x = self.ln_post(x)
            return x[:, 0, :] if self.use_cls else x.mean(dim=1)
        pooled = self.ln_post(x[:, 0, :])
        if self.proj is not None:
            pooled = pooled @ self.proj.to(dt)
        return pooled
