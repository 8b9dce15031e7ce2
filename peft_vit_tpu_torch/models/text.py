"""The CLIP text transformer (counterpart of ``peft_vit_tpu/models/text.py``).

The token embedding, ``positional_embedding``, causal QuickGELU blocks,
``ln_final`` and ``text_projection``, the features taken at the highest
token id (the end token).  The text tower is frozen in every path of the
harness: it encodes the class prompts of the zero-shot classifier, of
``TRAIN.INIT_HEAD_WITH_TEXT_ENCODER`` and of the contrastive methods.  Each
block's attention takes the (H, N, N) causal bias in the compute dtype, so on
the card it runs the forward kernel's bias path (``ops.attention``).
Weights are stored in fp32 and cast to the compute ``dtype`` at use.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..peft.spec import PEFTSpec
from .layers import Block, LayerNorm


class Embed(nn.Module):
    """flax ``nn.Embed``: an (N, width) table ``embedding`` in fp32, rows
    looked up and cast to the compute ``dtype``."""

    def __init__(self, num: int, width: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.embedding = nn.Parameter(torch.randn(num, width, device=device) * 0.02)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids].to(self.compute_dtype)


class TextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, output_dim: int = 512,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = self.compute_dtype = dtype
        self.context_length = context_length
        self.layers = layers
        pkw = dict(device=device, dtype=torch.float32)
        self.token_embedding = Embed(vocab_size, width, dtype, device=device)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width, **pkw) * 0.01)
        self.blocks = nn.ModuleList(
            Block(width, heads, act="quick_gelu", spec=PEFTSpec(), layer_idx=i, causal=True,
                  dtype=dtype, device=device)
            for i in range(layers))
        self.ln_final = LayerNorm(width, device=device)
        self.text_projection = nn.Parameter(torch.randn(width, output_dim, **pkw) * width**-0.5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, context_length) integer ids -> (B, output_dim)."""
        b, n = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[:n].to(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x)
        # the features at the end token, the highest id (CLIP's convention)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection.to(self.dtype)


class TextEncoder:
    """``encode_text`` of the JAX builder: the frozen ``TextTransformer``
    as a function of (B, context_length) token ids (numpy or a tensor) ->
    (B, output_dim) features on the tower's device, in the compute dtype,
    without a gradient.  ``context_length`` is the tower's (the zero-shot
    path tokenizes to it).  ``module`` is the tower, built by ``build`` on
    first use (a path that never encodes text never builds it); its weights
    load through ``models.load_jax_variables``."""

    def __init__(self, build: Callable[[], TextTransformer], context_length: int):
        self._build = build
        self._module: Optional[TextTransformer] = None
        self.context_length = int(context_length)

    @property
    def module(self) -> TextTransformer:
        if self._module is None:
            self._module = self._build().eval().requires_grad_(False)
        return self._module

    @torch.no_grad()
    def __call__(self, tokens) -> torch.Tensor:
        module = self.module
        device = module.positional_embedding.device
        return module(torch.as_tensor(tokens, device=device).long())
