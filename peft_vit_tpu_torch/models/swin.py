"""Swin Transformer backbone (counterpart of ``peft_vit_tpu/models/swin.py``):
the reference's supervised Swin (cls_swin.py) and the visual tower of CLIP
with Swin (clip_swin.py), with the SSL-Swin options (``ape``,
``patch_norm``, ``drop_path_rate``, ``n_last_blocks``).

* ``window_partition`` / ``window_merge`` are reshapes, ``torch.roll``
  shifts the windows in the JAX module's directions.
* ``WindowAttention``: the packed ``in_proj``, the LoRA q/v deltas (the JAX
  ``bert_init`` A, a zero B), the ``relative_position_bias_table`` gathered
  through ``layers._TableGather`` (a fixed-order backward), ``out_proj``.
* The window fold: every block runs its attention as batch b with nW h
  heads and an (nW h, N, N) bias, the gathered table tiled over the windows
  and, in a shifted block, the shift mask (-1e9 between regions) added.  The
  JAX module folds an unshifted block as batch b nW with h heads instead;
  each (window, head) row computes the same, and only the order in which the
  table's gradient sums the windows differs (the bias-gradient kernel K7
  sums a (cell, head) over the batch, then autograd sums the windows).  One
  layout keeps K7's blocks many: Swin-T's stage 1 at B = 64 is 192 (cell,
  head) planes of 64 images, where JAX's unshifted fold would be 3 planes of
  4,096 windows.  On the card the attention is K1 with the bias, K2 and K3
  where q, k and v need a gradient, K7 where the table trains, all at head
  dim 32 (Swin-T's 96 / 3 ... 768 / 24).
* The bias is built in fp32 and rounded to the compute dtype, as the JAX
  module does; the mask is a device buffer made once per block at build.
* ``SwinBlock``: the window clamp ``ws = min(window, H, W)`` and no shift
  when the window covers the map; drop path (stochastic depth) in training
  mode, drawn from the forward's explicit ``generator``.
* ``PatchMerging`` concatenates the 2 x 2 neighbours with the H offset
  fastest in the 4c axis (the official order, pinned by refexec_swin.npz).
* ``SwinTransformer``: the patch embedding through ``vit._PatchConv`` (a
  fixed-order weight gradient), ``pos_norm``, ``absolute_pos_embed``, the
  stages, the final ``norm``, the token mean, ``proj`` for CLIP.

Images are NHWC.  Weights are stored in fp32 and cast to the compute
``dtype`` at use; LayerNorm statistics are fp32.  Module names are the JAX
tree's (``stage0_block1``, ``downsample0``, ...), so ``params_from_jax``
carries a JAX tree across one to one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import multi_head_attention
from ..peft.spec import PEFTSpec
from ..utils import dist as _dist
from .layers import ACT2FN, Dense, LayerNorm, _gather_slots, _rpb_index, _TableGather
from .vit import PatchEmbed


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B nW, ws ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_merge(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B nW, ws ws, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The shifted windows' attention mask (Swin paper Fig. 4): (nW, ws ws,
    ws ws) fp32, -1e9 between tokens of different regions, else 0."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = (img.reshape(1, h // ws, ws, w // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5)
           .reshape(-1, ws * ws))
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


def _drop_path(x: torch.Tensor, rate: float, training: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth in training mode: each sample keeps its branch with
    probability 1 - rate and is divided by it (``layers.Block._drop_path``),
    drawn from the explicit ``generator``."""
    if rate == 0.0 or not training:
        return x
    if generator is None:
        raise ValueError("training-mode drop_path draws from an explicit torch.Generator")
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    draw = _dist.draw_rows(lambda s: torch.rand(s, generator=generator, device=generator.device),
                           shape)
    return x * (draw < keep).to(device=x.device, dtype=x.dtype) / keep


class WindowAttention(nn.Module):
    """Attention inside the windows of one block, over (B nW, N, C) tokens,
    with the relative position bias and, given ``mask`` (nW, N, N), the
    shift mask; the uniform fold of the module docstring."""

    def __init__(self, dim: int, heads: int, window_size: int, spec: PEFTSpec = PEFTSpec(),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.heads, self.ws, self.spec = heads, window_size, spec
        self.compute_dtype = dtype
        self.in_proj = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.lora_targets = tuple(spec.lora_targets) if spec.attn_delta == "lora" else ()
        for t in self.lora_targets:
            a1 = Dense(dim, spec.lora_rank, bias=False, dtype=dtype, device=device)
            nn.init.normal_(a1.weight, std=0.02)  # bert_init; a fresh delta is 0
            self.add_module(f"{t}_adapter1", a1)
            a2 = Dense(spec.lora_rank, dim, bias=False, dtype=dtype, device=device)
            nn.init.zeros_(a2.weight)
            self.add_module(f"{t}_adapter2", a2)
        rows = (2 * window_size - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(
            torch.randn(rows, heads, device=device) * 0.02)
        index = _rpb_index(window_size).reshape(-1)
        self.register_buffer("rpb_index", torch.as_tensor(index, device=device), persistent=False)
        self.register_buffer("rpb_slots", torch.as_tensor(_gather_slots(index, rows),
                                                          device=device), persistent=False)
        self.out_proj = Dense(dim, dim, dtype=dtype, device=device)

    def folded_bias(self, mask: Optional[torch.Tensor], windows: int) -> torch.Tensor:
        """The (nW h, N, N) bias in the compute dtype: the gathered table
        (h, N, N) tiled over the ``windows``, plus the (nW, N, N) ``mask``."""
        h, n = self.heads, self.ws * self.ws
        table = _TableGather.apply(self.relative_position_bias_table, self.rpb_index,
                                   self.rpb_slots)
        bias = table.reshape(n, n, h).permute(2, 0, 1).to(torch.float32)
        bias = bias.unsqueeze(0) + (mask.unsqueeze(1) if mask is not None else 0.0)
        return bias.expand(windows, h, n, n).reshape(windows * h, n, n).to(
            self.compute_dtype).contiguous()

    def forward(self, x: torch.Tensor, windows: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bnw, n, c = x.shape
        h = self.heads
        hd = c // h
        b = bnw // windows
        q, k, v = self.in_proj(x).chunk(3, dim=-1)
        qkv = {"q": q, "k": k, "v": v}
        scale = self.spec.lora_alpha / self.spec.lora_rank
        for t in self.lora_targets:
            qkv[t] = qkv[t] + getattr(self, f"{t}_adapter2")(
                getattr(self, f"{t}_adapter1")(x)) * scale

        def fold(t: torch.Tensor) -> torch.Tensor:
            # (B nW, N, h hd) -> (B, nW h, N, hd)
            return t.reshape(b, windows, n, h, hd).permute(0, 1, 3, 2, 4).reshape(
                b, windows * h, n, hd)

        out = multi_head_attention(*(fold(qkv[t]).contiguous() for t in "qkv"),
                                   bias=self.folded_bias(mask, windows))
        out = out.reshape(b, windows, h, n, hd).permute(0, 1, 3, 2, 4).reshape(bnw, n, c)
        return self.out_proj(out)


class SwinBlock(nn.Module):
    """ln_1 -> (shifted) window attention -> residual; ln_2 -> MLP (exact
    GELU) -> residual, each branch with drop path."""

    def __init__(self, dim: int, heads: int, input_resolution: Tuple[int, int],
                 window_size: int = 7, shift: int = 0, mlp_ratio: float = 4.0,
                 spec: PEFTSpec = PEFTSpec(), drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        hres, wres = input_resolution
        self.resolution = (hres, wres)
        self.ws = min(window_size, hres, wres)
        self.shift = shift if self.ws < min(hres, wres) else 0
        self.windows = (hres // self.ws) * (wres // self.ws)
        self.drop_path = float(drop_path)
        self.ln_1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, heads, self.ws, spec=spec, dtype=dtype, device=device)
        self.ln_2 = LayerNorm(dim, device=device)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.mlp_fc2 = Dense(hidden, dim, dtype=dtype, device=device)
        mask = (torch.as_tensor(_shift_attn_mask(hres, wres, self.ws, self.shift), device=device)
                if self.shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        hres, wres = self.resolution
        b, n, c = x.shape
        s = self.shift
        y = self.ln_1(x).reshape(b, hres, wres, c)
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = self.attn(window_partition(y, self.ws), self.windows, self.attn_mask)
        y = window_merge(y, self.ws, hres, wres)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + _drop_path(y.reshape(b, n, c), self.drop_path, self.training, generator)
        m = self.mlp_fc2(ACT2FN["gelu"](self.mlp_fc1(self.ln_2(x))))
        return x + _drop_path(m, self.drop_path, self.training, generator)


class PatchMerging(nn.Module):
    """2 x 2 neighbours concatenated (the H offset fastest in the 4c axis),
    ``norm``, then the bias-free ``reduction`` to 2c."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.resolution = input_resolution
        self.norm = LayerNorm(4 * dim, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(b, (h // 2) * (w // 2), 4 * c)))


class SwinTransformer(nn.Module):
    """The Swin backbone; returns the pooled features (pre-head), or with
    ``n_last_blocks`` > 0 the concatenated token means of the last n blocks
    (the SSL linear-eval protocol: the final norm on last-stage features
    only)."""

    def __init__(self, image_size: int = 224, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0, output_dim: Optional[int] = None,
                 spec: PEFTSpec = PEFTSpec(), ape: bool = False, patch_norm: bool = True,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.depths = tuple(int(d) for d in depths)
        self.patch_norm, self.ape = bool(patch_norm), bool(ape)
        self.drop_path_rate = float(drop_path_rate)
        self.compute_dtype = dtype
        g = image_size // patch_size
        self.grid = g
        self.patch_embed = PatchEmbed(embed_dim, patch_size, dtype, bias=True, device=device)
        if self.patch_norm:
            self.pos_norm = LayerNorm(embed_dim, device=device)
        if self.ape:
            self.absolute_pos_embed = nn.Parameter(
                torch.randn(g * g, embed_dim, device=device) * 0.02)
        dpr = np.linspace(0.0, self.drop_path_rate, max(sum(self.depths), 1))
        res, dim, i = g, embed_dim, 0
        self.stages = []  # per stage, its blocks' names and the merge after it
        for si, (depth, heads) in enumerate(zip(self.depths, num_heads)):
            names = []
            for bi in range(depth):
                name = f"stage{si}_block{bi}"
                self.add_module(name, SwinBlock(
                    dim, int(heads), (res, res), window_size=window_size,
                    shift=0 if bi % 2 == 0 else window_size // 2, mlp_ratio=mlp_ratio, spec=spec,
                    drop_path=float(dpr[i]), dtype=dtype, device=device))
                names.append(name)
                i += 1
            merge = None
            if si < len(self.depths) - 1:
                merge = f"downsample{si}"
                self.add_module(merge, PatchMerging((res, res), dim, dtype=dtype, device=device))
                res //= 2
                dim *= 2
            self.stages.append((names, merge))
        self.norm = LayerNorm(dim, device=device)
        self.output_dim = output_dim
        if output_dim is not None:
            self.proj = nn.Parameter(torch.randn(dim, output_dim, device=device) * dim ** -0.5)
        self.num_features = dim if output_dim is None else int(output_dim)

    def forward(self, x: torch.Tensor, start_layer: int = 0, progress=None,
                generator: Optional[torch.Generator] = None,
                n_last_blocks: int = 0) -> torch.Tensor:
        """``generator``: the drop path's draws in training mode.
        ``start_layer`` must be 0 (the cached prefix cuts only the ViT) and
        ``progress`` (DropBlock's anneal) is not read."""
        if start_layer:
            raise ValueError("the Swin tower is not cut at a block (start_layer must be 0)")
        dt = self.compute_dtype
        x = self.patch_embed(x.to(dt))
        if self.patch_norm:
            x = self.pos_norm(x)
        if self.ape:
            x = x + self.absolute_pos_embed.to(dt)[None]
        total = sum(self.depths)
        feats, done = [], 0
        for si, (names, merge) in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, generator)
                done += 1
                if n_last_blocks > 0 and done > total - n_last_blocks:
                    # the final norm applies to last-stage features only
                    f = self.norm(x) if si == len(self.stages) - 1 else x
                    feats.append(f.mean(dim=1))
            if merge is not None:
                x = getattr(self, merge)(x)
        if n_last_blocks > 0:
            return torch.cat(feats, dim=-1)
        pooled = self.norm(x).mean(dim=1)
        if self.output_dim is not None:
            pooled = pooled @ self.proj.to(dt)
        return pooled
