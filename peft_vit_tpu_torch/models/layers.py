"""Transformer building blocks (counterpart of ``peft_vit_tpu/models/layers.py``).

Ported: the activations, ``LayerNorm``, ``Mlp``, ``MultiHeadAttention``
with a packed ``in_proj`` and the LoRA q/k/v deltas (with the CLIP
``lora_post_scale_q`` quirk), ``Block`` with training-mode drop-path, and
the int8 frozen tower: ``Int8Dense`` in place of ``Dense`` for the GEMMs
named in ``int8_targets`` (``int8``: no-grad forwards; ``int8_train``:
training forwards with a full-precision or int8-dx backward), with
``collect_activation_stats`` for the static activation scales.  Every other
PEFT hook, and int8 attention (``int8_attn``, ``int8_attn_pv``), raises
``NotImplementedError`` (``require_ported``).

Numerics follow the JAX modules: every weight is stored in fp32 (``Dense``'s
``param_dtype``) and cast to the module's compute ``dtype`` at use (flax
``nn.Dense(dtype=..., param_dtype=...)``), so a bf16 model trains fp32
master weights with fp32 gradients; LayerNorm statistics are fp32 with the
result cast back to the input dtype, residual adds are in the compute
dtype.  ``cast_frozen_`` stores the frozen weights in the compute dtype
once the trainable mask is known: the same numbers, one cast fewer per use.
LayerNorm parameters stay fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import int8 as int8_ops
from ..ops.attention import multi_head_attention
from ..ops.int8 import INT8_TARGET_MODULES
from ..peft.spec import PEFTSpec


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    # HF "gelu_new": tanh approximation.
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x.pow(3.0))))


ACT2FN: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "gelu": F.gelu,
    "gelu_new": gelu_new,
    "quick_gelu": quick_gelu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def require_ported(spec: PEFTSpec, int8_attn: bool = False,
                   int8_attn_pv: bool = False) -> None:
    """Raise ``NotImplementedError`` for every hook of ``spec``, and every
    int8 attention flag, the port lacks."""
    unported = {
        "int8_attn (int8 QK^T on calibrated q/k/v scales)": int8_attn,
        "int8_attn_pv (int8 P@V)": int8_attn_pv,
        "attn_delta=kron (KAdaptation)": spec.attn_delta == "kron",
        "adapter (Houlsby / Compacter)": spec.adapter != "none",
        "attn_bias=rpb": spec.attn_bias != "none",
        "lepe": spec.lepe,
        "lepe_ref_qkv": spec.lepe_ref_qkv,
        "attn_adapter=shared_qkv": spec.attn_adapter != "none",
        "prompt_tokens (VPT)": spec.prompt_tokens > 0,
        "lora_moe": spec.lora_moe,
        "extra_block": spec.extra_block,
    }
    if spec.attn_delta not in ("none", "lora", "kron"):
        raise ValueError(f"unknown attn_delta {spec.attn_delta!r}")
    missing = [name for name, on in unported.items() if on]
    if missing:
        raise NotImplementedError(
            f"hooks not ported to peft_vit_tpu_torch yet: {', '.join(missing)}"
        )


class _Linear(torch.autograd.Function):
    """``F.linear(x, w, b)`` with a bias, whose batching rule folds the
    vmapped axis of ``x`` (a sweep round's cells) into its rows when ``w`` and
    ``b`` are shared: one GEMM for the round, with the bias added inside it
    as for one cell.  ``torch.func.vmap``'s own rule for ``F.linear`` adds
    the bias after the product is rounded, which in bf16 is another number.
    A batched weight runs one cell at a time."""

    @staticmethod
    def forward(x, w, b):
        return F.linear(x, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        need_dx, need_dw = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x if need_dw else None, w if need_dx else None)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_dx, need_dw, need_db = ctx.needs_input_grad
        g2d = g.reshape(-1, g.shape[-1])
        dx = g.matmul(w) if need_dx else None
        dw = g2d.t().matmul(x.reshape(-1, x.shape[-1])) if need_dw else None
        db = g2d.sum(0) if need_db else None
        return dx, dw, db

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        cells = info.batch_size
        x_dim, w_dim, b_dim = in_dims
        if w_dim is None and b_dim is None:
            x = x.movedim(x_dim, 0)
            folded = x.reshape(cells * x.shape[1], *x.shape[2:]).contiguous()
            return _Linear.apply(folded, w, b).unflatten(0, (cells, -1)), 0

        def cell(t, dim, i):
            return t if dim is None else t.select(dim, i)

        return torch.stack([_Linear.apply(cell(x, x_dim, i), cell(w, w_dim, i),
                                          cell(b, b_dim, i)) for i in range(cells)]), 0


class Dense(nn.Linear):
    """``nn.Linear`` as flax ``nn.Dense(dtype=..., param_dtype=...)``: the
    weights are stored in ``param_dtype`` and, like the input, cast to the
    compute ``dtype`` at use.  With a bias the product runs through
    ``_Linear``, so that a sweep round's cells round as each cell alone."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.bias is None:
            return F.linear(x.to(dt), self.weight.to(dt))
        return _Linear.apply(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Int8Dense(Dense):
    """``Dense`` with the int8 matmul (counterpart of the JAX ``Int8Dense``).

    The same parameters (``weight``, ``bias``), so checkpoints, converters and
    PEFT masks see no difference.  What flax reads from the ``qkernel`` and
    ``qscale`` collections lives here in non-persistent buffers, ``None`` when
    absent: ``w_i8`` / ``s_w`` (``ops.int8.quantize_frozen_tree``), the
    transposed ``wt_i8`` / ``s_wt`` and the static activation scale ``s_x``
    (``ops.int8.activation_scales_from_stats``).  ``functional_call``
    substitutes them by name, so the quantized tree travels in a train
    step's ``frozen`` dict.

    ``forward(x, int8, train_bwd)``: ``int8=False`` is ``Dense``.  With
    ``train_bwd`` and ``w_i8`` present: the ``_i8bwd`` ops if ``wt_i8`` is
    present, the static ops if ``s_x`` is; without ``w_i8`` the weight is
    quantized per call from the compute-dtype weight, differentiably if
    ``train_bwd`` (``int8_matmul_bf16_bwd``) else not (``int8_matmul``).
    Without ``train_bwd`` a present ``w_i8`` / ``s_w`` is used as it is (a
    serving session quantizes the tower once, at load).  The bias is added
    after the cast to the compute dtype."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for name in ("w_i8", "s_w", "wt_i8", "s_wt", "s_x"):
            self.register_buffer(name, None, persistent=False)
        self._stats = None  # (store, key) inside collect_activation_stats

    def forward(self, x: torch.Tensor, int8: bool = True, train_bwd: bool = False) -> torch.Tensor:
        if not int8:
            return super().forward(x)
        dt = self.compute_dtype
        if train_bwd and self._stats is not None:
            store, key = self._stats
            amax = x.detach().to(torch.float32).abs().max()
            store[key] = amax if key not in store else torch.maximum(store[key], amax)
        xc, w = x.to(dt), self.weight.to(dt)
        if train_bwd and self.w_i8 is not None:
            if self.wt_i8 is not None:
                if self.s_x is not None:
                    y = int8_ops.int8_static_matmul_i8bwd(
                        xc, w, self.w_i8, self.s_w, self.wt_i8, self.s_wt, self.s_x)
                else:
                    y = int8_ops.int8_prequant_matmul_i8bwd(
                        xc, w, self.w_i8, self.s_w, self.wt_i8, self.s_wt)
            elif self.s_x is not None:
                y = int8_ops.int8_static_matmul(xc, w, self.w_i8, self.s_w, self.s_x)
            else:
                y = int8_ops.int8_prequant_matmul(xc, w, self.w_i8, self.s_w)
        elif train_bwd:
            y = int8_ops.int8_matmul_bf16_bwd(xc, w)
        else:
            y = int8_ops.int8_matmul(xc, w, self.w_i8, self.s_w)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _dense_for(name: str, int8: bool, targets: Sequence[str]):
    """The class of the GEMM ``name``: ``Int8Dense`` where the model may route
    it through the int8 path."""
    return Int8Dense if int8 and name in targets else Dense


def _call(dense: Dense, x: torch.Tensor, int8: bool, int8_bwd: bool) -> torch.Tensor:
    if isinstance(dense, Int8Dense):
        return dense(x, int8, int8_bwd)
    return dense(x)


@contextlib.contextmanager
def collect_activation_stats(model: nn.Module) -> Iterator[Dict[str, torch.Tensor]]:
    """Calibration mode: within, every ``Int8Dense`` of ``model`` that runs
    with ``train_bwd`` max-reduces the absmax of its input (taken in fp32)
    into the yielded dict under ``<module name>.amax``, over however many
    forwards are run.  Feed the dict to ``ops.int8.activation_scales_from_stats``."""
    stats: Dict[str, torch.Tensor] = {}
    modules = [(name, m) for name, m in model.named_modules() if isinstance(m, Int8Dense)]
    for name, m in modules:
        m._stats = (stats, f"{name}.amax")
    try:
        yield stats
    finally:
        for _, m in modules:
            m._stats = None


def cast_frozen_(model: nn.Module) -> nn.Module:
    """Store every frozen weight (``requires_grad`` False) that is cast to a
    compute dtype at use in that dtype, in place: one cast instead of one per
    use, the same numbers.  Trainable weights keep their ``param_dtype``.
    Modules that cast at use name their dtype in ``compute_dtype``."""
    for module in model.modules():
        dt = getattr(module, "compute_dtype", None)
        if dt is None:
            continue
        for p in module.parameters(recurse=False):
            if not p.requires_grad and p.dtype != dt:
                p.data = p.data.to(dt)
    return model


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics (eps 1e-5), output cast back to the
    input dtype.  ``compute_fp32=False`` normalizes in the input dtype (the
    JAX throughput mode for bf16 training; ``F.layer_norm`` still
    accumulates its statistics in fp32)."""

    eps = 1e-5

    def __init__(self, width: int, compute_fp32: bool = True, device=None):
        super().__init__()
        self.compute_fp32 = compute_fp32
        self.weight = nn.Parameter(torch.ones(width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.float32 if self.compute_fp32 else x.dtype
        y = F.layer_norm(
            x.to(ct), (x.shape[-1],), self.weight.to(ct), self.bias.to(ct), self.eps
        )
        return y.to(x.dtype)


class Mlp(nn.Module):
    """c_fc -> act -> c_proj.

    ``int8=True`` builds the GEMMs named in ``int8_targets`` as ``Int8Dense``;
    a forward then routes them through the int8 path when called with
    ``int8`` (and differentiably with ``int8_bwd``)."""

    def __init__(self, width: int, hidden: int, act: str = "gelu", int8: bool = False,
                 int8_targets: Sequence[str] = INT8_TARGET_MODULES,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.act = ACT2FN[act]
        self.c_fc = _dense_for("c_fc", int8, int8_targets)(
            width, hidden, dtype=dtype, device=device)
        self.c_proj = _dense_for("c_proj", int8, int8_targets)(
            hidden, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, int8: bool = False, int8_bwd: bool = False) -> torch.Tensor:
        x = self.act(_call(self.c_fc, x, int8, int8_bwd))
        return _call(self.c_proj, x, int8, int8_bwd)


class MultiHeadAttention(nn.Module):
    """Packed-qkv attention with the LoRA q/k/v deltas.

    * lora: dq = (x @ A_q) @ B_q * alpha/r, no biases.
    * post_scale_q (CLIP LoRA parity): q is scaled by 1/sqrt(head_dim)
      before the delta is added, and attention then runs at scale 1,
      i.e. softmax((q/sqrt(d) + dq) k^T).
    * lora_ref_reshape (``PEFT.LORA_REF_RESHAPE``): each delta is added
      after the head split in the executed reference's flat layout, as the
      JAX layer does for trajectory parity.
    * ``int8=True`` builds ``in_proj`` / ``out_proj`` (those named in
      ``int8_targets``) as ``Int8Dense``; the LoRA deltas stay dense.
    * ``softmax_fp32`` (False: ``TPU.BF16_SOFTMAX``) and ``attn_batch_chunk``
      (``TPU.ATTN_BATCH_CHUNK``) go to ``ops.attention.multi_head_attention``.
    """

    def __init__(self, width: int, heads: int, spec: PEFTSpec = PEFTSpec(), int8: bool = False,
                 int8_attn: bool = False, int8_attn_pv: bool = False,
                 int8_targets: Sequence[str] = INT8_TARGET_MODULES,
                 softmax_fp32: bool = True, attn_batch_chunk: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        require_ported(spec, int8_attn, int8_attn_pv)
        self.heads = heads
        self.spec = spec
        self.softmax_fp32 = bool(softmax_fp32)
        self.attn_batch_chunk = int(attn_batch_chunk)
        self.in_proj = _dense_for("in_proj", int8, int8_targets)(
            width, 3 * width, dtype=dtype, device=device)
        self.lora_targets = tuple(spec.lora_targets) if spec.attn_delta == "lora" else ()
        for t in self.lora_targets:
            if t not in ("q", "k", "v"):
                raise ValueError(f"unknown LoRA target {t!r}")
            a1 = Dense(width, spec.lora_rank, bias=False, dtype=dtype, device=device)
            a2 = Dense(spec.lora_rank, width, bias=False, dtype=dtype, device=device)
            nn.init.normal_(a1.weight, std=0.02)  # the JAX init: a fresh delta is 0
            nn.init.zeros_(a2.weight)
            self.add_module(f"{t}_adapter1", a1)
            self.add_module(f"{t}_adapter2", a2)
        self.out_proj = _dense_for("out_proj", int8, int8_targets)(
            width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, int8: bool = False, int8_bwd: bool = False) -> torch.Tensor:
        b, n, d = x.shape
        h = self.heads
        hd = d // h
        spec = self.spec
        scale = hd**-0.5
        q, k, v = _call(self.in_proj, x, int8, int8_bwd).chunk(3, dim=-1)

        deltas = {}
        if self.lora_targets:
            lora_scale = spec.lora_alpha / spec.lora_rank
            for t in self.lora_targets:
                a = getattr(self, f"{t}_adapter1")(x)
                deltas[t] = getattr(self, f"{t}_adapter2")(a) * lora_scale

        if spec.attn_delta != "none" and spec.lora_post_scale_q:
            q = q * scale
            attn_scale = 1.0
        else:
            attn_scale = scale

        def split_heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, n, h, hd).transpose(1, 2).contiguous()

        qkv = {"q": q, "k": k, "v": v}
        if spec.lora_ref_reshape:
            # the executed reference's layout (lora_model.py:730-731): the
            # seq-first (N, B, C) delta reshaped flat into (B*H, N, hd),
            # which scrambles batch, sequence and head unless B = H = 1
            qkv = {t: split_heads(x) for t, x in qkv.items()}
            for t, dl in deltas.items():
                qkv[t] = qkv[t] + dl.transpose(0, 1).reshape(b, h, n, hd)
        else:
            for t, dl in deltas.items():
                qkv[t] = qkv[t] + dl
            qkv = {t: split_heads(x) for t, x in qkv.items()}

        out = multi_head_attention(
            qkv["q"], qkv["k"], qkv["v"], scale=attn_scale,
            softmax_fp32=self.softmax_fp32, batch_chunk=self.attn_batch_chunk,
        )
        return _call(self.out_proj, out.transpose(1, 2).reshape(b, n, d), int8, int8_bwd)


class Block(nn.Module):
    """Pre-LN transformer block:
    x = x + drop_path(attn(ln_1(x))); x = x + drop_path(mlp(ln_2(x))).

    ``drop_path`` (stochastic depth) acts in training mode only: each sample
    keeps its branch with probability ``1 - drop_path`` and is divided by
    it, drawn from the explicit ``generator``.  ``ln_fp32=False`` normalizes
    in the activations' dtype (the throughput mode of bf16 training).

    ``int8``: the frozen tower's GEMMs (``int8_targets``) run int8 on eval
    forwards only; a training forward is then the dense path bit for bit
    (round has a zero gradient).  ``int8_train``: they run int8 on training
    forwards too, through the differentiable ops.  A flax module picks the
    class per call; here the choice is made at call time from
    ``self.training``."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, act: str = "gelu",
                 spec: PEFTSpec = PEFTSpec(), drop_path: float = 0.0, ln_fp32: bool = True,
                 int8: bool = False, int8_train: bool = False, int8_attn: bool = False,
                 int8_attn_pv: bool = False,
                 int8_targets: Sequence[str] = INT8_TARGET_MODULES,
                 softmax_fp32: bool = True, attn_batch_chunk: int = 0,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.drop_path = float(drop_path)
        self.generator = generator
        self.int8 = bool(int8)
        self.int8_train = bool(int8_train)
        any_int8 = self.int8 or self.int8_train
        self.ln_1 = LayerNorm(width, compute_fp32=ln_fp32, device=device)
        self.attn = MultiHeadAttention(
            width, heads, spec=spec, int8=any_int8, int8_attn=int8_attn,
            int8_attn_pv=int8_attn_pv, int8_targets=int8_targets, softmax_fp32=softmax_fp32,
            attn_batch_chunk=attn_batch_chunk, dtype=dtype, device=device)
        self.ln_2 = LayerNorm(width, compute_fp32=ln_fp32, device=device)
        self.mlp = Mlp(width, int(width * mlp_ratio), act=act, int8=any_int8,
                       int8_targets=int8_targets, dtype=dtype, device=device)

    def _drop_path(self, x: torch.Tensor) -> torch.Tensor:
        if self.drop_path == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise ValueError("training-mode drop_path draws from an explicit torch.Generator")
        keep = 1.0 - self.drop_path
        draw = torch.rand((x.shape[0], 1, 1), generator=self.generator,
                          device=self.generator.device)
        return x * (draw < keep).to(device=x.device, dtype=x.dtype) / keep

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deterministic = not self.training
        int8 = (self.int8 and deterministic) or self.int8_train
        int8_bwd = self.int8_train and not (self.int8 and deterministic)
        x = x + self._drop_path(self.attn(self.ln_1(x), int8, int8_bwd))
        return x + self._drop_path(self.mlp(self.ln_2(x), int8, int8_bwd))
