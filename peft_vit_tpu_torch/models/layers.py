"""Transformer building blocks (counterpart of ``peft_vit_tpu/models/layers.py``).

The activations, ``LayerNorm``, ``Mlp``, ``MultiHeadAttention`` with a
packed ``in_proj`` and ``Block`` with training-mode drop-path, and every
PEFT hook of the JAX package:

* the LoRA q/k/v deltas (with the CLIP ``lora_post_scale_q`` quirk, the
  executed reference's ``lora_ref_reshape`` layout and the LoRA-MoE gate);
* the KAdaptation Kronecker q/v deltas (``attn_delta='kron'``, with the
  unused ``phmb`` leaf kept for parameter-count parity);
* the shared head-dim adapter on q, k and v (``attn_adapter='shared_qkv'``);
* LePE's depthwise 3x3 convolution of v over the patch grid, with the
  reference's ``lepe_ref_qkv`` q/k/v scramble;
* the post-MLP Houlsby ``Adapter`` and ``CompacterAdapter`` (``PHMDense``),
  each run only in the blocks of ``adapter_layers`` (AdapterDrop) while its
  leaves exist in every block;
* the Swin-style relative position bias (``attn_bias='rpb'``): a trainable
  ((2g - 1)^2, H) table gathered over the g x g patch grid into an (H, N, N)
  attention bias in the compute dtype, zero on the class token's and the
  prompts' rows and columns (``n_prefix``); its gradient is the attention
  kernels' bias path and the bias-gradient kernel (``ops.attention``), and
  the table's the gather's (``_TableGather``, deterministic);
* the int8 frozen tower: ``Int8Dense`` in place of ``Dense`` for the GEMMs
  named in ``int8_targets`` (``int8``: no-grad forwards; ``int8_train``:
  training forwards with a full-precision or int8-dx backward), with
  ``collect_activation_stats`` for the static activation scales;
* int8 attention scores (``int8_attn``, ``int8_attn_pv``:
  ``ops.attention.int8_attention``) on the calibrated scales ``s_q``,
  ``s_k``, ``s_v`` of each attention, whose absmax the calibration records;
* the causal mask of the CLIP text tower (``causal``): an (H, N, N) bias of
  -1e30 above the diagonal in the compute dtype, added to any other bias.

The hooks' own arithmetic is plain PyTorch, as it is XLA outside any Pallas
kernel in the JAX package.

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
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import int8 as int8_ops
from ..ops.attention import int8_attention, multi_head_attention
from ..ops.int8 import INT8_TARGET_MODULES
from ..ops.phm import factorized_phm_weight, phm_linear
from ..peft.spec import PEFTSpec
from ..utils import dist as _dist


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


def check_spec(spec: PEFTSpec) -> None:
    """Raise ``ValueError`` for an attention hook of ``spec`` that neither
    package knows."""
    if spec.attn_delta not in ("none", "lora", "kron"):
        raise ValueError(f"unknown attn_delta {spec.attn_delta!r}")
    if spec.attn_bias not in ("none", "rpb"):
        raise ValueError(f"unknown attn_bias {spec.attn_bias!r}")


def _cell(t: Optional[torch.Tensor], dim: Optional[int], i: int) -> Optional[torch.Tensor]:
    """Cell ``i`` of an operand a batching rule was given batched along
    ``dim``, or the operand itself when it is shared (``dim`` None)."""
    return t if dim is None else t.select(dim, i)


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

        return torch.stack([_Linear.apply(_cell(x, x_dim, i), _cell(w, w_dim, i),
                                          _cell(b, b_dim, i)) for i in range(cells)]), 0


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

    def _record(self, x: torch.Tensor) -> None:
        """Inside ``collect_activation_stats``: max-reduce the absmax of the
        input into the statistics."""
        if self._stats is not None:
            store, key = self._stats
            amax = x.detach().to(torch.float32).abs().max()
            store[key] = amax if key not in store else torch.maximum(store[key], amax)

    def forward(self, x: torch.Tensor, int8: bool = True, train_bwd: bool = False) -> torch.Tensor:
        if not int8:
            return super().forward(x)
        dt = self.compute_dtype
        if train_bwd:
            self._record(x)
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

    def row_parallel(self, x: torch.Tensor, comm, train_bwd: bool) -> torch.Tensor:
        """The int8 forward of this GEMM as the row-parallel half of tensor
        parallelism: the weight (and ``w_i8``) holds this rank's input columns,
        ``s_w`` is the whole weight's (``parallel.tp_cut``), and the result
        is the unsplit GEMM's bit for bit (``ops.int8.int8_row_parallel``:
        the global row scale, the ranks' int32 partials summed over ``comm``,
        then the rescale); the bias once, after the sum.  The buffers choose
        the op as ``forward`` does."""
        dt = self.compute_dtype
        if train_bwd:
            self._record(x)
        xc, w = x.to(dt), self.weight.to(dt)
        if train_bwd and self.w_i8 is not None:
            y = int8_ops.int8_row_parallel(xc, w, self.w_i8, self.s_w, self.wt_i8, self.s_wt,
                                           self.s_x, comm)
        elif train_bwd:
            y = int8_ops.int8_row_parallel(xc, w, None, None, None, None, None, comm)
        else:
            with torch.no_grad():
                y = int8_ops.int8_row_parallel(xc, w, self.w_i8, self.s_w, None, None, None,
                                               comm)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def column_parallel(self, x: torch.Tensor, xin: torch.Tensor, comm, int8: bool,
                        train_bwd: bool) -> torch.Tensor:
        """This GEMM as the column-parallel half of tensor parallelism on
        ``xin`` = ``f(x)``: the rows of the weight are this rank's.  The
        forward needs no collective (each output column contracts over the
        whole K).  With the int8 dx backward (``wt_i8`` present) the dx
        contracts over the cut N, so the op takes ``x`` too and hands it the
        whole dx (``ops.int8.int8_column_parallel_dx``: the global row scale
        and the int32 sum over ``comm``), and ``f``'s backward sums nothing
        of it; otherwise this is ``forward(xin)``, whose dx ``f`` sums."""
        if not (int8 and train_bwd and self.w_i8 is not None and self.wt_i8 is not None):
            return self(xin, int8, train_bwd)
        dt = self.compute_dtype
        self._record(xin)
        y = int8_ops.int8_column_parallel_dx(x.to(dt), xin.to(dt), self.weight.to(dt), self.w_i8,
                                             self.s_w, self.wt_i8, self.s_wt, self.s_x, comm)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _dense_for(name: str, int8: bool, targets: Sequence[str]):
    """The class of the GEMM ``name``: ``Int8Dense`` where the model may route
    it through the int8 path."""
    return Int8Dense if int8 and name in targets else Dense


class TensorParallel(NamedTuple):
    """A forward under tensor parallelism (``tensor_parallel``): ``f`` and
    ``g`` are Megatron's (``parallel.copy_to_model`` /
    ``reduce_from_model`` over the model group).  Under sequence parallelism
    ``f`` is the token all-gather and ``g`` the token reduce-scatter
    (``parallel.sp_all_gather`` / ``sp_reduce_scatter``), ``split`` cuts the
    tokens after the embedding and ``gather`` joins them before the head
    (``parallel.sp_split`` / ``sp_gather``).  ``comm`` holds the model
    group's other collectives (``parallel.ModelComm``): the int8 GEMMs'
    global scales and int32 sums, the gather of every rank's heads for the
    reference layouts, the rank that places the deep prompts."""

    f: Callable
    g: Callable
    split: Optional[Callable] = None
    gather: Optional[Callable] = None
    comm: Optional[object] = None

    @property
    def seq(self) -> bool:
        """Whether the activations between the regions are token slices."""
        return self.split is not None

    def row_parallel(self, x: torch.Tensor, dense: "Dense", int8: bool = False,
                     int8_bwd: bool = False) -> torch.Tensor:
        """``dense`` on its cut leaves, whose weight holds this rank's input
        columns: the sum of the ranks' partial products (``g``; under
        sequence parallelism this rank's tokens of it), then the bias,
        once.  An ``Int8Dense`` on the int8 path sums its int32 partials
        instead (``Int8Dense.row_parallel``)."""
        if int8 and isinstance(dense, Int8Dense):
            return dense.row_parallel(x, self.comm, int8_bwd)
        y = self.g(F.linear(x, dense.weight.to(x.dtype)))
        return y if dense.bias is None else y + dense.bias.to(y.dtype)

    def column_parallel(self, x: torch.Tensor, xin: torch.Tensor, dense: "Dense", int8: bool,
                        int8_bwd: bool) -> torch.Tensor:
        """``dense`` on ``xin`` = ``f(x)``, its output rows this rank's."""
        if isinstance(dense, Int8Dense):
            return dense.column_parallel(x, xin, self.comm, int8, int8_bwd)
        return dense(xin)

    def own_heads(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (its heads)."""
        n = t.shape[dim] // self.comm.size
        return t.narrow(dim, self.comm.rank * n, n)


_TP: Optional[TensorParallel] = None


@contextlib.contextmanager
def tensor_parallel(f: Callable, g: Callable, split: Optional[Callable] = None,
                    gather: Optional[Callable] = None, comm: Optional[object] = None):
    """Within, ``MultiHeadAttention`` and ``Mlp`` run Megatron's tensor
    parallelism on the cut leaves they are given: ``f`` at the input of each
    column-parallel region, this rank's heads (or hidden units), then
    ``g`` over the row-parallel product and its bias once.  With ``split``
    and ``gather`` (sequence parallelism, Megatron-SP) the activations
    between the regions are this rank's token slice: ``f`` gathers the
    tokens at each region's entry, ``g`` reduce-scatters them after
    ``out_proj`` and ``c_proj``, and the ViT cuts and joins the tokens around
    its blocks.  ``comm`` (``parallel.ModelComm``) serves the hooks and
    the int8 GEMMs that need more of the model group."""
    global _TP
    prev, _TP = _TP, TensorParallel(f, g, split, gather, comm)
    try:
        yield
    finally:
        _TP = prev


def sequence_parallel() -> Optional[TensorParallel]:
    """The forward's tensor parallelism when it is sequence parallel, else
    None."""
    return _TP if _TP is not None and _TP.seq else None


def _call(dense: Dense, x: torch.Tensor, int8: bool, int8_bwd: bool) -> torch.Tensor:
    if isinstance(dense, Int8Dense):
        return dense(x, int8, int8_bwd)
    return dense(x)


@contextlib.contextmanager
def collect_activation_stats(model: nn.Module) -> Iterator[Dict[str, torch.Tensor]]:
    """Calibration mode: within, every ``Int8Dense`` of ``model`` that runs
    with ``train_bwd`` max-reduces the absmax of its input (taken in fp32)
    into the yielded dict under ``<module name>.amax``, and every
    ``MultiHeadAttention`` with ``int8_attn`` the absmax of its per-head q,
    k and v under ``<module name>.amax_q`` / ``amax_k`` / ``amax_v`` (the JAX
    ``qstats`` sow), over however many forwards are run.  Feed the dict to
    ``ops.int8.activation_scales_from_stats``."""
    stats: Dict[str, torch.Tensor] = {}
    modules = [(name, m) for name, m in model.named_modules()
               if isinstance(m, Int8Dense) or getattr(m, "int8_attn", False)]
    for name, m in modules:
        m._stats = (stats, f"{name}.amax" if isinstance(m, Int8Dense) else name)
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


class _LayerNorm(torch.autograd.Function):
    """``F.layer_norm(x, (D,), w, b, eps)`` over the last axis, through the
    same ATen forward and backward, whose batching rule keeps a round's
    cells' arithmetic that of one cell: shared ``w`` and ``b`` (the frozen
    tower's) take every cell's rows at once, as for one cell; a batched ``w``
    or ``b`` (a trainable LayerNorm: the adapters', the probe block's) runs
    one cell at a time.  ``torch.func.vmap``'s own rule for ``F.layer_norm``
    with a batched weight applies the affine after the normalization, which
    rounds otherwise."""

    @staticmethod
    def forward(x, w, b, eps):
        return torch.ops.aten.native_layer_norm(x, (x.shape[-1],), w, b, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b, _ = inputs
        _, mean, rstd = output
        ctx.mark_non_differentiable(mean, rstd)
        ctx.save_for_backward(x, w, b, mean, rstd)

    @staticmethod
    def backward(ctx, g, _dmean, _drstd):
        x, w, b, mean, rstd = ctx.saved_tensors
        dx, dw, db = torch.ops.aten.native_layer_norm_backward(
            g, x, (x.shape[-1],), mean, rstd, w, b, list(ctx.needs_input_grad[:3]))
        return dx, dw, db, None

    @staticmethod
    def vmap(info, in_dims, x, w, b, eps):
        x_dim, w_dim, b_dim = in_dims[:3]
        if w_dim is None and b_dim is None:
            return _LayerNorm.apply(x.movedim(x_dim, 0), w, b, eps), (0, 0, 0)

        outs = [_LayerNorm.apply(_cell(x, x_dim, i), _cell(w, w_dim, i), _cell(b, b_dim, i), eps)
                for i in range(info.batch_size)]
        return tuple(torch.stack(t) for t in zip(*outs)), (0, 0, 0)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics (eps 1e-5), output cast back to the
    input dtype.  ``compute_fp32=False`` normalizes in the input dtype (the
    JAX throughput mode for bf16 training; the statistics still accumulate
    in fp32).  ``F.layer_norm``'s arithmetic, through ``_LayerNorm`` so that
    a sweep round's cells round as each cell alone."""

    eps = 1e-5

    def __init__(self, width: int, compute_fp32: bool = True, device=None):
        super().__init__()
        self.compute_fp32 = compute_fp32
        self.weight = nn.Parameter(torch.ones(width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.float32 if self.compute_fp32 else x.dtype
        y = _LayerNorm.apply(x.to(ct), self.weight.to(ct), self.bias.to(ct), self.eps)[0]
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
        """Under ``tensor_parallel`` ``c_fc`` holds this rank's rows and
        ``c_proj`` their columns (the cut leaves)."""
        tp = _TP
        if tp is None:
            x = self.act(_call(self.c_fc, x, int8, int8_bwd))
            return _call(self.c_proj, x, int8, int8_bwd)
        h = self.act(tp.column_parallel(x, tp.f(x), self.c_fc, int8, int8_bwd))
        return tp.row_parallel(h, self.c_proj, int8, int8_bwd)


class Adapter(nn.Module):
    """Houlsby bottleneck adapter: LN -> down -> act -> up, + residual:
    ``up(act(down(ln(m)))) + m``.  ``down`` and ``up`` are biased ``Dense``
    layers (through ``_Linear``, so a round's cells round as one cell), the
    LayerNorm is fp32 whatever the block's ``ln_fp32``, as in the JAX
    ``Adapter``."""

    def __init__(self, width: int, adapter_dim: int = 64, act: str = "relu",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.act = ACT2FN[act]
        self.adapter_norm_before = LayerNorm(width, device=device)
        self.down = Dense(width, adapter_dim, dtype=dtype, device=device)
        self.up = Dense(adapter_dim, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(self.act(self.down(self.adapter_norm_before(x)))) + x


def _fit_phm_dim(requested: int, *features: int) -> int:
    """Largest n <= requested dividing every feature dim."""
    n = max(min([requested, *features]), 1)
    while any(f % n for f in features):
        n -= 1
    return n


class PHMDense(nn.Module):
    """PHM linear layer (Compacter building block): ``W`` (phm_dim, in/n,
    out/n), ``phm_rule`` (n, n, n) and the bias ``b``, stored in fp32 and cast
    to the compute ``dtype`` at use; ``y = x @ (sum_i rule_i (x) W_i) + b``.
    The bias is added after the product is rounded to the compute dtype
    (``ops.phm.phm_linear``), unlike ``Dense``, which adds it inside the
    GEMM."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        n = phm_dim
        if in_features % n or out_features % n:
            raise ValueError(f"phm_dim {n} must divide {in_features} and {out_features}")
        self.compute_dtype = dtype
        self.W = nn.Parameter(torch.empty(n, in_features // n, out_features // n,
                                          device=device))
        self.phm_rule = nn.Parameter(torch.empty(n, n, n, device=device))
        self.b = nn.Parameter(torch.zeros(out_features, device=device))
        limit = math.sqrt(3.0 * 2.0 / (0.5 * n * (in_features // n + out_features // n)))
        nn.init.uniform_(self.W, -limit, limit)  # flax variance_scaling(2, fan_avg, uniform)
        nn.init.normal_(self.phm_rule, std=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return phm_linear(x, self.phm_rule.to(dt), self.W.to(dt), self.b.to(dt))


class CompacterAdapter(nn.Module):
    """Hypercomplex adapter: LN -> PHM down (phm_dim 32) -> gelu_new -> PHM
    up (phm_dim 4), + residual.  Each phm_dim shrinks to the largest divisor
    of both features when the tower is narrower than 768 (``_fit_phm_dim``)."""

    def __init__(self, width: int, reduction: int = 12, phm_dim_down: int = 32,
                 phm_dim_up: int = 4, act: str = "gelu_new",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        down_size = width // reduction
        self.act = ACT2FN[act]
        self.adapter_norm_before = LayerNorm(width, device=device)
        self.down_phm = PHMDense(width, down_size, _fit_phm_dim(phm_dim_down, width, down_size),
                                 dtype=dtype, device=device)
        self.up_phm = PHMDense(down_size, width, _fit_phm_dim(phm_dim_up, down_size, width),
                               dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up_phm(self.act(self.down_phm(self.adapter_norm_before(x)))) + x


class DepthwiseConv(nn.Conv2d):
    """LePE's ``get_v``: a 3x3 depthwise convolution (SAME padding, bias) of
    (B, g, g, width) NHWC tokens, its weight stored in fp32 and cast to the
    compute ``dtype`` at use (flax ``nn.Conv(feature_group_count=width)``)."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(width, width, 3, padding=1, groups=width, device=device,
                         dtype=torch.float32)
        self.compute_dtype = dtype
        # flax's default lecun-normal kernel (fan in 3 x 3 x 1), zero bias
        std = math.sqrt(1.0 / 9.0) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        # one group a channel of the weight given (a tensor-parallel rank's
        # channels under functional_call)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt),
                     padding=1, groups=self.weight.shape[0])
        return y.permute(0, 2, 3, 1)


def _rpb_index(ndim: int) -> np.ndarray:
    """Swin-style relative position index for an ndim x ndim grid: entry
    (i, j) of the (g^2, g^2) result is the table row of patch j's position
    relative to patch i (the JAX package's ``_rpb_index``)."""
    coords = np.stack(np.meshgrid(np.arange(ndim), np.arange(ndim), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ndim - 1
    rel[:, :, 1] += ndim - 1
    rel[:, :, 0] *= 2 * ndim - 1
    return rel.sum(-1)


def _gather_slots(index: np.ndarray, rows: int) -> np.ndarray:
    """For each of ``rows`` table rows, the positions of ``index`` that read
    it, in order, padded with ``len(index)`` (a zero row past the end) to
    the most any row has: (rows, most)."""
    order = np.argsort(index, kind="stable")
    counts = np.bincount(index, minlength=rows)
    slots = np.full((rows, counts.max()), len(index), dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for row in range(rows):
        slots[row, :counts[row]] = order[starts[row]:starts[row] + counts[row]]
    return slots


class _TableGather(torch.autograd.Function):
    """``table[index]`` for a (T, H) table, whose backward sums the rows'
    cotangents through ``slots`` (``_gather_slots``) with a sum over a
    fixed axis: the same bits every run.  Autograd's own backward of the
    gather is an accumulating ``index_put_``, whose additions on the card
    land in an order that may change from run to run, and a captured step
    must equal its eager run bit for bit."""

    generate_vmap_rule = True

    @staticmethod
    def forward(table, index, slots):
        return table[index]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        padded = torch.cat([g, g.new_zeros(1, g.shape[-1])])
        return padded[slots].sum(1), None, None


# the LoRA-MoE gate's activation (``PEFTSpec.lora_moe_act``)
_MOE_ACT: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": lambda g: g,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": F.relu,
}


class MultiHeadAttention(nn.Module):
    """Packed-qkv attention with every attention-level PEFT hook.

    * lora: dq = (x @ A_q) @ B_q * alpha/r, no biases; with ``lora_moe`` the
      rank axis is viewed as (experts, group) and scaled per expert by the
      gate ``act(x @ G) * lambda`` (optionally softmaxed).
    * kron (KAdaptation): dq = x @ (sum_i rule_i (x) (W_left1_i W_right1_i)),
      dv likewise with ``W_left2`` / ``W_right2``; ``phmb`` is created and
      never read, as in the reference.
    * post_scale_q (CLIP LoRA parity, any delta): q is scaled by
      1/sqrt(head_dim) before the delta is added, and attention then runs at
      scale 1, i.e. softmax((q/sqrt(d) + dq) k^T).
    * lora_ref_reshape (``PEFT.LORA_REF_RESHAPE``, LoRA only): each delta is
      added after the head split in the executed reference's flat layout.
    * lepe_ref_qkv (with ``lepe``): q, k and v are replaced by the
      reference's flat scramble of the raw projection.
    * shared_qkv: one ``Adapter(head_dim, head_dim // 2)`` on the per-head
      q, k and v.
    * lepe: the depthwise 3x3 ``get_v`` of v over the ``grid_size`` patch
      grid, added to the attention output after the ``n_prefix`` tokens.
    * rpb: ``relative_position_bias_table`` ((2g - 1)^2, H), zeros, fp32;
      gathered by ``_rpb_index(g)`` and cast to the compute dtype, it is the
      (H, N, N) attention bias of the patch tokens, zero on the ``n_prefix``
      rows and columns.  g is ``spec.rpb_ndim``, or ``grid_size`` when that
      is -1; another g than the grid raises, as in the JAX package.
    * ``causal`` (the CLIP text tower): the (H, N, N) bias of -1e30 above
      the diagonal, built in fp32 and cast to the compute dtype, added to
      any other bias.
    * ``int8=True`` builds ``in_proj`` / ``out_proj`` (those named in
      ``int8_targets``) as ``Int8Dense``; the PEFT deltas stay dense.
    * ``int8_attn`` (``TPU.INT8_ATTN``): with no bias and the calibrated
      scales present (the non-persistent buffers ``s_q``, ``s_k``, ``s_v``,
      None until a step substitutes them by name), the attention is
      ``ops.attention.int8_attention``, with ``int8_attn_pv`` its int8 P V
      too; otherwise the attention below.  Inside
      ``collect_activation_stats`` the forward records the absmax of the
      per-head q, k and v.
    * ``softmax_fp32`` (False: ``TPU.BF16_SOFTMAX``) and ``attn_batch_chunk``
      (``TPU.ATTN_BATCH_CHUNK``) go to ``ops.attention.multi_head_attention``.
    """

    def __init__(self, width: int, heads: int, spec: PEFTSpec = PEFTSpec(), grid_size: int = 0,
                 n_prefix: int = 1, causal: bool = False, int8: bool = False,
                 int8_attn: bool = False, int8_attn_pv: bool = False,
                 int8_targets: Sequence[str] = INT8_TARGET_MODULES,
                 softmax_fp32: bool = True, attn_batch_chunk: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        check_spec(spec)
        self.heads = heads
        self.spec = spec
        self.grid_size = int(grid_size)
        self.n_prefix = int(n_prefix)
        self.causal = bool(causal)
        self.int8_attn = bool(int8_attn)
        self.int8_attn_pv = bool(int8_attn_pv)
        for name in ("s_q", "s_k", "s_v"):
            self.register_buffer(name, None, persistent=False)
        self._stats = None  # (store, module name) inside collect_activation_stats
        self.compute_dtype = dtype
        self.softmax_fp32 = bool(softmax_fp32)
        self.attn_batch_chunk = int(attn_batch_chunk)
        self.in_proj = _dense_for("in_proj", int8, int8_targets)(
            width, 3 * width, dtype=dtype, device=device)
        self.lora_targets = tuple(spec.lora_targets) if spec.attn_delta == "lora" else ()
        for t in self.lora_targets:
            if t not in ("q", "k", "v"):
                raise ValueError(f"unknown LoRA target {t!r}")
            a1 = Dense(width, spec.lora_rank, bias=False, dtype=dtype, device=device)
            nn.init.normal_(a1.weight, std=0.02)  # the JAX init: a fresh delta is 0
            self.add_module(f"{t}_adapter1", a1)
            if spec.lora_moe:
                experts = max(spec.lora_rank // spec.lora_moe_group, 1)
                gate = Dense(width, experts, bias=False, dtype=dtype, device=device)
                nn.init.normal_(gate.weight, std=0.02)
                self.add_module(f"{t}_moe_adapter1", gate)
            a2 = Dense(spec.lora_rank, width, bias=False, dtype=dtype, device=device)
            nn.init.zeros_(a2.weight)
            self.add_module(f"{t}_adapter2", a2)
        if spec.attn_delta == "kron":
            pn = spec.phm_dim
            if width % pn:
                raise ValueError(f"phm_dim {pn} must divide width {width}")

            def normal(*shape):
                return nn.Parameter(torch.randn(*shape, device=device) * 0.01)

            self.phm_rule = normal(pn, pn, pn)
            self.phmb = nn.Parameter(torch.zeros(width, device=device))
            for idx in (1, 2):
                setattr(self, f"W_left{idx}", normal(pn, width // pn, spec.phm_rank))
                setattr(self, f"W_right{idx}", normal(pn, spec.phm_rank, width // pn))
        if spec.attn_adapter == "shared_qkv":
            hd = width // heads
            self.qkv_adapter = Adapter(hd, hd // 2, act="relu", dtype=dtype, device=device)
        elif spec.attn_adapter != "none":
            raise ValueError(f"unknown attn_adapter {spec.attn_adapter!r}")
        if spec.lepe:
            if self.grid_size <= 0:
                raise ValueError("LePE needs a patch grid (grid_size > 0)")
            self.get_v = DepthwiseConv(width, dtype=dtype, device=device)
        if spec.attn_bias == "rpb":
            g = spec.rpb_ndim if spec.rpb_ndim > 0 else self.grid_size
            if g <= 0:
                raise ValueError("RPB needs a patch grid (grid_size > 0)")
            if g != self.grid_size:
                raise ValueError(
                    f"RPB_NDIM={g} does not match the {self.grid_size}x{self.grid_size} patch "
                    "grid (the reference's fixed ndim=7 has the same constraint); use "
                    "RPB_NDIM=-1 for auto")
            rows = (2 * g - 1) ** 2
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(rows, heads, device=device))
            index = _rpb_index(g).reshape(-1)
            self.register_buffer("rpb_index", torch.as_tensor(index, device=device),
                                 persistent=False)
            self.register_buffer("rpb_slots", torch.as_tensor(_gather_slots(index, rows),
                                                              device=device), persistent=False)
        self.out_proj = _dense_for("out_proj", int8, int8_targets)(
            width, width, dtype=dtype, device=device)

    def _lora_delta(self, x: torch.Tensor, t: str, f: Callable = None) -> torch.Tensor:
        """The LoRA delta of target ``t``; ``f`` (tensor parallelism:
        Megatron's ``f``) stands before B, whose rows are the rank's, so that
        A's (and the gate's) gradient sums over the ranks' heads."""
        spec = self.spec
        a = getattr(self, f"{t}_adapter1")(x)
        if spec.lora_moe:
            g = getattr(self, f"{t}_moe_adapter1")(x)
            g = _MOE_ACT[spec.lora_moe_act](g) * spec.lora_moe_lambda
            if spec.lora_moe_softmax:
                g = torch.softmax(g, dim=-1)
            a = (a.unflatten(-1, (g.shape[-1], spec.lora_moe_group)) * g[..., None]).flatten(-2)
        if f is not None:
            a = f(a)
        return getattr(self, f"{t}_adapter2")(a) * (spec.lora_alpha / spec.lora_rank)

    def _kron_deltas(self, x: torch.Tensor, tp: Optional[TensorParallel] = None
                     ) -> Dict[str, torch.Tensor]:
        """The q and v deltas ``x @ H``; under tensor parallelism the
        columns of each (d, d) ``H`` that add to this rank's heads."""
        dt = self.compute_dtype
        rule = self.phm_rule.to(dt)
        deltas = {}
        for idx, t in enumerate(("q", "v"), start=1):
            h = factorized_phm_weight(rule, getattr(self, f"W_left{idx}").to(dt),
                                      getattr(self, f"W_right{idx}").to(dt))
            if tp is not None:
                h = tp.own_heads(h, 1)
            deltas[t] = torch.matmul(x, h.to(x.dtype))
        return deltas

    def _rpb_bias(self) -> torch.Tensor:
        """The (H, N, N) relative position bias in the compute dtype, zero on
        the ``n_prefix`` rows and columns; H is the table's heads (under
        tensor parallelism this rank's, the table cut by heads)."""
        table = self.relative_position_bias_table
        h, p, g2 = table.shape[-1], self.n_prefix, self.grid_size**2
        patch = _TableGather.apply(table, self.rpb_index, self.rpb_slots)
        patch = patch.reshape(g2, g2, h).permute(2, 0, 1).to(self.compute_dtype)
        return F.pad(patch, (p, 0, p, 0))

    def forward(self, x: torch.Tensor, int8: bool = False, int8_bwd: bool = False) -> torch.Tensor:
        """Under ``tensor_parallel`` each leaf holds this rank's part
        (``parallel.tp_cut``): ``in_proj`` its heads of q, of k and of v,
        each LoRA B the rows it adds to, ``out_proj`` those heads' columns,
        the RPB table those heads, LePE's ``get_v`` their v channels; every
        other leaf is whole.  Megatron's ``f`` stands at ``in_proj``'s input
        and at each LoRA B's (A's gradient sums over the ranks' heads), ``g``
        after ``out_proj``.  Every hook runs on this rank's heads: the kron
        deltas are the columns of H of those heads, the shared qkv adapter
        and RPB's bias (K1-K3, K7) take those heads, LePE adds its v channels
        before the row-parallel product.  The reference layouts
        (``lora_ref_reshape``, ``lepe_ref_qkv``) scramble every head, so the
        rank gathers every head's delta or projection first
        (``comm.cat_heads``) and keeps its heads.  The int8 GEMMs are the
        unsplit ones bit for bit (``Int8Dense.column_parallel`` /
        ``row_parallel``); int8 attention reads the calibrated scales, which
        are maxima over every head.  Under sequence parallelism ``x`` is this
        rank's tokens and ``f`` (the token all-gather) stands once, at the
        region's entry: LoRA A and the kron deltas run on the gathered
        tokens."""
        tp = _TP
        xin = x if tp is None else tp.f(x)  # under sequence parallelism: every token
        b, n, d = xin.shape
        hd = d // self.heads
        spec = self.spec
        scale = hd**-0.5
        if tp is None:
            qkv = _call(self.in_proj, xin, int8, int8_bwd)
        else:
            qkv = tp.column_parallel(x, xin, self.in_proj, int8, int8_bwd)
        q, k, v = qkv.chunk(3, dim=-1)
        local = q.shape[-1]  # this rank's heads' width under tensor parallelism
        h = local // hd

        if spec.attn_delta == "kron":
            deltas = self._kron_deltas(xin, tp)
        else:
            lora_x, lora_f = (x, tp.f) if tp is not None and not tp.seq else (xin, None)
            deltas = {t: self._lora_delta(lora_x, t, lora_f) for t in self.lora_targets}

        if spec.attn_delta != "none" and spec.lora_post_scale_q:
            q = q * scale
            attn_scale = 1.0
        else:
            attn_scale = scale

        def split_heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, n, h, hd).transpose(1, 2)

        ref_reshape = spec.attn_delta == "lora" and spec.lora_ref_reshape
        qkv_of = {"q": q, "k": k, "v": v}
        if not ref_reshape:
            for t, dl in deltas.items():
                qkv_of[t] = qkv_of[t] + dl
        heads_of = {t: split_heads(y) for t, y in qkv_of.items()}
        if ref_reshape:
            # the executed reference's layout (lora_model.py:730-731): the
            # seq-first (N, B, C) delta reshaped flat into (B*H, N, hd),
            # which scrambles batch, sequence and head unless B = H = 1
            for t, dl in deltas.items():
                if tp is not None:
                    dl = tp.comm.cat_heads(dl)
                dl = dl.transpose(0, 1).reshape(b, self.heads, n, hd)
                heads_of[t] = heads_of[t] + (dl if tp is None else tp.own_heads(dl, 1))
        if spec.lepe and spec.lepe_ref_qkv:
            # the executed reference's LePE layout (LePE.py:120-123): the
            # (3, B, N, C) permutation of the raw projection reshaped flat to
            # (B, N, 3, H, hd), which scrambles q, k and v across the batch;
            # get_v below still reads the clean v
            raw = qkv if tp is None else torch.cat(
                [tp.comm.cat_heads(t) for t in qkv.chunk(3, dim=-1)], dim=-1)
            scr = raw.reshape(b, n, 3, d).permute(2, 0, 1, 3).reshape(b, n, 3, self.heads, hd)
            heads_of = dict(zip("qkv", scr.permute(2, 0, 3, 1, 4).unbind(0)))
            if tp is not None:
                heads_of = {t: tp.own_heads(y, 1) for t, y in heads_of.items()}
        if spec.attn_adapter == "shared_qkv":
            heads_of = {t: self.qkv_adapter(y) for t, y in heads_of.items()}

        bias = self._rpb_bias() if spec.attn_bias == "rpb" else None
        if self.causal:
            causal = torch.full((n, n), -1e30, device=x.device).triu(1).to(self.compute_dtype)
            bias = causal.expand(h, n, n).contiguous() if bias is None else bias + causal
        qh, kh, vh = (heads_of[t].contiguous() for t in "qkv")
        if self.int8_attn and self._stats is not None:
            store, name = self._stats
            for t, y in (("q", qh), ("k", kh), ("v", vh)):
                amax = y.detach().to(torch.float32).abs().max()
                key = f"{name}.amax_{t}"
                store[key] = amax if key not in store else torch.maximum(store[key], amax)
        if self.int8_attn and bias is None and self.s_q is not None:
            out = int8_attention(qh, kh, vh, self.s_q, self.s_k, self.s_v, attn_scale,
                                 self.softmax_fp32, self.int8_attn_pv)
        else:
            out = multi_head_attention(
                qh, kh, vh, bias=bias, scale=attn_scale, softmax_fp32=self.softmax_fp32,
                batch_chunk=self.attn_batch_chunk,
            )
        out = out.transpose(1, 2).reshape(b, n, local)
        if spec.lepe:
            g, p = self.grid_size, self.n_prefix
            lepe = self.get_v(qkv_of["v"][:, p:, :].reshape(b, g, g, local)).reshape(b, g * g,
                                                                                       local)
            out = torch.cat([out[:, :p], out[:, p:] + lepe.to(out.dtype)], dim=1)
        if tp is not None:
            return tp.row_parallel(out, self.out_proj, int8, int8_bwd)
        return _call(self.out_proj, out, int8, int8_bwd)


class Block(nn.Module):
    """Pre-LN transformer block with the post-MLP adapter hook:
    x = x + drop_path(attn(ln_1(x))); m = mlp(ln_2(x));
    x = x + drop_path(adapter(m)) (the adapter adds its own + m), or
    x + drop_path(m) without an adapter or in a block outside
    ``spec.adapter_layers`` (AdapterDrop).  The adapter's leaves exist in
    every block either way; a block that does not use it does not run it.

    ``drop_path`` (stochastic depth) acts in training mode only: each sample
    keeps its branch with probability ``1 - drop_path`` and is divided by
    it, drawn from the explicit ``generator``.  ``ln_fp32=False`` normalizes
    in the activations' dtype (the throughput mode of bf16 training).
    ``grid_size`` and ``n_prefix`` (the class token and the prompts) place
    LePE's patch grid among the tokens.

    ``int8``: the frozen tower's GEMMs (``int8_targets``) run int8 on eval
    forwards only; a training forward is then the dense path bit for bit
    (round has a zero gradient).  ``int8_train``: they run int8 on training
    forwards too, through the differentiable ops.  A flax module picks the
    class per call; here the choice is made at call time from
    ``self.training``."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, act: str = "gelu",
                 spec: PEFTSpec = PEFTSpec(), layer_idx: int = 0, grid_size: int = 0,
                 n_prefix: int = 1, causal: bool = False, drop_path: float = 0.0,
                 ln_fp32: bool = True,
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
            width, heads, spec=spec, grid_size=grid_size, n_prefix=n_prefix, causal=causal,
            int8=any_int8,
            int8_attn=int8_attn, int8_attn_pv=int8_attn_pv, int8_targets=int8_targets,
            softmax_fp32=softmax_fp32, attn_batch_chunk=attn_batch_chunk, dtype=dtype,
            device=device)
        self.ln_2 = LayerNorm(width, compute_fp32=ln_fp32, device=device)
        self.mlp = Mlp(width, int(width * mlp_ratio), act=act, int8=any_int8,
                       int8_targets=int8_targets, dtype=dtype, device=device)
        if spec.adapter == "houlsby":
            self.adapter = Adapter(width, spec.adapter_dim, act=spec.adapter_act, dtype=dtype,
                                   device=device)
        elif spec.adapter == "compacter":
            self.compacter = CompacterAdapter(
                width, reduction=spec.compacter_reduction,
                phm_dim_down=spec.compacter_phm_dim_down, phm_dim_up=spec.compacter_phm_dim_up,
                act=spec.compacter_act, dtype=dtype, device=device)
        elif spec.adapter != "none":
            raise ValueError(f"unknown adapter {spec.adapter!r}")
        # the adapter module this block runs after its MLP (None: none runs)
        self.adapter_name = {"houlsby": "adapter", "compacter": "compacter"}.get(spec.adapter)
        if spec.adapter_layers is not None and layer_idx not in spec.adapter_layers:
            self.adapter_name = None

    def _drop_path(self, x: torch.Tensor) -> torch.Tensor:
        if self.drop_path == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise ValueError("training-mode drop_path draws from an explicit torch.Generator")
        keep = 1.0 - self.drop_path
        draw = _dist.draw_rows(lambda s: torch.rand(s, generator=self.generator,
                                                    device=self.generator.device),
                               (x.shape[0], 1, 1))
        return x * (draw < keep).to(device=x.device, dtype=x.dtype) / keep

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deterministic = not self.training
        int8 = (self.int8 and deterministic) or self.int8_train
        int8_bwd = self.int8_train and not (self.int8 and deterministic)
        x = x + self._drop_path(self.attn(self.ln_1(x), int8, int8_bwd))
        m = self.mlp(self.ln_2(x), int8, int8_bwd)
        if self.adapter_name is not None:
            m = getattr(self, self.adapter_name)(m)
        return x + self._drop_path(m)
