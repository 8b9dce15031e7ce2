"""int8 weight + activation matmul for the frozen tower.

Counterpart of ``peft_vit_tpu/ops/int8.py``.  Weights take a per-output-channel
absmax scale (symmetric, no zero point), activations a per-row dynamic absmax
scale or one calibrated static scale; the product accumulates in int32 and is
rescaled in fp32.

Layout.  A weight is the port's ``Dense.weight``, (N, K) = (out, in), the
transpose of the JAX package's (K, N) ``kernel``.  ``quantize_cols`` takes
that (N, K) weight and returns ``w_i8`` (N, K), K contiguous, and ``s_w``
(N,): the JAX function's per-column scale is a per-row one here.  The
transposed pair of the int8 dx product is ``quantize_cols(weight.t())``:
``wt_i8`` (K, N), N contiguous, one scale per input feature.

* ``quantize_rows`` / ``quantize_cols`` / ``quantize_static`` and the plain
  forwards ``_prequant_forward`` / ``_static_forward`` repeat the JAX
  arithmetic to the letter (fp32; ``absmax / 127`` floored at 1e-8;
  ``round(x / scale)`` half to even; ``(acc * s_x) * s_w``), so their codes,
  scales and outputs equal the JAX package's bit for bit.  The s8 x s8 sum is
  taken in float64, where it is exact (|acc| <= 127 * 127 * K < 2^53), and
  rounded to fp32 as an int32 would be.
* ``int8_gemm_dynamic`` / ``int8_gemm_static`` are the wrappers of the
  hand-written CUDA kernel ``csrc/int8_gemm.cu``, the counterpart of the
  Pallas ``_prequant_kernel``: quantize, s8 x s8 -> s32 product (``wgmma``,
  the weight streamed by TMA) and rescale in one launch.  A CUDA tensor
  launches the kernel or raises; a CPU tensor runs the plain forward.  Each
  counts its launches in ``.launches``.  Each launch is a registered op of
  ``peft_vit_tpu_torch::`` (``ops._library``): CUDA the launch, CPU the plain
  version, fake the shapes.
* ``int8_matmul`` is the no-grad op; ``int8_matmul_bf16_bwd``,
  ``int8_prequant_matmul``, ``int8_prequant_matmul_i8bwd``,
  ``int8_static_matmul`` and ``int8_static_matmul_i8bwd`` are differentiable:
  an int8 forward with the dense ``dx = g @ w`` and ``dw = g^T x`` behind it,
  or, for the ``_i8bwd`` pair, ``dx`` through the kernel against the
  transposed quantized weight.  The dense products stay ``torch.matmul``.
* ``activation_scales_from_stats`` and ``quantize_frozen_tree`` work on
  name-keyed dicts of tensors (``models.layers.Int8Dense`` consumes them).

Under tensor parallelism a GEMM that contracts over a cut K (the
row-parallel ``out_proj`` / ``c_proj`` forward, the column-parallel
``in_proj`` / ``c_fc`` int8 dx) equals the unsplit kernel bit for bit when
every code does: each row's scale is taken over the whole K (the rank's
partial row absmax, ``int8_row_absmax``, then the model group's maximum),
the ranks' int32 accumulators are summed exactly, and the rescale follows
the sum.  ``int8_gemm_partial`` is that K-cut form of the kernel (the row
scale given, the int32 accumulator out); ``int8_row_parallel`` and
``int8_column_parallel_dx`` are the two ops, on the model group's
collectives ``comm`` (``parallel.ModelComm``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from . import _build
from ._library import kernel_op

#: module names whose weight is routed through ``Int8Dense`` by the models
#: (the frozen tower's GEMMs: packed qkv, out proj and the MLP pair)
INT8_TARGET_MODULES = ("in_proj", "out_proj", "c_fc", "c_proj")

KERNEL_K_MULTIPLE = 64  # the codes' 128-byte slabs: the last one full or half
KERNEL_MAX_K = 3072  # 64 rows of codes (64 x K bytes) and a two-stage weight ring
                     # (2 x 16 KB) must fit a block's shared memory
KERNEL_N_MULTIPLE = 64


# ---------------------------------------------------------------- plain versions


def _div(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t / divisor`` as an IEEE division on every device.  PyTorch divides a
    CUDA tensor by a Python number by multiplying with its reciprocal, which
    is a last-bit different scale now and then, and a different code where
    the scale then rounds a value the other way."""
    return t / torch.full_like(t, divisor)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 over the last axis: ``(values_i8, scale (..., 1))``."""
    xf = x.to(torch.float32)
    scale = _div(xf.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-8)
    return torch.round(xf / scale).to(torch.int8), scale


def quantize_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel absmax int8 of an (N, K) weight (K contracts):
    ``(w_i8 (N, K) contiguous, scale (N,))``."""
    w_i8, scale = quantize_rows(w)
    return w_i8.contiguous(), scale.reshape(-1)


def quantize_static(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """int8 quantize with a static per-tensor scale: elementwise and
    saturating (values beyond the calibrated range clip to +-127)."""
    xf = x.to(torch.float32) / s_x
    return torch.round(xf).clamp(-127.0, 127.0).to(torch.int8)


def _s8_dot(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """``x_i8 (..., K) . w_i8 (N, K)^T`` summed exactly (in float64) and
    rounded to fp32 as the int32 sum would be."""
    acc = torch.matmul(x_i8.to(torch.float64), w_i8.to(torch.float64).t())
    return acc.to(torch.float32)


def _prequant_forward(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version, dynamic variant: per-row quantize of x,
    the int8 product with the pre-quantized weight, the rescale."""
    x_i8, s_x = quantize_rows(x)
    out = _s8_dot(x_i8, w_i8) * s_x * s_w
    return out.to(x.dtype)


def _static_forward(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor,
                    s_x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version, static variant."""
    out = _s8_dot(quantize_static(x, s_x), w_i8) * s_x * s_w
    return out.to(x.dtype)


# ---------------------------------------------------------------- the kernel's wrappers

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the library's functions: (argtypes, restype)
_SIGNATURES = {
    # device, x, w_i8, s_w, s_x, out, M, K, N, is_bf16, stream
    "int8_gemm": ([_INT, *[_PTR] * 5, *[_INT] * 4, _PTR], _INT),
    "int8_gemm_error_string": ([_INT], ctypes.c_char_p),
    "int8_gemm_smem_bytes": ([_INT], _INT),  # K -> bytes
    "int8_gemm_stages": ([_INT], _INT),  # K -> stages
    # device, x, w_i8, s (row scales or the static one), out (int32), M, K, N,
    # is_bf16, is_static, stream
    "int8_gemm_partial": ([_INT, *[_PTR] * 4, *[_INT] * 5, _PTR], _INT),
    # device, x, amax (fp32), M, K, is_bf16, stream
    "int8_row_absmax": ([_INT, _PTR, _PTR, *[_INT] * 3, _PTR], _INT),
}


def _kernel_library() -> ctypes.CDLL:
    """``csrc/int8_gemm.cu`` built and loaded, its functions' signatures set."""
    lib = _build.load("int8_gemm")
    if not getattr(lib, "_argtypes_set", False):
        for fn, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        lib._argtypes_set = True
    return lib


def _check_operands(x, w_i8, s_w, s_x) -> None:
    if x.dim() < 1 or w_i8.dim() != 2 or x.shape[-1] != w_i8.shape[1]:
        raise ValueError(f"x (..., K) and w_i8 (N, K) do not agree: {tuple(x.shape)} and "
                         f"{tuple(w_i8.shape)}")
    if w_i8.dtype != torch.int8:
        raise TypeError(f"w_i8 must be int8, got {w_i8.dtype}")
    if s_w.numel() != w_i8.shape[0]:
        raise ValueError(f"s_w must hold one scale per output channel ({w_i8.shape[0]}), got "
                         f"shape {tuple(s_w.shape)}")
    if s_x is not None and s_x.numel() != 1:
        raise ValueError(f"s_x must be one scale, got shape {tuple(s_x.shape)}")
    for name, t in (("w_i8", w_i8), ("s_w", s_w), ("s_x", s_x)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _check_kernel_operands(x: torch.Tensor, w_i8: Optional[torch.Tensor] = None) -> None:
    """What the kernel asks of x (..., K) and of the codes (N, K), if any:
    checked by the launch, before it allocates (``_aligned`` after)."""
    if w_i8 is not None:
        _check_shape(w_i8)
    if x.device.type != "cuda":
        raise ValueError(f"the int8 GEMM runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bfloat16 or float32 activations, got {x.dtype}")


def _rows_on_card(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (..., K) bf16 or fp32 on the card as contiguous (M, K) rows."""
    x2d = x.reshape(-1, k)
    if not x2d.is_contiguous():
        # a cotangent arrives with whatever strides its producer left
        x2d = x2d.contiguous()
    if x2d.shape[0] == 0:
        raise ValueError("empty activation")
    return x2d


def _check_shape(w_i8: torch.Tensor) -> None:
    n, k = w_i8.shape
    if k % KERNEL_K_MULTIPLE or k > KERNEL_MAX_K or n % KERNEL_N_MULTIPLE:
        raise ValueError(
            f"the kernel takes K a multiple of {KERNEL_K_MULTIPLE} up to {KERNEL_MAX_K} and N a "
            f"multiple of {KERNEL_N_MULTIPLE}, got K = {k}, N = {n}")
    if not w_i8.is_contiguous():
        raise ValueError("w_i8 must be contiguous (N, K)")


def _aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def _check_err(lib, fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.int8_gemm_error_string(err).decode()}")


def _launch(x, w_i8, s_w, s_x) -> torch.Tensor:
    """One launch of the kernel: x (..., K) bf16 or fp32 on the card."""
    _check_kernel_operands(x, w_i8)
    n, k = w_i8.shape
    x2d = _rows_on_card(x, k)
    scales = [s_w.to(torch.float32).reshape(-1).contiguous()]
    if s_x is not None:
        scales.append(s_x.to(torch.float32).reshape(1))
    out = torch.empty((x2d.shape[0], n), dtype=x.dtype, device=x.device)
    _aligned(x=x2d, w_i8=w_i8, out=out)
    lib = _kernel_library()
    err = lib.int8_gemm(
        _device_index(x), x2d.data_ptr(), w_i8.data_ptr(), scales[0].data_ptr(),
        None if s_x is None else scales[1].data_ptr(), out.data_ptr(),
        x2d.shape[0], k, n, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_err(lib, "int8_gemm", err)
    return out.reshape(*x.shape[:-1], n)


def int8_gemm_dynamic(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """``rescale(quantize_rows(x) . w_i8^T)``: x (..., K), w_i8 (N, K) int8,
    s_w (N,) -> (..., N) in x's dtype.

    CUDA tensors launch ``csrc/int8_gemm.cu`` on the current stream and count
    the launch in ``int8_gemm_dynamic.launches``; an operand the kernel does
    not take raises (K a multiple of 64 up to 3072, N a multiple of 64, bf16
    or fp32).  CPU tensors run ``_prequant_forward`` and launch nothing.
    """
    _check_operands(x, w_i8, s_w, None)
    return _GEMM_DYNAMIC(x, w_i8, s_w)


def _dynamic_launch(x, w_i8, s_w) -> torch.Tensor:
    out = _launch(x, w_i8, s_w, None)
    int8_gemm_dynamic.launches += 1
    return out


int8_gemm_dynamic.launches = 0


def _gemm_out(x: torch.Tensor, w_i8: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """The (..., N) result of x (..., K) and w_i8 (N, K), shape and dtype only."""
    return x.new_empty((*x.shape[:-1], w_i8.shape[0]), dtype=dtype or x.dtype)


def _gemm_flops(x, w_i8, *args, out_shape=None, **kw) -> int:
    """2 M K N: the s8 x s8 product (the quantize and rescale are not products)."""
    return 2 * math.prod(x) * w_i8[0]


_GEMM_DYNAMIC = kernel_op(
    "int8_gemm_dynamic", "(Tensor x, Tensor w_i8, Tensor s_w) -> Tensor",
    cpu=_prequant_forward, cuda=_dynamic_launch,
    fake=lambda x, w_i8, s_w: _gemm_out(x, w_i8), flops=_gemm_flops,
)


def int8_gemm_static(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor,
                     s_x: torch.Tensor) -> torch.Tensor:
    """``rescale(quantize_static(x, s_x) . w_i8^T)`` with the one-element
    tensor ``s_x`` read on the device.  As ``int8_gemm_dynamic``; counts in
    ``int8_gemm_static.launches``; CPU tensors run ``_static_forward``."""
    _check_operands(x, w_i8, s_w, s_x)
    return _GEMM_STATIC(x, w_i8, s_w, s_x)


def _static_launch(x, w_i8, s_w, s_x) -> torch.Tensor:
    out = _launch(x, w_i8, s_w, s_x)
    int8_gemm_static.launches += 1
    return out


int8_gemm_static.launches = 0

_GEMM_STATIC = kernel_op(
    "int8_gemm_static", "(Tensor x, Tensor w_i8, Tensor s_w, Tensor s_x) -> Tensor",
    cpu=_static_forward, cuda=_static_launch,
    fake=lambda x, w_i8, s_w, s_x: _gemm_out(x, w_i8), flops=_gemm_flops,
)


def _row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """``int8_row_absmax``'s plain version: max |x| over the last axis, fp32."""
    return x.to(torch.float32).abs().amax(dim=-1)


def _partial_plain(x: torch.Tensor, w_i8: torch.Tensor, s_rows: Optional[torch.Tensor],
                   s_x: Optional[torch.Tensor]) -> torch.Tensor:
    """``int8_gemm_partial``'s plain version: the codes of x at the given row
    scales (``quantize_rows``'s rounding, no clip) or at the static scale
    (``quantize_static``), and their exact int32 product with ``w_i8``."""
    if s_x is not None:
        x_i8 = quantize_static(x, s_x)
    else:
        x_i8 = torch.round(x.to(torch.float32) / s_rows.unsqueeze(-1)).to(torch.int8)
    acc = torch.matmul(x_i8.to(torch.float64), w_i8.to(torch.float64).t())
    return acc.to(torch.int32)


def row_scales(amax: torch.Tensor) -> torch.Tensor:
    """The dynamic row scales of a row absmax: ``max(amax / 127, 1e-8)``, the
    kernel's and ``quantize_rows``'s arithmetic."""
    return _div(amax.to(torch.float32), 127.0).clamp_min(1e-8)


def int8_row_absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the last axis (K), fp32, of x (..., K) -> (...): K6's
    row-quantize prologue alone (``csrc/int8_gemm.cu::int8_row_absmax``), the
    rank's part of a row scale whose K is cut over the model group.  CUDA
    tensors launch the kernel and count in ``int8_row_absmax.launches``
    (K a multiple of 8); CPU tensors run ``_row_absmax_plain``."""
    return _ROW_ABSMAX(x)


def _row_absmax_launch(x: torch.Tensor) -> torch.Tensor:
    k = x.shape[-1]
    if k % 8:
        raise ValueError(f"the row absmax takes K a multiple of 8, got {k}")
    _check_kernel_operands(x)
    x2d = _rows_on_card(x, k)
    out = torch.empty(x2d.shape[0], dtype=torch.float32, device=x.device)
    _aligned(x=x2d)
    lib = _kernel_library()
    err = lib.int8_row_absmax(_device_index(x), x2d.data_ptr(), out.data_ptr(), x2d.shape[0], k,
                              int(x.dtype == torch.bfloat16),
                              torch.cuda.current_stream(x.device).cuda_stream)
    _check_err(lib, "int8_row_absmax", err)
    int8_row_absmax.launches += 1
    return out.reshape(x.shape[:-1])


int8_row_absmax.launches = 0

_ROW_ABSMAX = kernel_op(
    "int8_row_absmax", "(Tensor x) -> Tensor",
    cpu=_row_absmax_plain, cuda=_row_absmax_launch,
    fake=lambda x: x.new_empty(x.shape[:-1], dtype=torch.float32),
    flops=lambda x, *args, out_shape=None, **kw: 0,  # a reduction, no product
)


def int8_gemm_partial(x: torch.Tensor, w_i8: torch.Tensor, s_rows: Optional[torch.Tensor] = None,
                      s_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6's K-cut form: ``quantize(x) . w_i8^T`` as the exact int32
    accumulator, not rescaled, x (..., K), w_i8 (N, K) -> (..., N) int32.  The
    codes take either the given row scales ``s_rows`` (...,) fp32 (a row
    scale over a K that is cut: the model group's) or the static scale
    ``s_x`` (one element), exactly one of them.  CUDA tensors launch
    ``csrc/int8_gemm.cu`` (the same kernel, its external-scale and int32
    template instantiations) and count in ``int8_gemm_partial.launches``;
    CPU tensors run ``_partial_plain``."""
    if (s_rows is None) == (s_x is None):
        raise ValueError("int8_gemm_partial takes the row scales or the static scale")
    if x.dim() < 1 or w_i8.dim() != 2 or x.shape[-1] != w_i8.shape[1]:
        raise ValueError(f"x (..., K) and w_i8 (N, K) do not agree: {tuple(x.shape)} and "
                         f"{tuple(w_i8.shape)}")
    if w_i8.dtype != torch.int8:
        raise TypeError(f"w_i8 must be int8, got {w_i8.dtype}")
    if s_rows is not None and tuple(s_rows.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"s_rows must hold one scale a row of x {tuple(x.shape[:-1])}, got "
                         f"{tuple(s_rows.shape)}")
    if s_x is not None and s_x.numel() != 1:
        raise ValueError(f"s_x must be one scale, got shape {tuple(s_x.shape)}")
    return _GEMM_PARTIAL(x, w_i8, s_rows, s_x)


def _partial_launch(x, w_i8, s_rows, s_x) -> torch.Tensor:
    _check_kernel_operands(x, w_i8)
    n, k = w_i8.shape
    x2d = _rows_on_card(x, k)
    s = (s_x.to(torch.float32).reshape(1) if s_x is not None
         else s_rows.to(torch.float32).reshape(-1).contiguous())
    out = torch.empty((x2d.shape[0], n), dtype=torch.int32, device=x.device)
    _aligned(x=x2d, w_i8=w_i8, out=out)
    lib = _kernel_library()
    err = lib.int8_gemm_partial(_device_index(x), x2d.data_ptr(), w_i8.data_ptr(), s.data_ptr(),
                                out.data_ptr(), x2d.shape[0], k, n,
                                int(x.dtype == torch.bfloat16), int(s_x is not None),
                                torch.cuda.current_stream(x.device).cuda_stream)
    _check_err(lib, "int8_gemm_partial", err)
    int8_gemm_partial.launches += 1
    return out.reshape(*x.shape[:-1], n)


int8_gemm_partial.launches = 0

_GEMM_PARTIAL = kernel_op(
    "int8_gemm_partial", "(Tensor x, Tensor w_i8, Tensor? s_rows, Tensor? s_x) -> Tensor",
    cpu=_partial_plain, cuda=_partial_launch,
    fake=lambda x, w_i8, s_rows, s_x: _gemm_out(x, w_i8, torch.int32), flops=_gemm_flops,
)


# ---------------------------------------------------------------- the ops


def int8_matmul(x: torch.Tensor, w: torch.Tensor, w_i8: Optional[torch.Tensor] = None,
                s_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w^T`` through the int8 path, for no-grad forwards: x (..., K) of
    any float dtype, w (N, K).  The weight is quantized per call in plain
    PyTorch unless its codes are given (``w_i8``, ``s_w`` from
    ``quantize_cols``: a serving session quantizes once, at load); returns
    x's dtype (..., N)."""
    with torch.no_grad():
        return _Int8Matmul.apply(x, w, w_i8, s_w, None, None, None)


class _Int8Matmul(torch.autograd.Function):
    """The differentiable ops' shared body.  Forward: the dynamic kernel, or
    the static one when ``s_x`` is given, on ``w_i8`` / ``s_w`` (quantized here
    from ``w`` when absent).  Backward: ``dx`` through the dynamic kernel
    against ``wt_i8`` / ``s_wt`` when given, else the dense ``g @ w``; ``dw``
    the dense ``g^T x``.  Each is computed only where a gradient is asked for,
    and ``x`` is saved only for ``dw``.

    Under ``torch.func.vmap`` (a sweep round's cells) the batching rule folds
    the vmapped axis into the rows, so one launch serves every cell, forward
    and dx, when the weights are shared (the frozen tower).  A batched static
    scale ``s_x`` (each cell calibrates its own) launches the kernel once per
    cell, since the kernel reads one scale a launch, and so does a batched
    weight ``w`` (a trainable weight, each cell's own: the transformer
    probe's extra block, quantized per call); batched codes or weight scales
    raise."""

    @staticmethod
    def forward(x, w, w_i8, s_w, wt_i8, s_wt, s_x):
        if w_i8 is None:
            w_i8, s_w = quantize_cols(w)
        if s_x is not None:
            return int8_gemm_static(x, w_i8, s_w, s_x)
        return int8_gemm_dynamic(x, w_i8, s_w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _, _, wt_i8, s_wt, _ = inputs
        need_dx, need_dw = ctx.needs_input_grad[:2]
        ctx.i8_dx = wt_i8 is not None
        ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype
        ctx.save_for_backward(
            x if need_dw else None,
            w if need_dx and not ctx.i8_dx else None,
            wt_i8 if need_dx else None,
            s_wt if need_dx else None,
        )

    @staticmethod
    def backward(ctx, g):
        x, w, wt_i8, s_wt = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.i8_dx:
                # the cotangent always takes the dynamic per-row quantize
                dx = int8_gemm_dynamic(g, wt_i8, s_wt)
            else:
                dx = torch.matmul(g, w).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            g2d = g.reshape(-1, g.shape[-1])
            dw = torch.matmul(g2d.t(), x.reshape(-1, x.shape[-1])).to(ctx.w_dtype)
        return dx, dw, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, w_i8, s_w, wt_i8, s_wt, s_x):
        if any(d is not None for d in in_dims[2:6]):
            raise NotImplementedError("the int8 matmul's codes and weight scales are shared by "
                                      "the vmapped axis: batched codes or weight scales")
        cells, (x_dim, w_dim), s_dim = info.batch_size, in_dims[:2], in_dims[6]
        if s_dim is None and w_dim is None:  # then x is the batched operand
            # (cells, ..., K): the wrapper takes any leading shape as rows
            return _Int8Matmul.apply(x.movedim(x_dim, 0), w, w_i8, s_w, wt_i8, s_wt, s_x), 0

        def cell(t, dim, i):
            return t if dim is None else t.select(dim, i)

        outs = [_Int8Matmul.apply(cell(x, x_dim, i), cell(w, w_dim, i), w_i8, s_w, wt_i8, s_wt,
                                  cell(s_x, s_dim, i)) for i in range(cells)]
        return torch.stack(outs), 0


def int8_matmul_bf16_bwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 forward (exactly ``int8_matmul``), full-precision backward with the
    original weights and activations (the QLoRA recipe)."""
    return _Int8Matmul.apply(x, w, None, None, None, None, None)


def int8_prequant_matmul(x, w, w_i8, s_w) -> torch.Tensor:
    """``int8_matmul_bf16_bwd`` with the weight quantized ahead of time
    (``w_i8``, ``s_w`` from ``quantize_cols``); ``w`` is only touched by the
    backward."""
    return _Int8Matmul.apply(x, w, w_i8, s_w, None, None, None)


def int8_prequant_matmul_i8bwd(x, w, w_i8, s_w, wt_i8, s_wt) -> torch.Tensor:
    """int8 forward and int8 dx backward: ``dx = g @ w`` through the kernel
    against the pre-quantized transposed weight, g quantized per row.  ``dw``
    stays the dense product."""
    return _Int8Matmul.apply(x, w, w_i8, s_w, wt_i8, s_wt, None)


def int8_static_matmul(x, w, w_i8, s_w, s_x) -> torch.Tensor:
    """``int8_prequant_matmul`` with a static per-tensor activation scale
    ``s_x`` (see ``activation_scales_from_stats``); dense backward."""
    return _Int8Matmul.apply(x, w, w_i8, s_w, None, None, s_x)


def int8_static_matmul_i8bwd(x, w, w_i8, s_w, wt_i8, s_wt, s_x) -> torch.Tensor:
    """Static-scale forward and int8 dx backward.  The cotangent keeps the
    dynamic per-row quantize: only the forward's activation scale is static."""
    return _Int8Matmul.apply(x, w, w_i8, s_w, wt_i8, s_wt, s_x)


# ---------------------------------------------------------------- under tensor parallelism


def _rescale(acc: torch.Tensor, s_rows: torch.Tensor, s_w: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``(float(acc) * s_rows) * s_w`` in x's dtype: the kernel's rescale."""
    return ((acc.to(torch.float32) * s_rows) * s_w.to(torch.float32)).to(dtype)


def _global_row_codes(x: torch.Tensor, comm):
    """The row scales of x (..., K) over the whole K (the rank's partial row
    absmax, then the model group's maximum)."""
    return row_scales(comm.max(int8_row_absmax(x)))


class _RowParallelInt8(torch.autograd.Function):
    """``int8_row_parallel``'s body.  Forward: the codes at the global row
    scale (or the static one), the rank's int32 partial product
    (``int8_gemm_partial``), the model group's exact sum (``comm.sum_int``:
    under sequence parallelism this rank's tokens of it), the rescale.  A
    weight without codes is quantized here at its global per-row scale (its
    absmax over the whole K).  Backward: the gradient of every token
    (``comm.all_tokens``), then dx of this rank's K columns (through the
    dynamic kernel against the transposed codes ``wt_i8``, whose rows are
    this rank's K, or the dense ``g @ w``) and the dense ``dw``."""

    @staticmethod
    def forward(ctx, x, w, w_i8, s_w, wt_i8, s_wt, s_x, comm):
        if w_i8 is None:
            s_w = row_scales(comm.max(w.detach().to(torch.float32).abs().amax(dim=-1)))
            w_i8 = torch.round(w.detach().to(torch.float32) / s_w.unsqueeze(-1)).to(torch.int8)
        if s_x is None:
            s = _global_row_codes(x, comm)
            acc = int8_gemm_partial(x, w_i8, s_rows=s)
            s = comm.own_tokens(s.unsqueeze(-1))
        else:
            acc = int8_gemm_partial(x, w_i8, s_x=s_x)
            s = s_x.to(torch.float32)
        out = _rescale(comm.sum_int(acc), s, s_w, x.dtype)
        need_dx, need_dw = ctx.needs_input_grad[:2]
        ctx.comm, ctx.i8_dx, ctx.x_dtype, ctx.w_dtype = comm, wt_i8 is not None, x.dtype, w.dtype
        ctx.save_for_backward(x if need_dw else None,
                              w if need_dx and wt_i8 is None else None,
                              wt_i8 if need_dx else None, s_wt if need_dx else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, wt_i8, s_wt = ctx.saved_tensors
        g = ctx.comm.all_tokens(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (int8_gemm_dynamic(g, wt_i8, s_wt) if ctx.i8_dx
                  else torch.matmul(g, w).to(ctx.x_dtype))
        if ctx.needs_input_grad[1]:
            g2d = g.reshape(-1, g.shape[-1])
            dw = torch.matmul(g2d.t(), x.reshape(-1, x.shape[-1])).to(ctx.w_dtype)
        return dx, dw, None, None, None, None, None, None


def int8_row_parallel(x, w, w_i8, s_w, wt_i8, s_wt, s_x, comm) -> torch.Tensor:
    """The row-parallel int8 GEMM: x (..., K / M) this rank's input columns,
    w / ``w_i8`` (N, K / M) and ``wt_i8`` / ``s_wt`` (K / M, N) their cut,
    ``s_w`` (N,) the whole weight's scales (None with ``w_i8`` None:
    quantized here), ``s_x`` the static scale or None (dynamic); -> the
    unsplit ``_Int8Matmul`` forward bit for bit, the model group's sum taken
    (under sequence parallelism this rank's tokens), differentiable."""
    return _RowParallelInt8.apply(x, w, w_i8, s_w, wt_i8, s_wt, s_x, comm)


class _ColumnParallelInt8Dx(torch.autograd.Function):
    """``int8_column_parallel_dx``'s body.  Forward: the int8 kernel on
    ``xin`` (each output column contracts over the whole K).  Backward: dx
    contracts over the cut N, so its codes take the global row scale of the
    cotangent and the ranks' int32 partial products against ``wt_i8``'s
    columns of this rank are summed (``comm.sum_int``) before the rescale by
    the whole ``s_wt``: the unsplit int8 dx, which goes to ``x`` (under
    sequence parallelism this rank's tokens of it), none to ``xin``."""

    @staticmethod
    def forward(ctx, x, xin, w, w_i8, s_w, wt_i8, s_wt, s_x, comm):
        out = (int8_gemm_static(xin, w_i8, s_w, s_x) if s_x is not None
               else int8_gemm_dynamic(xin, w_i8, s_w))
        ctx.comm, ctx.x_dtype, ctx.w_dtype = comm, x.dtype, w.dtype
        ctx.save_for_backward(xin if ctx.needs_input_grad[2] else None, wt_i8, s_wt)
        return out

    @staticmethod
    def backward(ctx, g):
        xin, wt_i8, s_wt = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            s = _global_row_codes(g, ctx.comm)
            acc = ctx.comm.sum_int(int8_gemm_partial(g, wt_i8, s_rows=s))
            dx = _rescale(acc, ctx.comm.own_tokens(s.unsqueeze(-1)), s_wt, g.dtype)
        if ctx.needs_input_grad[2]:
            g2d = g.reshape(-1, g.shape[-1])
            dw = torch.matmul(g2d.t(), xin.reshape(-1, xin.shape[-1])).to(ctx.w_dtype)
        return dx, None, dw, None, None, None, None, None, None


def int8_column_parallel_dx(x, xin, w, w_i8, s_w, wt_i8, s_wt, s_x, comm) -> torch.Tensor:
    """The column-parallel int8 GEMM with the int8 dx backward: ``xin`` =
    ``f(x)``, w / ``w_i8`` / ``s_w`` this rank's output rows, ``wt_i8`` (K,
    N / M) their columns of the transposed codes and ``s_wt`` (K,) whole;
    forward the int8 kernel on ``xin``, backward the unsplit int8 dx to
    ``x`` bit for bit (see ``_ColumnParallelInt8Dx``)."""
    return _ColumnParallelInt8Dx.apply(x, xin, w, w_i8, s_w, wt_i8, s_wt, s_x, comm)


# ---------------------------------------------------------------- trees


def activation_scales_from_stats(stats: Mapping[str, torch.Tensor],
                                 margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """A calibration pass's statistics (``models.layers.collect_activation_stats``:
    ``<module>.amax``, the absmax of each ``Int8Dense``'s input) -> the static
    scales the model consumes: ``<module>.s_x = max(amax * margin / 127, 1e-8)``
    as fp32 scalars.  ``<module>.amax_<t>`` (attention operands) becomes
    ``<module>.s_<t>``; other names are skipped.  ``margin`` > 1 leaves
    headroom for the activations' drift between recalibrations."""
    out = {}
    for name, leaf in stats.items():
        module, _, last = name.rpartition(".")
        if last == "amax":
            s_name = "s_x"
        elif last.startswith("amax_"):
            s_name = "s_" + last[len("amax_"):]
        else:
            continue
        amax = torch.as_tensor(leaf).to(torch.float32).max()
        out[f"{module}.{s_name}"] = _div(amax * float(margin), 127.0).clamp_min(1e-8)
    return out


def quantize_frozen_tree(
    frozen: Mapping[str, torch.Tensor],
    targets: Sequence[str] = INT8_TARGET_MODULES,
    bwd_dx: bool = False,
    param_dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Pre-quantize the ``Int8Dense`` weights among the frozen leaves
    (``peft.split_params``): every ``<module>.weight`` whose module's name is
    in ``targets`` becomes ``<module>.w_i8`` and ``<module>.s_w``, and with
    ``bwd_dx`` also the transposed ``<module>.wt_i8`` and ``<module>.s_wt`` of
    the int8 dx backward.  Trainable leaves are not in ``frozen`` and other
    leaves are skipped, so the tree works for any PEFT mask.  Pass it to the
    train step in ``frozen``.

    The codes are those of the stored ``param_dtype`` weights, as the JAX
    package quantizes its fp32 tree: call this before ``models.cast_frozen_``
    rounds the frozen weights to the compute dtype.  A target weight in
    another dtype raises."""
    out = {}
    for name, leaf in frozen.items():
        parts = name.split(".")
        if len(parts) < 2 or parts[-1] != "weight" or parts[-2] not in targets or leaf.dim() != 2:
            continue
        if leaf.dtype != param_dtype:
            raise ValueError(
                f"{name} is {leaf.dtype}, not the stored {param_dtype}: quantize the frozen "
                "tree before cast_frozen_ rounds it to the compute dtype")
        module = name[: -len(".weight")]
        with torch.no_grad():
            out[f"{module}.w_i8"], out[f"{module}.s_w"] = quantize_cols(leaf)
            if bwd_dx:
                out[f"{module}.wt_i8"], out[f"{module}.s_wt"] = quantize_cols(leaf.t())
    return out
