"""Multi-head attention for the H100.

Counterpart of ``peft_vit_tpu/ops/attention.py``.  Operands keep the JAX
layout: q, k, v are (B, H, N, D), lse is (B, H, 1, N).  The additive bias is
(H, N, N), shared by the batch, or (C, H, N, N) with C dividing B: batch
element b reads cell ``b // (B // C)`` (a sweep round's cells, each with its
own relative position table, folded into the batch); the plain reference
also takes (B, H, N, N).

* ``attention_reference`` — plain PyTorch ``softmax(q k^T * scale + bias) v``
  (the JAX reference, ``attention_reference``).
* ``flash_attention_fwd`` — the wrapper of the hand-written CUDA kernel
  ``csrc/flash_attn_fwd.cu``, the counterpart of the Pallas flash forward
  ``_flash_fwd_kernel``.  A CUDA tensor launches the kernel or raises; a
  CPU tensor runs the kernel's plain version.
* ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv`` — the wrappers
  of the two backward kernels of ``csrc/flash_attn_bwd.cu``, the
  counterparts of ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``,
  with the bias added where they recompute p.  The dq kernel also computes
  delta = rowsum(dO o O), which the JAX wrapper computes in XLA before the
  kernels, and hands it to the dk/dv kernel.
* ``attention_bias_grad`` — the wrapper of ``csrc/attn_bias_grad.cu``, the
  bias gradient dbias = sum over each cell's batch of p o (dO v^T - delta).
  It has no Pallas counterpart: with a bias the JAX package leaves the
  kernels for the XLA VJP of ``attention_reference``
  (``_attention_bias_vjp_bwd``).
* ``flash_attention`` — the differentiable attention: a
  ``torch.autograd.Function`` whose forward is the forward kernel (saving
  its lse) and whose backward is the two backward kernels for q, k and v and
  the bias-gradient kernel for the bias, as the JAX ``custom_vjp``s around
  the flash path and the bias path.
* ``fused_short_attention_fwd`` / ``fused_short_attention_bwd`` — the
  wrappers of the two kernels of ``csrc/fused_short_attn.cu``, the
  counterparts of the Pallas fused short-sequence pair ``_short_fwd_kernel``
  and ``_short_bwd_kernel``: whole-row softmax with p normalised before it is
  rounded, and a backward that computes delta itself and folds the scale
  into ds before rounding it.
* ``fused_short_attention`` — their ``torch.autograd.Function``, as the JAX
  ``custom_vjp`` around the fused pair.
* ``int8_attention`` — the score product on int8 codes (``TPU.INT8_ATTN``,
  with ``pv`` also P V: ``TPU.INT8_ATTN_PV``), the counterpart of the JAX
  ``int8_attention``: XLA math there, plain PyTorch here (the exact int32
  scores as an fp32 product of the codes, ``int8_attention_scores``), with
  the flash backward behind it on the card (the forward kernel recomputes o
  and lse, then the dq and dk/dv kernels).
Every kernel launch is a registered op of ``peft_vit_tpu_torch::``
(``ops._library``): the wrapper checks its operands and calls the op, whose
CUDA implementation is the launch (``_flash_fwd_launch``, ...), whose CPU
implementation is the plain version, and whose fake implementation gives
``torch.export`` the shapes.

* ``multi_head_attention`` — what the model calls.  ``use_fused=True`` with
  no bias and N <= 1024 takes ``fused_short_attention`` on the card and on
  the CPU (the JAX dispatcher's rule; the CPU runs the plain versions, as
  the JAX package runs the Pallas pair in interpret mode).  Otherwise
  ``attention_reference`` on the CPU (torch differentiates it) and
  ``flash_attention`` on the card for every shape, with or without a bias.
  The JAX dispatcher's choice of XLA below N = 2048 was measured on a TPU
  and is not carried over; so the card refuses ``softmax_fp32=False``
  (``TPU.BF16_SOFTMAX``), which only that XLA path honours.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from . import _build
from ._library import attention_products, kernel_op

# the head dims the flash kernels (K1, K2, K3) and the bias-gradient kernel
# (K7) are built at: 64 (the ViTs, the text tower) and 32 (Swin's heads),
# template instantiations of the same kernels
KERNEL_HEAD_DIMS = (32, 64)
FUSED_HEAD_DIMS = (64,)  # the fused short-sequence pair (K4, K5)


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32 for bf16 and fp32 operands; float64 operands stay float64."""
    return torch.promote_types(q.dtype, torch.float32)


def _bias_cells(bias: torch.Tensor) -> int:
    """C of a (C, H, N, N) bias; 1 for an (H, N, N) one."""
    return 1 if bias.dim() == 3 else bias.shape[0]


def _batch_bias(bias: torch.Tensor, b: int) -> torch.Tensor:
    """The bias as the batch of ``b`` reads it: an (H, N, N) bias broadcasts
    over the batch, cell c of a (C, H, N, N) bias serves batch elements
    c B / C .. (c + 1) B / C - 1."""
    if bias.dim() == 3:
        return bias
    return bias.repeat_interleave(b // bias.shape[0], dim=0)


def _scores(
    q: torch.Tensor,
    k: torch.Tensor,
    bias: Optional[torch.Tensor],
    scale: float,
    acc: torch.dtype,
) -> torch.Tensor:
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + _batch_bias(bias, q.shape[0]).to(acc)
    return s


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softmax_fp32: bool = True,
) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v.

    q, k, v: (B, H, N, D).  bias: (H, Nq, Nk), (C, H, Nq, Nk) with C dividing
    B (cell c for batch elements c B / C ..), or None.
    ``softmax_fp32=False`` keeps the scores in the compute dtype.  The
    scores of bf16 operands are exact fp32 products summed in fp32, as
    ``preferred_element_type=float32`` gives in JAX; the probabilities are
    cast to v's dtype for the second product.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q) if softmax_fp32 else q.dtype
    p = torch.softmax(_scores(q, k, bias, scale, acc), dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def _flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    scale: float,
    return_lse: bool,
):
    """The kernel's plain version: the fp32-softmax reference, and the
    log-sum-exp of its fp32 scores."""
    out = attention_reference(q, k, v, bias, scale)
    if not return_lse:
        return out
    lse = torch.logsumexp(_scores(q, k, bias, scale, _acc_dtype(q)), dim=-1)
    return out, lse.unsqueeze(2)


def _bwd_p_ds_acc(q, k, v, do, lse, delta, scale, bias=None):
    """p = exp(scale q k^T + bias - lse) and ds = p o (dO v^T - delta) in the
    accumulation dtype, unrounded."""
    acc = _acc_dtype(q)
    p = torch.exp(_scores(q, k, bias, scale, acc) - lse.to(acc).transpose(-1, -2))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    return p, p * (dp - delta.to(acc).transpose(-1, -2))


def _bwd_p_ds(q, k, v, do, lse, delta, scale, bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """p and ds of ``_bwd_p_ds_acc``, each rounded to the operand dtype as
    the kernels round them, returned in the accumulation dtype."""
    acc = _acc_dtype(q)
    p, ds = _bwd_p_ds_acc(q, k, v, do, lse, delta, scale, bias)
    return p.to(q.dtype).to(acc), ds.to(q.dtype).to(acc)


def _row_dot(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO o O) in the accumulation dtype, (B, H, 1, N): the
    plain version of the delta that the dq kernel computes."""
    acc = _acc_dtype(o)
    return (do.to(acc) * o.to(acc)).sum(dim=-1).unsqueeze(2)


def _bwd_dq_plain(q, k, v, do, lse, o, scale, bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dq, delta)``: delta from dO and O, then dq from it."""
    delta = _row_dot(do, o)
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, scale, bias)
    return (scale * torch.matmul(ds, k.to(ds.dtype))).to(q.dtype), delta


def _bwd_dkv_plain(q, k, v, do, lse, delta, scale, bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, scale, bias)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.to(ds.dtype))
    dv = torch.matmul(p.transpose(-1, -2), do.to(p.dtype))
    return dk.to(q.dtype), dv.to(q.dtype)


def _bias_grad_plain(q, k, v, do, lse, scale, bias, delta=None, o=None) -> torch.Tensor:
    """The bias-gradient kernel's plain version: ds = p o (dO v^T - delta)
    unrounded in the accumulation dtype (delta = rowsum(dO o O) from ``o``
    when ``delta`` is None), summed over the batch elements of each bias
    cell; the bias's shape, in the accumulation dtype."""
    if delta is None:
        delta = _row_dot(do, o)
    _, ds = _bwd_p_ds_acc(q, k, v, do, lse, delta, scale, bias)
    return ds.unflatten(0, (_bias_cells(bias), -1)).sum(1).reshape(bias.shape)


def _flash_attention_bwd_plain(q, k, v, o, lse, do, scale, bias=None):
    """The backward kernels' plain version: ``(dq, dk, dv)`` from the saved
    lse, step by step as the kernels compute them::

        p  = exp(scale q k^T + bias - lse)      delta = rowsum(dO o O)
        dv = p^T dO                             ds = p o (dO v^T - delta)
        dq = scale ds k                         dk = scale ds^T q

    with p cast to the operand dtype before ``dv`` and ds before ``dq`` and
    ``dk``; every sum is fp32.  delta comes out of the dq step, as the dq
    kernel writes it for the dk/dv kernel."""
    dq, delta = _bwd_dq_plain(q, k, v, do, lse, o, scale, bias)
    return (dq, *_bwd_dkv_plain(q, k, v, do, lse, delta, scale, bias))


def _check_operands(q, k, v, bias) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, N, D), got shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if bias is not None:
        b, h, n, _ = q.shape
        if tuple(bias.shape[-3:]) != (h, n, n) or bias.dim() not in (3, 4):
            raise ValueError(f"bias must be (H, N, N) = {(h, n, n)} or (C, H, N, N), got "
                             f"{tuple(bias.shape)}")
        if bias.dim() == 4 and (bias.shape[0] == 0 or b % bias.shape[0]):
            raise ValueError(f"a (C, H, N, N) bias needs C dividing the batch {b}, got C = "
                             f"{bias.shape[0]}")
        if bias.device != q.device:
            raise ValueError(f"bias is on {bias.device}, q on {q.device}")
        if bias.dtype not in (torch.float32, q.dtype):
            raise TypeError(f"bias dtype {bias.dtype} is neither float32 nor q's {q.dtype}")


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# device, operands ..., B, H, N, D, [bias cells C,] scale, is_bf16, stream
_SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "flash_attn_fwd": {
        "flash_attn_fwd": [_INT, *[_PTR] * 6, *[_INT] * 5, _FLOAT, _INT, _PTR],
    },
    "flash_attn_bwd": {
        "flash_attn_bwd_dq": [_INT, *[_PTR] * 9, *[_INT] * 5, _FLOAT, _INT, _PTR],
        "flash_attn_bwd_dkv": [_INT, *[_PTR] * 9, *[_INT] * 5, _FLOAT, _INT, _PTR],
        "flash_attn_bwd_smem_bytes": [_INT],  # D -> bytes
    },
    "attn_bias_grad": {
        # ..., dbias, partial, B, H, N, D, C, chunk elements, scale, is_bf16, stream
        "attn_bias_grad": [_INT, *[_PTR] * 10, *[_INT] * 6, _FLOAT, _INT, _PTR],
        "attn_bias_grad_smem_bytes": [_INT, _INT, _INT],  # D, from o, chunk elements -> bytes
    },
    "fused_short_attn": {
        "fused_short_attn_fwd": [_INT, *[_PTR] * 5, *[_INT] * 4, _FLOAT, _INT, _PTR],
        "fused_short_attn_bwd": [_INT, *[_PTR] * 9, *[_INT] * 4, _FLOAT, _INT, _PTR],
        "fused_short_attn_bwd_smem_bytes": [],  # -> bytes
    },
}
# every library's error string: a cudaError_t -> its name
_ERROR_STRING = ("flash_attn_error_string", [_INT], ctypes.c_char_p)


def _kernel_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded, its functions' signatures set."""
    lib = _build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        fn, argtypes, restype = _ERROR_STRING
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        lib._argtypes_set = True
    return lib


def _check_kernel_operands(what: str, named: Sequence[Tuple[str, Optional[torch.Tensor]]],
                           head_dims: Sequence[int] = KERNEL_HEAD_DIMS,
                           rows: Sequence[Tuple[str, Optional[torch.Tensor]]] = ()) -> None:
    """What every kernel asks of its operands (the first is (B, H, N, D);
    None: an absent one) and of the fp32 ``rows`` (lse, delta) it reads: a
    head dim it is built at, and nothing padded to one.  The wrappers check
    it before the op for every tensor not on the CPU, so that a meta tensor,
    or the fake tensor ``torch.export`` traces, meets it as a CUDA tensor
    does; the launch checks the alignment (``_check_aligned``)."""
    for name, t in rows:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got {t.dtype}")
    named = [(n, t) for n, t in (*named, *rows) if t is not None]
    q = named[0][1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"the kernel takes head dim {' or '.join(map(str, head_dims))}, got "
                         f"{q.shape[-1]}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {q.device}")


def _check_aligned(named: Sequence[Tuple[str, Optional[torch.Tensor]]]) -> None:
    for name, t in named:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.flash_attn_error_string(err).decode()}")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash-attention forward: ``softmax(scale * q k^T + bias) v``.

    q, k, v: (B, H, N, D) contiguous, bf16 or fp32; bias: (H, N, N), (C, H,
    N, N) with C dividing B (the kernel reads it in fp32), or None.
    Returns o (B, H, N, D) in q's dtype and, with ``return_lse``, the fp32
    log-sum-exp (B, H, 1, N).

    CUDA tensors launch ``csrc/flash_attn_fwd.cu`` (D = 32 or 64) on the current
    stream and count the launch in ``flash_attention_fwd.launches``; any
    operand the kernel does not take raises.  CPU tensors run the plain
    version and launch nothing.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_operands(q, k, v, bias)
    if q.device.type != "cpu":
        _check_kernel_operands("flash_attention_fwd", (("q", q), ("k", k), ("v", v)))
    out, lse = _FLASH_FWD(q, k, v, bias, float(scale), bool(return_lse))
    return (out, lse) if return_lse else out


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    """The lse result of a forward op that was not asked for one: empty."""
    return q.new_empty((0,), dtype=torch.float32)


def _lse_like(q: torch.Tensor) -> torch.Tensor:
    b, h, n, _ = q.shape
    return q.new_empty((b, h, 1, n), dtype=_acc_dtype(q))


def _flash_fwd_cpu(q, k, v, bias, scale: float, return_lse: bool):
    if return_lse:
        return _flash_attention_plain(q, k, v, bias, scale, True)
    return _flash_attention_plain(q, k, v, bias, scale, False), _no_lse(q)


def _flash_fwd_launch(q, k, v, bias, scale: float, return_lse: bool):
    """K1's launch on checked CUDA operands: ``(o, lse)`` (lse empty without
    ``return_lse``)."""
    _check_aligned((("q", q), ("k", k), ("v", v)))
    b, h, n, d = q.shape
    bias = _kernel_bias(bias)

    lib = _kernel_library("flash_attn_fwd")
    out = torch.empty_like(q)
    lse = (
        torch.empty((b, h, 1, n), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    err = lib.flash_attn_fwd(
        _device_index(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, n, d, 1 if bias is None else _bias_cells(bias), float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, "flash_attn_fwd")
    flash_attention_fwd.launches += 1
    return out, _no_lse(q) if lse is None else lse


flash_attention_fwd.launches = 0

_FLASH_FWD = kernel_op(
    "flash_attn_fwd",
    "(Tensor q, Tensor k, Tensor v, Tensor? bias, float scale, bool return_lse) -> (Tensor, Tensor)",
    cpu=_flash_fwd_cpu, cuda=_flash_fwd_launch,
    fake=lambda q, k, v, bias, scale, return_lse: (
        torch.empty_like(q), _lse_like(q) if return_lse else _no_lse(q)),
    # s = q k^T and p v
    flops=lambda q, *args, out_shape=None, **kw: attention_products(q, 2),
)


def _kernel_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The bias as the kernels read it: fp32, contiguous."""
    if bias is None:
        return None
    bias = bias.to(torch.float32)
    if not bias.is_contiguous():
        raise ValueError("bias must be contiguous")
    return bias


def _check_bwd_operands(q, k, v, do, named_rows, named_full=(), bias=None) -> None:
    """The operands of a backward wrapper: q, k, v and do, the (B, H, N, D)
    tensors of ``named_full`` (o), the (B, H, 1, N) rows of ``named_rows``
    (lse, delta) and the bias as the forward took it."""
    _check_operands(q, k, v, bias)
    for name, t in (("do", do), *named_full):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    b, h, n, _ = q.shape
    for name, t in named_rows:
        if tuple(t.shape) != (b, h, 1, n):
            raise ValueError(f"{name} must be (B, H, 1, N) = {(b, h, 1, n)}, got {tuple(t.shape)}")
    for name, t in (("do", do), *named_full, *named_rows):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _launch_bwd(fn_name: str, named, rows, outs, scale: float, bias=None) -> None:
    """Checks shared by the backward wrappers, then one launch: ``named``
    the (B, H, N, D) operands in the kernel's order (None: an absent one),
    then the fp32 rows ``rows`` it reads (None: an absent one), the bias and
    the tensors ``outs`` it writes."""
    _check_aligned((*named, *rows))
    bias = _kernel_bias(bias)
    lib = _kernel_library("flash_attn_bwd")
    q = named[0][1]
    b, h, n, d = q.shape
    err = getattr(lib, fn_name)(
        _device_index(q),
        *(None if t is None else t.data_ptr() for _, t in (*named, *rows)),
        None if bias is None else bias.data_ptr(), *(t.data_ptr() for t in outs),
        b, h, n, d, 1 if bias is None else _bias_cells(bias), float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, fn_name)


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, o: torch.Tensor, scale: float, bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dq, delta)``: ``delta = rowsum(dO o O)`` and
    ``dq = scale * (p o (dO v^T - delta)) k`` with
    ``p = exp(scale q k^T + bias - lse)``.

    q, k, v, do, o (the forward's output): (B, H, N, D) contiguous, bf16 or
    fp32; lse (the forward's): (B, H, 1, N) fp32; bias: the forward's, or
    None.  Returns dq in q's dtype and delta (B, H, 1, N) fp32, the operand
    of ``flash_attention_bwd_dkv``.

    CUDA tensors launch ``flash_attn_bwd_dq`` of ``csrc/flash_attn_bwd.cu``
    (D = 32 or 64) on the current stream, which computes delta itself, and count
    the launch in ``flash_attention_bwd_dq.launches``; any operand the
    kernel does not take raises.  CPU tensors run the plain version and
    launch nothing.
    """
    _check_bwd_operands(q, k, v, do, (("lse", lse),), (("o", o),), bias)
    if q.device.type != "cpu":
        _check_kernel_operands("flash_attn_bwd_dq", (("q", q), ("k", k), ("v", v), ("do", do),
                                                     ("o", o)), rows=(("lse", lse),))
    return _FLASH_BWD_DQ(q, k, v, do, lse, o, bias, float(scale))


def _bwd_dq_launch(q, k, v, do, lse, o, bias, scale: float):
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse, dtype=torch.float32)
    _launch_bwd("flash_attn_bwd_dq", (("q", q), ("k", k), ("v", v), ("do", do), ("o", o)),
                (("lse", lse),), (delta, dq), scale, bias)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0

_FLASH_BWD_DQ = kernel_op(
    "flash_attn_bwd_dq",
    "(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, Tensor o, Tensor? bias, float scale)"
    " -> (Tensor, Tensor)",
    cpu=lambda q, k, v, do, lse, o, bias, scale: _bwd_dq_plain(q, k, v, do, lse, o, scale, bias),
    cuda=_bwd_dq_launch,
    fake=lambda q, k, v, do, lse, o, bias, scale: (torch.empty_like(q), _lse_like(q)),
    # s = q k^T, dp = dO v^T, dq = ds k
    flops=lambda q, *args, out_shape=None, **kw: attention_products(q, 3),
)


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dk = scale * (p o (dO v^T - delta))^T q`` and ``dv = p^T dO``.

    q, k, v, do, lse, bias as ``flash_attention_bwd_dq``; delta (B, H, 1, N)
    fp32 as it returns it.  Returns ``(dk, dv)`` in q's dtype.  CUDA tensors
    launch ``flash_attn_bwd_dkv`` and count the launch in
    ``flash_attention_bwd_dkv.launches``; CPU tensors run the plain version
    and launch nothing.
    """
    rows = (("lse", lse), ("delta", delta))
    _check_bwd_operands(q, k, v, do, rows, (), bias)
    if q.device.type != "cpu":
        _check_kernel_operands("flash_attn_bwd_dkv", (("q", q), ("k", k), ("v", v), ("do", do)),
                               rows=rows)
    return _FLASH_BWD_DKV(q, k, v, do, lse, delta, bias, float(scale))


def _bwd_dkv_launch(q, k, v, do, lse, delta, bias, scale: float):
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch_bwd("flash_attn_bwd_dkv", (("q", q), ("k", k), ("v", v), ("do", do)),
                (("lse", lse), ("delta", delta)), (dk, dv), scale, bias)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0

_FLASH_BWD_DKV = kernel_op(
    "flash_attn_bwd_dkv",
    "(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, Tensor delta, Tensor? bias,"
    " float scale) -> (Tensor, Tensor)",
    cpu=lambda q, k, v, do, lse, delta, bias, scale: _bwd_dkv_plain(
        q, k, v, do, lse, delta, scale, bias),
    cuda=_bwd_dkv_launch,
    fake=lambda q, k, v, do, lse, delta, bias, scale: (torch.empty_like(q), torch.empty_like(q)),
    # s = q k^T, dp = dO v^T, dv = p^T dO, dk = ds^T q
    flops=lambda q, *args, out_shape=None, **kw: attention_products(q, 4),
)


# K7 (bf16) splits each cell's batch into chunks of this many elements (the
# last may be short; the kernel takes at most 16), each chunk a block of its
# own a tile.  On the H100, 16 was faster than 4 or 8 at ViT-B/16's B = 16
# and at three of Swin-T's four stage folds at B = 64 (PERF.md, section 6).
BIAS_GRAD_CHUNK = 16


def bias_grad_split(bias_batch: int) -> int:
    """The chunks of ``BIAS_GRAD_CHUNK`` elements K7 (bf16) splits the batch
    of one bias cell into: a function of the per-cell batch alone, never of
    the number of cells, the heads or the card, so that a sweep round of
    cells sums each cell in the order that cell alone does, bit for bit.
    Chunk i holds elements ``16 i .. min(16 (i + 1), bias_batch) - 1``."""
    if bias_batch <= 0:
        raise ValueError(f"no split for a per-cell batch of {bias_batch}")
    return -(-bias_batch // BIAS_GRAD_CHUNK)


def attention_bias_grad(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: float, bias: torch.Tensor,
    delta: Optional[torch.Tensor] = None, o: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The attention bias's gradient: ``dbias[c] = sum over the batch
    elements b of cell c of p_b o (dO_b v_b^T - delta_b)`` with
    ``p = exp(scale q k^T + bias - lse)``, ds unrounded and summed in fp32
    (the XLA VJP of the JAX package's bias path sums the fp32 ds over the
    batch likewise).

    q, k, v, do: (B, H, N, D) contiguous, bf16 or fp32; lse: (B, H, 1, N)
    fp32; bias: the forward's, (H, N, N) or (C, H, N, N); delta: (B, H, 1, N)
    fp32 as ``flash_attention_bwd_dq`` returns it, or None, and then ``o``
    (the forward's output), from which the kernel computes delta itself.
    Returns dbias in the bias's shape, fp32 (the plain version: the
    accumulation dtype of q).

    CUDA tensors launch ``attn_bias_grad`` of ``csrc/attn_bias_grad.cu``
    (D = 32 or 64) on the current stream and count the launch in
    ``attention_bias_grad.launches``; in bf16 each cell's batch is split by
    ``bias_grad_split`` and the partials, in an fp32 workspace of (chunks,
    C, H, N, N), are summed in chunk order.  Any operand the kernel does not
    take raises.  CPU tensors run the plain version and launch nothing."""
    if (delta is None) == (o is None):
        raise ValueError("give the bias gradient delta or o, one of the two")
    rows = (("lse", lse),) + ((("delta", delta),) if delta is not None else ())
    _check_bwd_operands(q, k, v, do, rows, (("o", o),) if o is not None else (), bias)
    if q.device.type != "cpu":
        _check_kernel_operands("attn_bias_grad", (("q", q), ("k", k), ("v", v), ("do", do),
                                                  ("o", o)), rows=(("lse", lse), ("delta", delta)))
    return _BIAS_GRAD(q, k, v, do, lse, bias, delta, o, float(scale))


def _bias_grad_op_launch(q, k, v, do, lse, bias, delta, o, scale: float):
    dbias = _bias_grad_launch(q, k, v, do, lse, scale, bias, delta, o)
    attention_bias_grad.launches += 1
    return dbias


def _bias_grad_launch(q, k, v, do, lse, scale: float, bias, delta=None,
                      o=None) -> torch.Tensor:
    """One call of ``attn_bias_grad`` on checked CUDA operands, its
    workspace from torch's allocator on the current stream, so that the call
    can be captured in a CUDA graph."""
    named = [("q", q), ("k", k), ("v", v), ("do", do), ("o", o), ("lse", lse), ("delta", delta)]
    _check_aligned(named)
    bias = _kernel_bias(bias)
    b, h, n, d = q.shape
    cells = _bias_cells(bias)
    chunks = bias_grad_split(b // cells)
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    partial = None
    if q.dtype == torch.bfloat16 and chunks > 1:
        partial = torch.empty((chunks, cells, h, n, n), dtype=torch.float32, device=q.device)
    lib = _kernel_library("attn_bias_grad")
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.attn_bias_grad(
        _device_index(q), *(ptr(t) for _, t in named), bias.data_ptr(), dbias.data_ptr(),
        ptr(partial), b, h, n, d, cells, BIAS_GRAD_CHUNK, scale,
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, "attn_bias_grad")
    return dbias


attention_bias_grad.launches = 0

# K7 and, past one chunk a cell, its chunk sum: one C call, one op
_BIAS_GRAD = kernel_op(
    "attn_bias_grad",
    "(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, Tensor bias, Tensor? delta,"
    " Tensor? o, float scale) -> Tensor",
    cpu=lambda q, k, v, do, lse, bias, delta, o, scale: _bias_grad_plain(
        q, k, v, do, lse, scale, bias, delta, o),
    cuda=_bias_grad_op_launch,
    fake=lambda q, k, v, do, lse, bias, delta, o, scale: bias.new_empty(
        bias.shape, dtype=_acc_dtype(q)),
    # s = q k^T and dp = dO v^T
    flops=lambda q, *args, out_shape=None, **kw: attention_products(q, 2),
)


def _needs_grad(*operands: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands)


def _fold_cells(cells: int, in_dims, operands):
    """The operands of a batching rule with the cell axis folded into the
    batch: (cells, B, ...) -> (cells * B, ...), contiguous.  An operand that
    is not batched is expanded to every cell first."""
    out = []
    for t, dim in zip(operands, in_dims):
        t = t.expand(cells, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.reshape(cells * t.shape[1], *t.shape[2:]).contiguous())
    return out


def _unfold_cells(cells: int, outputs):
    """The outputs of a folded launch with the cell axis taken out again:
    ``(outputs, out_dims)`` as a batching rule returns them."""
    outs = tuple(None if t is None else t.unflatten(0, (cells, -1)) for t in outputs)
    return outs, tuple(None if t is None else 0 for t in outs)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, with its lse when a gradient is asked for
    (``with_lse``); backward through the dq and dk/dv kernels where q, k or v
    needs a gradient and through the bias-gradient kernel where the bias
    does (``ctx.needs_input_grad``: nothing launches for the other), as the
    JAX ``custom_vjp``s of the flash path and, with a bias, of the XLA path.
    Under ``torch.func.vmap`` the batching rule folds the vmapped axis (a
    sweep round's cells) into the batch, and a batched bias into the bias's
    cells, and launches the same kernels once, so autograd and the backward
    see the folded tensors."""

    @staticmethod
    def forward(q, k, v, bias, scale, with_lse):
        if with_lse:
            return flash_attention_fwd(q, k, v, bias, scale, return_lse=True)
        return flash_attention_fwd(q, k, v, bias, scale), None

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, scale, with_lse = inputs
        out, lse = output
        if with_lse:
            ctx.mark_non_differentiable(lse)
            ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.set_materialize_grads(False)  # lse's cotangent stays None: no zeros launched
        ctx.scale = scale

    @staticmethod
    def backward(ctx, do, _dlse):
        if do is None:  # no cotangent (grads are not materialized)
            return None, None, None, None, None, None
        q, k, v, out, lse, bias = ctx.saved_tensors
        do = do.contiguous()  # arrives as the transposed view of the head merge
        b32 = None if bias is None else bias.to(torch.float32).contiguous()
        dq = dk = dv = dbias = delta = None
        if any(ctx.needs_input_grad[:3]):
            dq, delta = flash_attention_bwd_dq(q, k, v, do, lse, out, ctx.scale, b32)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.scale, b32)
        if ctx.needs_input_grad[3]:
            # delta from the dq kernel where it ran, else the kernel computes it from o;
            # the cotangent in the bias's dtype, as the JAX VJP returns it
            dbias = attention_bias_grad(q, k, v, do, lse, ctx.scale, b32, delta,
                                        None if delta is not None else out).to(bias.dtype)
        return dq, dk, dv, dbias, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, bias, scale, with_lse):
        cells = info.batch_size
        # under the vmap the caller cannot see whether its operands need a
        # gradient; the unwrapped tensors tell
        with_lse = with_lse or _needs_grad(q, k, v, bias)
        q, k, v = _fold_cells(cells, in_dims[:3], (q, k, v))
        if bias is not None and in_dims[3] is not None:
            # (cells, [C,] H, N, N) -> (cells C, H, N, N): cell i's rows of the
            # folded batch read its own bias
            bias = bias.movedim(in_dims[3], 0)
            bias = bias.reshape(-1, *bias.shape[-3:]).contiguous()
        return _unfold_cells(cells, _FlashAttention.apply(q, k, v, bias, scale, with_lse))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable flash attention, ``softmax(scale * q k^T + bias) v``.

    bias: (H, N, N) or (C, H, N, N) with C dividing B, in fp32 or q's dtype,
    or None.  With a gradient required of q, k, v or the bias the forward
    saves ``(q, k, v, o, lse, bias)``; the backward launches the dq and
    dk/dv kernels when q, k or v requires one and the bias-gradient kernel
    when the bias does, its result in the bias's dtype.  Without one it is
    ``flash_attention_fwd`` and saves nothing.  Under ``torch.func.vmap`` (a
    sweep round's cells) every kernel launches once for all cells, the
    vmapped axis folded into the batch and a batched bias into its cells.
    CPU tensors run the kernels' plain versions, forward and backward.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bias, float(scale), _needs_grad(q, k, v, bias))[0]


# ---------------------------------------------------------------------------
# Fused short-sequence attention (the Pallas ``_short_fwd_kernel`` and
# ``_short_bwd_kernel``)

FUSED_MAX_SEQ = 1024  # the JAX dispatcher's bound for the fused pair


def _fused_short_fwd_plain(q, k, v, scale: float, return_lse: bool):
    """The forward kernel's plain version, step by step as the Pallas kernel::

        s = scale q k^T (fp32)   m = max s   p = exp(s - m)   l = sum p
        o = ((p / l) -> v's dtype) v, summed in fp32     lse = m + log l

    The probabilities are normalised before they are rounded (the flash
    forward rounds the unnormalised p and divides at the end)."""
    acc = _acc_dtype(q)
    s = _scores(q, k, None, scale, acc)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul((p / l).to(v.dtype).to(acc), v.to(acc)).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).transpose(-1, -2)


def _fused_short_bwd_plain(q, k, v, o, lse, do, scale: float):
    """The backward kernel's plain version: ``(dq, dk, dv)`` step by step as
    the Pallas kernel::

        p  = exp(scale q k^T - lse)     dv = (p -> dtype)^T dO
        dp = dO v^T                     delta = rowsum(dO o O)
        ds = (scale p (dp - delta)) -> dtype
        dq = ds k                       dk = ds^T q

    every sum fp32, every gradient in the operand dtype.  The scale is folded
    into ds before it is rounded (the flash backward scales after the
    product)."""
    acc = _acc_dtype(q)
    p = torch.exp(_scores(q, k, None, scale, acc) - lse.to(acc).transpose(-1, -2))
    dv = torch.matmul(p.to(do.dtype).to(acc).transpose(-1, -2), do.to(acc))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    delta = (do.to(acc) * o.to(acc)).sum(dim=-1, keepdim=True)
    ds = (scale * p * (dp - delta)).to(k.dtype).to(acc)
    dq = torch.matmul(ds, k.to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def fused_short_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused short-sequence attention forward: ``softmax(scale * q k^T) v``
    with the probabilities normalised before they are rounded.

    q, k, v: (B, H, N, D) contiguous, bf16 or fp32.  Returns o (B, H, N, D)
    in q's dtype and, with ``return_lse``, the fp32 log-sum-exp (B, H, 1, N).

    CUDA tensors launch ``fused_short_attn_fwd`` of
    ``csrc/fused_short_attn.cu`` (D = 64) on the current stream and count the
    launch in ``fused_short_attention_fwd.launches``; any operand the kernel
    does not take raises.  CPU tensors run the plain version and launch
    nothing.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_operands(q, k, v, None)
    if q.device.type != "cpu":
        _check_kernel_operands("fused_short_attention_fwd", (("q", q), ("k", k), ("v", v)),
                               FUSED_HEAD_DIMS)
    out, lse = _FUSED_FWD(q, k, v, float(scale), bool(return_lse))
    return (out, lse) if return_lse else out


def _fused_fwd_cpu(q, k, v, scale: float, return_lse: bool):
    if return_lse:
        return _fused_short_fwd_plain(q, k, v, scale, True)
    return _fused_short_fwd_plain(q, k, v, scale, False), _no_lse(q)


def _fused_fwd_launch(q, k, v, scale: float, return_lse: bool):
    _check_aligned((("q", q), ("k", k), ("v", v)))
    b, h, n, d = q.shape
    lib = _kernel_library("fused_short_attn")
    out = torch.empty_like(q)
    lse = (
        torch.empty((b, h, 1, n), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    err = lib.fused_short_attn_fwd(
        _device_index(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, n, d, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, "fused_short_attn_fwd")
    fused_short_attention_fwd.launches += 1
    return out, _no_lse(q) if lse is None else lse


fused_short_attention_fwd.launches = 0

_FUSED_FWD = kernel_op(
    "fused_short_attn_fwd",
    "(Tensor q, Tensor k, Tensor v, float scale, bool return_lse) -> (Tensor, Tensor)",
    cpu=_fused_fwd_cpu, cuda=_fused_fwd_launch,
    fake=lambda q, k, v, scale, return_lse: (
        torch.empty_like(q), _lse_like(q) if return_lse else _no_lse(q)),
    flops=lambda q, *args, out_shape=None, **kw: attention_products(q, 2),
)


def fused_short_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of the fused short-sequence attention from the
    forward's o and lse and the cotangent dO; delta = rowsum(dO o O) is
    computed inside the kernel.

    q, k, v, o, do: (B, H, N, D) contiguous, bf16 or fp32; lse: (B, H, 1, N)
    fp32.  CUDA tensors launch ``fused_short_attn_bwd`` (one launch, D = 64)
    and count it in ``fused_short_attention_bwd.launches``; any operand the
    kernel does not take raises.  CPU tensors run the plain version.
    """
    _check_bwd_operands(q, k, v, do, (("lse", lse),), (("o", o),))
    if q.device.type != "cpu":
        _check_kernel_operands("fused_short_attention_bwd",
                               (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)),
                               FUSED_HEAD_DIMS, rows=(("lse", lse),))
    return _FUSED_BWD(q, k, v, o, lse, do, float(scale))


def _fused_bwd_launch(q, k, v, o, lse, do, scale: float):
    _check_aligned((("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)))
    lib = _kernel_library("fused_short_attn")
    b, h, n, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    err = lib.fused_short_attn_bwd(
        _device_index(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, n, q.shape[-1], float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, "fused_short_attn_bwd")
    fused_short_attention_bwd.launches += 1
    return dq, dk, dv


fused_short_attention_bwd.launches = 0

_FUSED_BWD = kernel_op(
    "fused_short_attn_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, float scale)"
    " -> (Tensor, Tensor, Tensor)",
    cpu=_fused_short_bwd_plain, cuda=_fused_bwd_launch,
    fake=lambda q, k, v, o, lse, do, scale: tuple(torch.empty_like(q) for _ in range(3)),
    # s = q k^T, dp = dO v^T, dv = p^T dO, dq = ds k, dk = ds^T q
    flops=lambda q, *args, out_shape=None, **kw: attention_products(q, 5),
)


class _FusedShortAttention(torch.autograd.Function):
    """The fused forward, with its o and lse saved when a gradient is asked
    for; the backward is one launch of the fused backward (the JAX
    ``custom_vjp`` of ``_attention_fused_short``).  Under ``torch.func.vmap``
    the vmapped axis is folded into the batch, as for ``_FlashAttention``."""

    @staticmethod
    def forward(q, k, v, scale, with_lse):
        if with_lse:
            return fused_short_attention_fwd(q, k, v, scale, return_lse=True)
        return fused_short_attention_fwd(q, k, v, scale), None

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, with_lse = inputs
        out, lse = output
        if with_lse:
            ctx.mark_non_differentiable(lse)
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.set_materialize_grads(False)  # as in _FlashAttention
        ctx.scale = scale

    @staticmethod
    def backward(ctx, do, _dlse):
        if do is None:  # as in _FlashAttention
            return None, None, None, None, None
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()  # arrives as the transposed view of the head merge
        return (*fused_short_attention_bwd(q, k, v, out, lse, do, ctx.scale), None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale, with_lse):
        with_lse = with_lse or _needs_grad(q, k, v)  # as in _FlashAttention.vmap
        q, k, v = _fold_cells(info.batch_size, in_dims[:3], (q, k, v))
        return _unfold_cells(info.batch_size,
                             _FusedShortAttention.apply(q, k, v, scale, with_lse))


def fused_short_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable fused short-sequence attention (no bias).

    With a gradient required of q, k or v the forward saves
    ``(q, k, v, o, lse)`` and the backward launches the fused backward once;
    without one only the forward kernel runs.  CPU tensors run the kernels'
    plain versions, forward and backward.  Under ``torch.func.vmap`` each
    kernel launches once for all cells, as ``flash_attention``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FusedShortAttention.apply(q, k, v, float(scale), _needs_grad(q, k, v))[0]


# ---------------------------------------------------------------------------
# int8 attention scores (TPU.INT8_ATTN): XLA math in the JAX package, plain
# PyTorch here; its backward is the flash backward


def _codes_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 codes, exact: an fp32 product of the codes as fp32.
    Every code fits TF32's mantissa, every product (<= 127^2) and partial sum
    of the attention's contractions (D = 64: 64 x 127^2 = 1,032,256; N = 197
    for P V: 3,177,413) is an integer below 2^24, so cuBLAS, with TF32 on or
    off, and the CPU give the int32 sum of JAX's ``dot_general(...,
    preferred_element_type=int32)`` exactly.  (A bf16 product would round
    its output.)  Returned as that sum in fp32."""
    if a.shape[-1] * 127 * 127 >= 2**24:
        raise ValueError(f"a contraction of {a.shape[-1]} int8 codes may not be exact in fp32")
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def int8_attention_scores(q: torch.Tensor, k: torch.Tensor, s_q: torch.Tensor,
                          s_k: torch.Tensor) -> torch.Tensor:
    """The int32 scores ``quantize_static(q, s_q) . quantize_static(k, s_k)^T``
    (B, H, N, M), exact, as fp32 integers."""
    from .int8 import quantize_static

    return _codes_dot(quantize_static(q, s_q), quantize_static(k, s_k).transpose(-1, -2))


def _int8_attention_fwd_impl(q, k, v, s_q, s_k, s_v, scale: float, pv: bool) -> torch.Tensor:
    """The JAX ``_int8_attention_fwd_impl`` step by step: the exact int32
    scores rescaled by ``(s_q * s_k) * scale`` in fp32, an fp32 softmax, and
    P V in the compute dtype or, with ``pv``, in int8 (P at the exact scale
    1/127, v at ``s_v``).  The scales are fp32 scalars, or tensors that
    broadcast against (B, 1, 1, 1) (a round's per-cell scales, folded)."""
    from .int8 import _div, quantize_static

    s = int8_attention_scores(q, k, s_q, s_k)
    p = torch.softmax(s * (s_q * s_k * scale), dim=-1)
    if not pv:
        return torch.matmul(p.to(v.dtype), v).to(q.dtype)
    pi = torch.round(p * 127.0).to(torch.int8)
    o = _codes_dot(pi, quantize_static(v, s_v))
    return (o * _div(s_v, 127.0)).to(q.dtype)


def _fold_scale(s: torch.Tensor, dim: Optional[int], cells: int, b: int) -> torch.Tensor:
    """A scale as a batching rule's folded batch of ``cells`` x ``b`` reads
    it: shared, or one per cell repeated over its batch elements and shaped
    to broadcast against (cells b, H, N, D)."""
    if dim is None:
        return s
    return s.movedim(dim, 0).reshape(cells).repeat_interleave(b).reshape(-1, 1, 1, 1)


class _Int8Attention(torch.autograd.Function):
    """The int8 forward (``_int8_attention_fwd_impl``) with the VJP of the
    plain attention on the saved q, k, v behind it, as the JAX
    ``custom_vjp``: on the card the flash backward (the forward kernel
    recomputes o and lse, then the dq kernel with delta and the dk/dv
    kernel), on the CPU the kernels' plain versions, or autograd of the
    bf16-softmax reference for ``softmax_fp32=False``.  The scales get no
    gradient (JAX's zero cotangents).  Under ``torch.func.vmap`` the cell
    axis folds into the batch and per-cell scales into per-row ones, so a
    round launches each backward kernel once."""

    @staticmethod
    def forward(q, k, v, s_q, s_k, s_v, scale, softmax_fp32, pv):
        return _int8_attention_fwd_impl(q, k, v, s_q, s_k, s_v, scale, pv)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, _, _, _, scale, softmax_fp32, _ = inputs
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.softmax_fp32 = scale, softmax_fp32

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.contiguous()
        if not ctx.softmax_fp32:  # the CPU only: the card refused it at the forward
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                out = attention_reference(*qkv, None, ctx.scale, False)
                dq, dk, dv = torch.autograd.grad(out, qkv, g)
        else:
            o, lse = flash_attention_fwd(q, k, v, None, ctx.scale, return_lse=True)
            dq, delta = flash_attention_bwd_dq(q, k, v, g, lse, o, ctx.scale)
            dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, s_q, s_k, s_v, scale, softmax_fp32, pv):
        cells = info.batch_size
        q, k, v = _fold_cells(cells, in_dims[:3], (q, k, v))
        s_q, s_k, s_v = (_fold_scale(s, d, cells, q.shape[0] // cells)
                         for s, d in zip((s_q, s_k, s_v), in_dims[3:6]))
        out = _Int8Attention.apply(q, k, v, s_q, s_k, s_v, scale, softmax_fp32, pv)
        return out.unflatten(0, (cells, -1)), 0


def int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, s_q: torch.Tensor,
                   s_k: torch.Tensor, s_v: torch.Tensor, scale: float,
                   softmax_fp32: bool = True, pv: bool = False) -> torch.Tensor:
    """Attention with the score product on int8 codes (``TPU.INT8_ATTN``),
    the counterpart of the JAX ``int8_attention``.

    q, k, v: (B, H, N, D); s_q, s_k, s_v: the calibrated fp32 scales
    (``ops.int8.activation_scales_from_stats``); scale: the score scale.
    The forward quantizes q and k at their static scales and takes the
    exact int32 scores (``int8_attention_scores``), softmaxes them in fp32
    whatever ``softmax_fp32`` says, and takes P V in the compute dtype or,
    with ``pv`` (``TPU.INT8_ATTN_PV``), on int8 codes.  It is plain PyTorch
    on every device, as XLA math in the JAX package.  The backward is that
    of the plain attention on the saved q, k, v, honouring ``softmax_fp32``;
    on the card it launches the flash backward (``flash_attention_fwd`` for
    o and lse, then ``flash_attention_bwd_dq`` and ``_dkv``), which keeps
    an fp32 softmax, so ``softmax_fp32=False`` raises there
    (``check_softmax_fp32``)."""
    check_softmax_fp32(q.device.type, softmax_fp32)
    _check_operands(q, k, v, None)
    return _Int8Attention.apply(q, k, v, s_q, s_k, s_v, float(scale), bool(softmax_fp32),
                                bool(pv))


def takes_fused(use_fused: Optional[bool], bias: Optional[torch.Tensor], n: int) -> bool:
    """The JAX dispatcher's rule for the fused pair: asked for (``None`` is
    off), no bias, and N <= 1024."""
    return bool(use_fused) and bias is None and n <= FUSED_MAX_SEQ


def check_softmax_fp32(device_type: str, softmax_fp32: bool) -> None:
    """The card's attention kernels keep the softmax in fp32; a bf16 softmax
    (``TPU.BF16_SOFTMAX``, ``softmax_fp32=False``) exists only on the JAX
    package's XLA path, so the card refuses it rather than compute other
    numbers.  The CPU honours the flag."""
    if device_type == "cuda" and not softmax_fp32:
        raise NotImplementedError(
            "softmax_fp32=False (TPU.BF16_SOFTMAX) is not supported on the card: the "
            "attention kernels keep an fp32 softmax; unset TPU.BF16_SOFTMAX"
        )


_CARD_ROUTE = contextvars.ContextVar("card_route", default=False)


@contextlib.contextmanager
def card_route():
    """Inside the block ``multi_head_attention`` takes the card's route for
    CPU tensors too: ``flash_attention`` (its ops' plain versions), forward
    and backward, in place of the reference that torch differentiates.
    It is the one way to trace the card's program on the CPU: every
    ``engine.serving.export_classifier`` traces under it (the graph names
    K1's op on either device), and the model summary counts the card's
    products with it (the backward kernels recompute the scores: 7 products
    where autograd of the reference computes 4)."""
    token = _CARD_ROUTE.set(True)
    try:
        yield
    finally:
        _CARD_ROUTE.reset(token)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softmax_fp32: bool = True,
    batch_chunk: int = 0,
    use_fused: Optional[bool] = None,
) -> torch.Tensor:
    """Attention over (B, H, N, D) operands with an optional (H, N, N) bias.

    ``use_fused`` with no bias and N <= 1024 goes to ``fused_short_attention``
    (the kernels on the card, their plain versions on the CPU; the softmax is
    fp32 there whatever ``softmax_fp32`` says, as in the JAX package).
    Otherwise CUDA tensors go to ``flash_attention``, forward and backward,
    and ``softmax_fp32=False`` raises (``check_softmax_fp32``); CPU tensors
    take ``attention_reference``, which torch differentiates, and
    ``batch_chunk > 0`` computes it in batch slices of that size, as the JAX
    package does when there is no bias and the batch divides evenly.
    Inside ``card_route()`` CPU tensors take the card's route too.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if takes_fused(use_fused, bias, q.shape[-2]):
        return fused_short_attention(q, k, v, scale)
    on_card = q.device.type == "cuda" or _CARD_ROUTE.get()
    check_softmax_fp32("cuda" if on_card else q.device.type, softmax_fp32)
    if on_card:
        return flash_attention(q, k, v, bias, scale)
    b = q.shape[0]
    if batch_chunk and bias is None and b > batch_chunk and b % batch_chunk == 0:
        return torch.cat(
            [
                attention_reference(qc, kc, vc, None, scale, softmax_fp32)
                for qc, kc, vc in zip(
                    q.split(batch_chunk), k.split(batch_chunk), v.split(batch_chunk)
                )
            ]
        )
    return attention_reference(q, k, v, bias, scale, softmax_fp32)
